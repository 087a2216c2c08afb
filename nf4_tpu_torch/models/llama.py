"""Llama over packed 4-bit weights (single device): inference and the
fine-tuning forward.

The counterpart of the JAX package's ``models/llama.py``: RMSNorm, rotary
embeddings, GQA attention over a KV cache, a gated MLP, and the fields of
the Llama-family variants: fused q/k/v biases (Qwen2), per-head q/k
RMSNorm (Qwen3), RoPE scaling (linear, llama3, longrope), GeLU MLPs,
``(1 + w)`` RMSNorm and scaled embeddings (Gemma), a sliding window
(Mistral); Gemma-2/3's four-norm blocks, attention and final softcaps,
alternating local/global layers (a host window per layer) and the local
layers' own RoPE; and the mixture-of-experts MLP (Mixtral, Qwen3-MoE),
every token through every expert in expert order, weighted by its routing
weights.  Every projection goes through one call site, :func:`_matmul`:
the fused 4-bit matmul for :class:`PackedNF4` weights, the int8 matmul for
weights recoded by :func:`recode_params_int8`, a plain product for dense
weights (``quantize=False``).  With ``kv_quant`` the KV cache is int8 with
per-slot absmax scales.  :func:`train_forward` is the cache-free,
differentiable forward of QLoRA fine-tuning: LoRA deltas
(``train.lora``) on the adapted projections, gradients to the adapters
through the packed weights' backward.

Where the dispatch differs from the JAX package's: there a layer's window
is a traced value of the layer scan, which keeps every windowed
alternating-layer model off the flash kernel; here it is a host int, so
Gemma-3's long prefills reach kernel C (D = 256, windowed on its local
layers), with the same results within the attention tolerance.  Gemma-2
stays on the plain paths, as there: kernel C takes no softcap.

PyTorch idiom in place of the JAX one: layers are a Python list iterated by
a loop (the JAX package scans stacked layers), and :func:`forward` writes
the new keys and values into the cache IN PLACE (the JAX package returns a
new cache); it returns the same cache object for a like-for-like signature.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..nf4.format import PackedNF4, QDense, pack_codes_for_tpu, quantize_for_tpu
from ..ops.attention import _softcap, attention
from ..ops.int8_serve import PackedInt8, int8_matmul, recode_int8_weight
from ..ops.matmul import _ieee_fp32, nf4_matmul
from ..utils.device import resolve_device

__all__ = [
    "LlamaConfig",
    "LayerParams",
    "LlamaParams",
    "KVCache",
    "init_kv_cache",
    "rms_norm",
    "rope_tables",
    "apply_rope",
    "split_fused",
    "forward",
    "train_forward",
    "prefill",
    "prefill_chunked",
    "decode_step",
    "recode_params_int8",
    "fuse_rows",
    "quantize_layer",
    "quantize_dense_params",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's configuration fields, so its configuration dicts
    load unchanged; :func:`forward` raises for the one this port does not
    serve yet (see :func:`check_supported`)."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 64
    rope_theta: float = 10000.0
    rope_scaling: Optional[tuple] = None
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 2048
    sliding_window: Optional[int] = None
    attn_bias: bool = False
    qk_norm: bool = False
    activation: str = "silu"
    rmsnorm_one_plus: bool = False
    scale_embeddings: bool = False
    quantize_lm_head: bool = False
    dtype: torch.dtype = torch.bfloat16
    quantize: bool = True
    quant_type: str = "nf4"
    kv_quant: bool = False
    tp_shards: int = 1
    num_experts: int = 1
    experts_per_token: int = 2
    moe_norm_topk: bool = True
    moe_shard: str = "tensor"
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sliding_window_pattern: int = 1
    rope_local_theta: Optional[float] = None

    @property
    def attn_scale(self) -> float:
        base = self.query_pre_attn_scalar if self.query_pre_attn_scalar is not None else self.head_dim
        return float(base) ** -0.5

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# The MLP's gate activations, on fp32 (``activation``).
_ACTIVATIONS = {
    "silu": F.silu,
    "gelu_tanh": lambda t: F.gelu(t, approximate="tanh"),
    "gelu": F.gelu,
}


def _raise_unported(missing: dict, what: str = "") -> None:
    bad = [name for name, on in missing.items() if on]
    if bad:
        raise NotImplementedError(f"not ported yet: {what}{', '.join(bad)}")


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for configuration features this port does not serve yet."""
    _raise_unported({"tp_shards > 1": cfg.tp_shards > 1})
    if cfg.activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {cfg.activation!r}; {'|'.join(_ACTIVATIONS)}")
    if cfg.rope_scaling is not None and cfg.rope_scaling[0] not in ("linear", "llama3", "longrope"):
        raise ValueError(f"unknown rope_scaling kind {cfg.rope_scaling[0]!r}; llama3|linear|longrope")


def check_trainable(cfg: LlamaConfig) -> None:
    """Raise for the configurations :func:`train_forward` does not train
    yet (they serve)."""
    check_supported(cfg)
    _raise_unported({
        "quantize=False (dense projections)": not cfg.quantize,
        "num_experts > 1": cfg.num_experts > 1,
        "attn_logit_softcapping": cfg.attn_logit_softcapping is not None,
        "final_logit_softcapping": cfg.final_logit_softcapping is not None,
        "sliding_window_pattern > 1": cfg.sliding_window_pattern > 1,
        "rope_local_theta": cfg.rope_local_theta is not None,
    }, "training with ")


# A packed weight, or a dense cfg.dtype tensor [out, in] (quantize=False).
Weight = Union[PackedNF4, PackedInt8, torch.Tensor]


@dataclasses.dataclass
class LayerParams:
    """One decoder layer.  q+k+v and gate+up are fused, one matmul each.
    An MoE layer's ``w_gateup`` and ``w_down`` are expert-stacked: one
    weight whose tensors gain a leading ``[E]`` axis (packed ``[E, n_pad/2,
    m_pad]``, int8 values ``[E, n_pad, m_pad]``, dense ``[E, out, in]``);
    its ``shape`` stays one expert's."""

    wqkv: Weight  # [q_dim + 2*kv_dim, hidden]
    wo: Weight  # [hidden, q_dim]
    w_gateup: Weight  # [2*intermediate, hidden]
    w_down: Weight  # [hidden, intermediate]
    input_norm: torch.Tensor  # fp32 [hidden]
    post_attn_norm: torch.Tensor  # fp32 [hidden], the MLP's input norm
    qkv_bias: Optional[torch.Tensor] = None  # fp32 [q_dim + 2*kv_dim] (cfg.attn_bias)
    q_norm: Optional[torch.Tensor] = None  # fp32 [head_dim] (cfg.qk_norm)
    k_norm: Optional[torch.Tensor] = None
    router: Optional[torch.Tensor] = None  # fp32 [E, hidden] (cfg.num_experts > 1)
    # Gemma-2/3's norms of the attention and MLP outputs, fp32 [hidden],
    # applied before each residual add.
    post_attn_out_norm: Optional[torch.Tensor] = None
    post_ffw_norm: Optional[torch.Tensor] = None


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor  # [vocab, hidden], cfg.dtype
    layers: List[LayerParams]
    final_norm: torch.Tensor  # fp32 [hidden]
    lm_head: Union[Weight, torch.Tensor]  # dense [vocab, hidden] cfg.dtype, or packed


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, KV, S_max, D] (cfg.dtype, or int8 with kv_quant)
    v: torch.Tensor
    # fp32 [L, B, KV, S_max] per-slot absmax scales of the int8 cache
    # (cfg.kv_quant); None for the bf16 cache.
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    def planes(self) -> dict:
        """The cache's tensors by field name (the scales only when int8)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self) if getattr(self, f.name) is not None}

    def layer(self, i: int) -> "KVCache":
        """Layer ``i``'s views of every plane (writes go to this cache)."""
        return KVCache(**{name: t[i] for name, t in self.planes().items()})

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.planes().values())


def init_kv_cache(cfg: LlamaConfig, batch_size: int, device=None) -> KVCache:
    """A zeroed cache on ``device`` (default ``cuda``): cfg.dtype (bf16), or
    int8 with fp32 scale planes under ``cfg.kv_quant``."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
    if cfg.kv_quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
    )


class _HalfLogits(torch.autograd.Function):
    """``x @ w.T`` of bf16/fp16 CUDA operands with an fp32 result, and its
    gradient in ``x`` (``w``, a dense leaf of the frozen base, gets none)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        # g rounds to the operand type (the half-precision product's input),
        # the sums stay fp32 until the one rounding to x's type.
        return torch.mm(g.to(w.dtype), w, out_dtype=torch.float32).to(w.dtype), None


def _dense_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with an fp32 result (no bf16 rounding of the sums: greedy
    argmax over a large vocabulary needs the fp32 values); differentiable
    in ``x``."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32:
        y = x2 @ w.t()
    elif x2.is_cuda:
        y = _HalfLogits.apply(x2, w)
    else:
        y = x2.float() @ w.float().t()
    return y.reshape(*x.shape[:-1], w.shape[0])


def _matmul(x: torch.Tensor, w: Weight, out_dtype=None, decode: bool = False) -> torch.Tensor:
    """The one call site of every projection.  ``x`` [B, S, in] with S > 1
    holds prompt tokens, which take the prefill kernels whatever B * S (a
    row's sum then does not follow what shares its call), unless
    ``decode`` says they are decode rows (a speculative verify window):
    those route by count, as one decode row per sequence does (up to 16
    rows the decode kernel, whose rows do not share their sums).  A dense
    weight: the JAX package's ``jnp.dot`` with fp32 accumulation and
    output (full fp32 products), then cast."""
    out_dtype = out_dtype or x.dtype
    prompt = x.dim() == 3 and x.shape[1] > 1 and not decode
    if isinstance(w, PackedInt8):
        return int8_matmul(x, w, out_dtype=out_dtype, prefill=prompt)
    if isinstance(w, PackedNF4):
        return nf4_matmul(x, w, out_dtype=out_dtype, prefill=prompt)
    with _ieee_fp32():
        return _dense_logits(x, w.to(x.dtype)).to(out_dtype)


def _experts(w: Weight) -> list:
    """An expert-stacked weight's per-expert weights: views of its tensors
    (no copy, so the pointers a CUDA graph captures stay put)."""
    if isinstance(w, PackedNF4):
        return [dataclasses.replace(w, packed=p, scales=sc) for p, sc in zip(w.packed.unbind(0), w.scales.unbind(0))]
    if isinstance(w, PackedInt8):
        return [dataclasses.replace(w, values=v, scales=sc) for v, sc in zip(w.values.unbind(0), w.scales.unbind(0))]
    return list(w.unbind(0))


def recode_params_int8(params: LlamaParams) -> LlamaParams:
    """Every packed 4-bit projection recoded to int8 (see
    :mod:`~nf4_tpu_torch.ops.int8_serve`), the experts' too: twice the
    weight bytes, values on the 4-bit grid up to the int8 rounding of the
    codebook.  A dense bf16 lm_head stays as it is."""

    def recode(w):
        return recode_int8_weight(w) if isinstance(w, PackedNF4) else w

    layers = [
        dataclasses.replace(lp, **{n: recode(getattr(lp, n)) for n in ("wqkv", "wo", "w_gateup", "w_down")})
        for lp in params.layers
    ]
    return dataclasses.replace(params, layers=layers, lm_head=recode(params.lm_head))


# ---------------------------------------------------------------------------
# Parameter construction from dense or pre-quantized (bnb) host weights


def _host(w) -> torch.Tensor:
    """A dense host weight (torch tensor or numpy array) as a torch tensor."""
    return w.detach() if isinstance(w, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(w))


def fuse_rows(ws, groups: int = 1):
    """Fuse [m_i, n] weights along the out dim, ``[w0; w1; ...]``: all
    dense (torch tensors or numpy arrays) or all :class:`QDense` (codes and
    per-block scales fused with the same rows, so separately quantized
    projections fuse exactly).  Mixing the two in one group raises: a dense
    minority quantized here would hide a checkpoint inconsistency.
    ``groups > 1`` (the JAX package's per-shard interleave for tensor
    parallelism) is not ported yet."""
    if groups != 1:
        raise NotImplementedError("not ported yet: fuse_rows groups > 1 (tensor-parallel interleave)")
    n_q = sum(isinstance(w, QDense) for w in ws)
    if n_q:
        if n_q != len(ws):
            raise ValueError("cannot fuse pre-quantized and dense weights in one group")
        qt = {w.quant_type for w in ws}
        if len(qt) > 1:
            raise ValueError(f"mixed quant_types in fused group: {qt}")
        return QDense(np.concatenate([w.codes for w in ws]), np.concatenate([w.scales for w in ws]),
                      ws[0].quant_type)
    return torch.cat([_host(w) for w in ws])


def _linear(w, cfg: LlamaConfig, device) -> Weight:
    """One projection on ``device``: a :class:`QDense` repacked (its codes
    untouched), a dense weight quantized (``cfg.quantize``) or cast to
    ``cfg.dtype``."""
    if isinstance(w, QDense):
        if not cfg.quantize:
            raise ValueError("pre-quantized (bnb) weights require cfg.quantize=True")
        if w.quant_type != cfg.quant_type:
            raise ValueError(f"checkpoint quant_type {w.quant_type!r} != config quant_type {cfg.quant_type!r}")
        return pack_codes_for_tpu(w.codes, w.scales, dtype=cfg.dtype, quant_type=w.quant_type, device=device)
    if cfg.quantize:
        return quantize_for_tpu(w, dtype=cfg.dtype, quant_type=cfg.quant_type, device=device)
    return _host(w).to(device, cfg.dtype)


def _lm_head(w, cfg: LlamaConfig, device) -> Weight:
    """The lm_head: a checkpoint's quantized one kept packed (bnb quantizes
    it unless it is in ``llm_int8_skip_modules``), a dense one quantized
    with ``quantize_lm_head``, else ``cfg.dtype``."""
    if isinstance(w, QDense):
        return pack_codes_for_tpu(w.codes, w.scales, dtype=cfg.dtype, quant_type=w.quant_type, device=device)
    if cfg.quantize_lm_head:
        return quantize_for_tpu(w, dtype=cfg.dtype, quant_type=cfg.quant_type, device=device)
    return _host(w).to(device, cfg.dtype)


def _stack(ws: list) -> Weight:
    """Per-expert weights stacked on a leading [E] axis (one weight)."""
    if isinstance(ws[0], PackedNF4):
        return dataclasses.replace(ws[0], packed=torch.stack([w.packed for w in ws]),
                                   scales=torch.stack([w.scales for w in ws]))
    return torch.stack(ws)


def quantize_layer(lw: dict, cfg: LlamaConfig, device=None) -> LayerParams:
    """ONE layer's dense (or bnb :class:`QDense`) weight dict as a
    :class:`LayerParams` on ``device`` (default ``cuda``): the streaming
    loader's unit, so a layer's dense tensors can be freed as soon as this
    returns.  Keys: ``wq wk wv wo`` and ``w_gate w_up w_down`` (or, with
    experts, ``expert{e}.w_gate`` etc. and ``router``), ``input_norm``,
    ``post_attn_norm`` and, where the model has them, ``bq bk bv``,
    ``q_norm k_norm``, ``post_attn_out_norm post_ffw_norm``.  An MoE
    layer's experts are stacked in expert order; a quantized router is
    dequantized exactly to fp32."""
    check_supported(cfg)
    dev = resolve_device(device)

    def vector(name):
        return _host(lw[name]).to(dev, torch.float32) if name in lw else None

    qkv_bias = None
    if cfg.attn_bias:
        qkv_bias = fuse_rows([lw["bq"], lw["bk"], lw["bv"]]).to(dev, torch.float32)
    router = None
    if cfg.num_experts > 1:
        experts = range(cfg.num_experts)
        gu = _stack([_linear(fuse_rows([lw[f"expert{e}.w_gate"], lw[f"expert{e}.w_up"]]), cfg, dev) for e in experts])
        dn = _stack([_linear(lw[f"expert{e}.w_down"], cfg, dev) for e in experts])
        router = lw["router"]
        router = _host(router.to_dense() if isinstance(router, QDense) else router).to(dev, torch.float32)
    else:
        gu = _linear(fuse_rows([lw["w_gate"], lw["w_up"]]), cfg, dev)
        dn = _linear(lw["w_down"], cfg, dev)
    return LayerParams(
        wqkv=_linear(fuse_rows([lw["wq"], lw["wk"], lw["wv"]]), cfg, dev),
        wo=_linear(lw["wo"], cfg, dev),
        w_gateup=gu,
        w_down=dn,
        input_norm=vector("input_norm"),
        post_attn_norm=vector("post_attn_norm"),
        qkv_bias=qkv_bias,
        router=router,
        post_attn_out_norm=vector("post_attn_out_norm"),
        post_ffw_norm=vector("post_ffw_norm"),
        q_norm=vector("q_norm"),
        k_norm=vector("k_norm"),
    )


def quantize_dense_params(dense_layers: list, cfg: LlamaConfig, embed, final_norm, lm_head,
                          device=None) -> LlamaParams:
    """Params on ``device`` (default ``cuda``) from host dense per-layer
    weight dicts (:func:`quantize_layer`'s keys), the embedding, the final
    norm and the lm_head."""
    dev = resolve_device(device)
    return LlamaParams(
        embed=_host(embed).to(dev, cfg.dtype),
        layers=[quantize_layer(lw, cfg, dev) for lw in dense_layers],
        final_norm=_host(final_norm).to(dev, torch.float32),
        lm_head=_lm_head(lm_head, cfg, dev),
    )


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, one_plus: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis in fp32; ``one_plus`` scales by ``1 +
    weight`` (Gemma)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + weight if one_plus else weight)).to(x.dtype)


def _scaled_inv_freq(cfg: LlamaConfig, device) -> torch.Tensor:
    """fp32 [head_dim / 2] inverse wavelengths, with HF's ``rope_scaling``:
    "linear" divides them all by the factor; "llama3" (Llama-3.1/3.2)
    divides the low frequencies by ``factor``, keeps the high ones and
    interpolates between (HF's ``_compute_llama3_parameters``); "longrope"
    (Phi-3) divides by the long or the short per-frequency factors."""
    half = cfg.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    if cfg.rope_scaling is None:
        return inv_freq
    kind = cfg.rope_scaling[0]
    if kind == "linear":
        return inv_freq / cfg.rope_scaling[1]
    if kind == "llama3":
        _, factor, lo_f, hi_f, orig = cfg.rope_scaling
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (orig / wavelen - lo_f) / (hi_f - lo_f)
        mid = (1.0 - smooth) * scaled + smooth * inv_freq
        return torch.where(wavelen < orig / hi_f, inv_freq, torch.where(wavelen > orig / lo_f, scaled, mid))
    _, short, long, orig = cfg.rope_scaling[:4]  # longrope
    return inv_freq / _longrope_factors(tuple(long if cfg.max_seq_len > orig else short), device)


@functools.lru_cache(maxsize=None)
def _longrope_factors(factors: tuple, device: torch.device) -> torch.Tensor:
    """Longrope's per-frequency factors on ``device``, copied there at
    their first use: a host-to-device copy cannot run inside a CUDA graph
    capture (the Engine's warm-up step is the first use)."""
    return torch.tensor(factors, dtype=torch.float32, device=device)


def _rope_attn_scale(cfg: LlamaConfig) -> float:
    """Longrope's multiplier of cos and sin: the checkpoint's attention
    factor (tuple entry 5) when given, else sqrt(1 + ln(scale) / ln(orig))
    from ``max_seq_len``; 1.0 for every other scheme."""
    if cfg.rope_scaling is None or cfg.rope_scaling[0] != "longrope":
        return 1.0
    if len(cfg.rope_scaling) > 4:
        return float(cfg.rope_scaling[4])
    orig = cfg.rope_scaling[3]
    scale = cfg.max_seq_len / orig
    return 1.0 if scale <= 1.0 else math.sqrt(1.0 + math.log(scale) / math.log(orig))


def _layer_is_local(cfg: LlamaConfig, i: int) -> bool:
    """Layer ``i`` is a local (windowed) layer of an alternating pattern:
    every ``sliding_window_pattern``-th layer is global."""
    pat = cfg.sliding_window_pattern
    return pat > 1 and i % pat != pat - 1


def _layer_window(cfg: LlamaConfig, i: int) -> Optional[int]:
    """Layer ``i``'s sliding window, a host int: ``sliding_window`` on every
    layer, or under an alternating pattern on its local layers only (a
    global layer takes none, the visibility of the JAX package's window of
    ``max_seq_len + 1``)."""
    if cfg.sliding_window_pattern <= 1 or _layer_is_local(cfg, i):
        return cfg.sliding_window
    return None


def local_rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """Gemma-3's local-layer cos/sin: ``rope_local_theta``, unscaled
    (global layers keep ``rope_theta`` and ``rope_scaling``); None without
    a local theta."""
    if cfg.rope_local_theta is None:
        return None
    return rope_tables(dataclasses.replace(cfg, rope_theta=cfg.rope_local_theta, rope_scaling=None), positions)


def _layer_tables(cfg: LlamaConfig, positions: torch.Tensor):
    """Each layer's (cos, sin): the global tables, or the local ones on
    Gemma-3's local layers (each table computed once)."""
    tables = rope_tables(cfg, positions)
    local = local_rope_tables(cfg, positions)
    return [local if local is not None and _layer_is_local(cfg, i) else tables for i in range(cfg.num_layers)]


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., D] for the HF 'rotate_half' convention."""
    angles = positions.float()[..., None] * _scaled_inv_freq(cfg, positions.device)
    emb = torch.cat([angles, angles], dim=-1)
    m = _rope_attn_scale(cfg)
    if m != 1.0:
        return torch.cos(emb) * m, torch.sin(emb) * m
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [B, S, D] (broadcast over heads)."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, None] + rotated * sin[:, None]).to(x.dtype)


def split_fused(y: torch.Tensor, sizes) -> List[torch.Tensor]:
    """Split the output features of a fused matmul: y [..., sum(sizes)]."""
    return list(torch.split(y, list(sizes), dim=-1))


# The dividend of _quantize_kv's true division: a CPU scalar, which a CUDA
# division reads as a constant (no fill kernel).
_KV_LEVELS = torch.tensor(127.0)


def _quantize_kv(t: torch.Tensor):
    """[B, KV, S, D] -> (int8 values, fp32 per-slot absmax scales [B, KV, S]):
    ``round(t * (127 / s))`` with round-half-even, s the absmax (1 where the
    absmax is 0).  Any leading shape: K and V go through it stacked.  Each
    eager op is a launch, and the host's launches bound the int8 prefill."""
    absmax = torch.linalg.vector_norm(t, float("inf"), dim=-1, dtype=torch.float32)  # max |t|, exact
    s = torch.where(absmax > 0, absmax, 1.0)
    # A true division (``127.0 / s`` on a tensor is reciprocal-then-multiply);
    # t times an fp32 tensor is computed in fp32.
    q8 = torch.round(t * torch.div(_KV_LEVELS, s)[..., None]).to(torch.int8)
    return q8, absmax


def _cache_index(positions: torch.Tensor):
    """The (row, slot) index of every position [B, S] a forward writes,
    built once and shared by every layer's :func:`_write_kv`."""
    b, s = positions.shape
    return torch.arange(b, device=positions.device)[:, None].expand(b, s), positions.long()


def _write_kv(layer_cache: torch.Tensor, new: torch.Tensor, index) -> None:
    """In place: layer_cache [B, KV, T, ...][b, :, positions[b, s]] =
    new[b, :, s] (the K/V planes and the int8 scale planes alike), with
    ``index`` the positions' :func:`_cache_index`.  Every position must be
    < T."""
    layer_cache.transpose(1, 2)[index] = new.transpose(1, 2).to(layer_cache.dtype)


def _lora_delta(x: torch.Tensor, ab) -> Optional[torch.Tensor]:
    """One projection's low-rank update ``(x @ A^T) @ B^T * scaling`` in
    ``x``'s dtype (the QLoRA convention), or None when ``ab`` (a
    ``train.lora.LoraAB``, duck-typed) is None."""
    if ab is None:
        return None
    return (x @ ab.a.to(x.dtype).t()) @ ab.b.to(x.dtype).t() * ab.scaling


def _add_delta(y: torch.Tensor, delta: Optional[torch.Tensor]) -> torch.Tensor:
    return y if delta is None else y + delta.to(y.dtype)


def _post(cfg: LlamaConfig, t: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Gemma-2/3's RMSNorm of a sublayer's fp32 output before its residual
    add; ``t`` itself without the norm."""
    return t if w is None else rms_norm(t, w, cfg.rms_norm_eps, cfg.rmsnorm_one_plus)


def _layer_forward(cfg, x, lp: LayerParams, layer_cache: Optional[KVCache], positions, seq_lens, cos, sin,
                   kv_len=None, ll=None, train: bool = False, segment_ids=None, cache_index=None, window=None,
                   decode: bool = False):
    """One decoder layer; x [B, S, hidden]; writes this call's K/V into the
    layer's cache views in place at ``cache_index`` (the positions'
    :func:`_cache_index`).  ``window`` is the layer's sliding window
    (:func:`_layer_window`); ``decode`` marks the rows as decode rows (see
    :func:`forward`).  ``ll`` is the layer's LoRA adapters
    (``train.lora.LoraLayer``) or None; ``train=True`` uses no cache
    (attention over this call's own K/V, differentiable paths only, with
    ``segment_ids`` for packed rows)."""
    b, s, _ = x.shape

    def delta(t, name):
        return None if ll is None else _lora_delta(t, getattr(ll, name))

    one_plus = cfg.rmsnorm_one_plus
    attn_in = rms_norm(x, lp.input_norm, cfg.rms_norm_eps, one_plus)
    qkv = _add_delta(_matmul(attn_in, lp.wqkv, decode=decode), delta(attn_in, "qkv"))  # one kernel for q+k+v
    if lp.qkv_bias is not None:
        qkv = qkv + lp.qkv_bias.to(qkv.dtype)
    qk, v = split_fused(qkv, (cfg.q_dim + cfg.kv_dim, cfg.kv_dim))
    qk = qk.reshape(b, s, cfg.num_heads + cfg.num_kv_heads, cfg.head_dim)
    if lp.q_norm is not None:  # per-head RMSNorm of q and k before RoPE (Qwen3), one pass
        w = torch.cat((lp.q_norm.expand(cfg.num_heads, -1), lp.k_norm.expand(cfg.num_kv_heads, -1)))
        qk = rms_norm(qk, w, cfg.rms_norm_eps, one_plus)
    # RoPE of the q and k heads in one pass.
    qk = apply_rope(qk.transpose(1, 2), cos, sin)
    q, k = qk.split((cfg.num_heads, cfg.num_kv_heads), dim=1)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    if train:
        attn = attention(
            q, k, v, positions, seq_lens,
            scale=cfg.attn_scale,
            sliding_window=window,
            differentiable=True,
            segment_ids=segment_ids,
        )
    else:
        if cfg.kv_quant:
            (k, v), kv_scale = _quantize_kv(torch.stack((k, v)))
            _write_kv(layer_cache.k_scale, kv_scale[0], cache_index)
            _write_kv(layer_cache.v_scale, kv_scale[1], cache_index)
        _write_kv(layer_cache.k, k, cache_index)
        _write_kv(layer_cache.v, v, cache_index)
        attn = attention(
            q, layer_cache.k, layer_cache.v, positions, seq_lens,
            scale=cfg.attn_scale,
            sliding_window=window,
            k_scale=layer_cache.k_scale,
            v_scale=layer_cache.v_scale,
            kv_len=kv_len,
            logit_softcap=cfg.attn_logit_softcapping,
            decode=decode,
        )
    attn = attn.transpose(1, 2).reshape(b, s, cfg.q_dim)
    o_proj = _add_delta(_matmul(attn, lp.wo, out_dtype=torch.float32, decode=decode), delta(attn, "o"))
    x = x + _post(cfg, o_proj, lp.post_attn_out_norm).to(x.dtype)

    mlp_in = rms_norm(x, lp.post_attn_norm, cfg.rms_norm_eps, one_plus)
    if lp.router is not None:
        return x + _post(cfg, _moe_mlp(cfg, mlp_in, lp, decode), lp.post_ffw_norm).to(x.dtype)
    gateup = _add_delta(_matmul(mlp_in, lp.w_gateup, decode=decode), delta(mlp_in, "gateup"))  # one kernel for gate+up
    h = _gated(cfg, gateup)
    down = _add_delta(_matmul(h, lp.w_down, out_dtype=torch.float32, decode=decode), delta(h, "down"))
    return x + _post(cfg, down, lp.post_ffw_norm).to(x.dtype)


def _gated(cfg: LlamaConfig, gateup: torch.Tensor) -> torch.Tensor:
    """act(gate) * up of a fused gate+up output, the activation in fp32."""
    gate, up = split_fused(gateup, (cfg.intermediate_size, cfg.intermediate_size))
    return _ACTIVATIONS[cfg.activation](gate.float()).to(up.dtype) * up


def _moe_mlp(cfg: LlamaConfig, mlp_in: torch.Tensor, lp: LayerParams, decode: bool = False) -> torch.Tensor:
    """The mixture-of-experts MLP (the JAX package's ``_moe_mlp``): fp32
    router logits (full fp32 products: TF32 could flip a route), the top
    ``experts_per_token`` experts of each token, ties to the lower index as
    ``lax.top_k`` breaks them (a stable descending sort), their weights
    renormalized (``moe_norm_topk``) or the full softmax's; then every token
    through every expert in expert order, each expert's fp32 output
    weighted by the token's weight for it (0 where not chosen) into an fp32
    sum.  No shape depends on the routes, so decode chunks capture.
    ``decode``: the rows are decode rows (see :func:`forward`)."""
    with _ieee_fp32():
        logits = mlp_in.float() @ lp.router.float().t()  # [B, S, E]
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_v, top_i = order.values[..., : cfg.experts_per_token], order.indices[..., : cfg.experts_per_token]
    if cfg.moe_norm_topk:
        weights = torch.softmax(top_v, dim=-1)
    else:
        weights = torch.softmax(logits, dim=-1).gather(-1, top_i)
    per_expert = torch.zeros_like(logits).scatter(-1, top_i, weights)  # [B, S, E], the chosen experts' weights
    acc = torch.zeros(mlp_in.shape, dtype=torch.float32, device=mlp_in.device)
    for e, (gu, dn) in enumerate(zip(_experts(lp.w_gateup), _experts(lp.w_down))):
        out = _matmul(_gated(cfg, _matmul(mlp_in, gu, decode=decode)), dn, out_dtype=torch.float32, decode=decode)
        acc = acc + per_expert[..., e : e + 1] * out
    return acc


def forward(
    params: LlamaParams,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int
    cache: KVCache,
    positions: torch.Tensor,  # [B, S] absolute positions of `tokens`, < cache length
    seq_lens: torch.Tensor,  # [B] visible length AFTER this step
    last_only: bool = False,
    kv_len: Optional[int] = None,
    lora=None,
    decode: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Embed, run every layer, return fp32 logits ([B, S, V], or [B, V] for
    each row's last valid token with ``last_only``) and the cache, written
    in place.  ``kv_len`` (host int) bounds the slots any query can see.
    ``lora`` is an optional unmerged ``train.lora.LoraParams``.

    ``decode=True`` marks the S positions of each row as decode rows, not a
    prompt: a speculative verify window of S <= 16 consecutive positions
    on a live cache.  Their projections route by row count as decode's do
    (``_matmul``) and their attention is :func:`~nf4_tpu_torch.ops.
    attention.decode_attention`, so a row's logits follow its own tokens
    and cache only, as a decode step's do.  Prompts pass no marker."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    tables = _layer_tables(cfg, positions)
    index = _cache_index(positions)
    for i, lp in enumerate(params.layers):
        ll = None if lora is None else lora.layers[i]
        x = _layer_forward(cfg, x, lp, cache.layer(i), positions, seq_lens, *tables[i], kv_len, ll=ll,
                           cache_index=index, window=_layer_window(cfg, i), decode=decode)
    if last_only:
        last_idx = torch.clamp(seq_lens - 1 - positions[:, 0], 0, s - 1).long()
        x = x[torch.arange(b, device=x.device), last_idx]
    return _logits(params, cfg, x, decode), cache


def _embed(params: LlamaParams, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embedding rows; scaled by sqrt(hidden) in fp32 with
    ``scale_embeddings`` (Gemma)."""
    x = params.embed[tokens.long()]
    if cfg.scale_embeddings:
        x = (x.float() * cfg.hidden_size**0.5).to(x.dtype)
    return x


def _logits(params: LlamaParams, cfg: LlamaConfig, x: torch.Tensor, decode: bool = False) -> torch.Tensor:
    """fp32 logits of the final norm of ``x``, softcapped with
    ``final_logit_softcapping`` (Gemma-2); ``decode`` as in :func:`forward`."""
    x = rms_norm(x, params.final_norm, cfg.rms_norm_eps, cfg.rmsnorm_one_plus)
    if isinstance(params.lm_head, (PackedNF4, PackedInt8)):
        logits = _matmul(x, params.lm_head, out_dtype=torch.float32, decode=decode)
    else:
        logits = _dense_logits(x, params.lm_head.to(x.dtype))
    return _softcap(logits, cfg.final_logit_softcapping)


def train_forward(
    params: LlamaParams,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int
    lora=None,
    remat: bool = False,
    positions: Optional[torch.Tensor] = None,  # [B, S] segment-relative (packed rows); default arange
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] example id per slot, -1 = padding
) -> torch.Tensor:
    """Full-sequence fp32 logits [B, S, V] for fine-tuning.

    Differs from :func:`prefill` where training needs it: no KV cache (each
    layer attends over its own fresh K/V), attention on the differentiable
    plain paths, and ``remat=True`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant), so the backward recomputes
    the layer's activations instead of keeping all ``L`` layers' of them.
    Gradients flow to ``lora`` (and any dense leaf that requires one); the
    packed weights are frozen.  For packed rows (``train.data.pack_sft``)
    ``segment_ids`` makes attention block-diagonal and ``positions`` carries
    the segment-relative rotary phases; the causal mask runs on slot
    indices.  Gemma-2/3, MoE and dense-projection configurations are not
    trained yet (:func:`check_trainable`)."""
    check_trainable(cfg)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    slot_ids = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    seq_lens = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_tables(cfg, slot_ids if positions is None else positions)
    for i, lp in enumerate(params.layers):
        ll = None if lora is None else lora.layers[i]

        def layer(x, lp=lp, ll=ll):
            return _layer_forward(cfg, x, lp, None, slot_ids, seq_lens, cos, sin,
                                  ll=ll, train=True, segment_ids=segment_ids, window=cfg.sliding_window)

        x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    return _logits(params, cfg, x)


def prefill(params, cfg: LlamaConfig, tokens: torch.Tensor, cache: Optional[KVCache] = None):
    """Process full prompts [B, S] from position 0; returns (logits
    [B, S, V], cache).  Runs on the tokens' device."""
    b, s = tokens.shape
    if cache is None:
        cache = init_kv_cache(cfg, b, device=tokens.device)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    seq_lens = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return forward(params, cfg, tokens, cache, positions, seq_lens, kv_len=s)


def prefill_chunked(params, cfg: LlamaConfig, tokens: torch.Tensor, cache: Optional[KVCache] = None,
                    chunk: int = 2048):
    """Prefill full prompts [B, S] from position 0 in segments of ``chunk``
    tokens, each attending to the cache the earlier ones wrote (bounded
    activation memory); returns (last-token logits [B, V], cache)."""
    b, s = tokens.shape
    if cache is None:
        cache = init_kv_cache(cfg, b, device=tokens.device)
    logits = None
    for off in range(0, s, chunk):
        seg = tokens[:, off : off + chunk]
        width = seg.shape[1]
        positions = (off + torch.arange(width, dtype=torch.int32, device=tokens.device)).expand(b, width)
        seq_lens = torch.full((b,), off + width, dtype=torch.int32, device=tokens.device)
        logits, cache = forward(params, cfg, seg, cache, positions, seq_lens, last_only=True, kv_len=off + width)
    return logits, cache


def decode_step(params, cfg: LlamaConfig, token, cache: KVCache, positions, kv_len: Optional[int] = None):
    """One token per sequence: token [B], positions [B] (the slot being
    written).  Returns (logits [B, V], cache)."""
    logits, cache = forward(
        params, cfg, token[:, None], cache, positions[:, None], positions + 1, kv_len=kv_len
    )
    return logits[:, 0], cache
