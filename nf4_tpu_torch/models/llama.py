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
differentiable forward of QLoRA fine-tuning, for every family served:
LoRA deltas (``train.lora``) on the adapted projections, gradients to
the adapters through the packed weights' backward.  :func:`forward` also
takes a multi-LoRA bank with a per-row adapter id (:func:`_lora_delta`,
:func:`prepare_bank`).

Tensor parallelism (``parallel/tp.py``): each rank runs :func:`forward`
over its own slice of the params with the per-rank config
(``tp_local_config``: heads, KV heads and the MLP width divided by the
degree), and ``reduce_fn`` (a sum over the ranks) after each row-parallel
product (``wo``, ``w_down``, an MoE layer's expert sum), in fp32 before
the cast, as the JAX package applies its ``psum``; ``gather_fn`` turns the
rank's vocabulary slice of the logits into full rows.  Checkpoints packed
for ``tp_shards > 1`` (fused rows interleaved per shard, row-parallel K in
chunks) also serve and train on one device.  :func:`train_forward` takes
the same ``reduce_fn``, differentiable, and ``copy_fn`` on each
column-parallel product's input (``parallel.tp.train_hooks``).  Sequence
parallelism (``parallel/sp.py``): :func:`forward` with ``ring_axis`` runs
a rank's slice of a prompt, its attention around the ring.

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
from ..utils.env import collective_chunks

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
    "init_params",
    "lm_head",
    "prepare_bank",
    "LoraBank",
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
    # Runtime only (set by parallel.tp.tp_local_config on a rank, never
    # saved): in moe_shard="expert" mode the rank whose num_experts local
    # experts this config describes, so _moe_mlp offsets local expert ids
    # to global ones (the JAX package's ep_axis).
    ep_rank: Optional[int] = None
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

    @property
    def moe_groups(self) -> int:
        """The interleave and chunk count of the EXPERT weights: tp_shards in
        "tensor" mode, 1 in "expert" mode (each rank holds whole experts)."""
        if self.moe_shard not in ("tensor", "expert"):
            raise ValueError(f"moe_shard={self.moe_shard!r}; expected 'tensor' or 'expert'")
        return self.tp_shards if self.moe_shard == "tensor" else 1


# The MLP's gate activations, on fp32 (``activation``).
_ACTIVATIONS = {
    "silu": F.silu,
    "gelu_tanh": lambda t: F.gelu(t, approximate="tanh"),
    "gelu": F.gelu,
}


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for configuration values this port does not serve."""
    cfg.moe_groups  # raises for an unknown moe_shard
    if cfg.activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {cfg.activation!r}; {'|'.join(_ACTIVATIONS)}")
    if cfg.rope_scaling is not None and cfg.rope_scaling[0] not in ("linear", "llama3", "longrope"):
        raise ValueError(f"unknown rope_scaling kind {cfg.rope_scaling[0]!r}; llama3|linear|longrope")


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
    gradients in ``x`` and, where ``w`` is a trained dense leaf, in ``w``."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        # g rounds to the operand type (the half-precision product's input),
        # the sums stay fp32 until the one rounding to the operand's type.
        g = g.to(w.dtype)
        dx = torch.mm(g, w, out_dtype=torch.float32).to(w.dtype) if ctx.needs_input_grad[0] else None
        dw = torch.mm(g.t(), x2, out_dtype=torch.float32).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


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


def _interleave(ws: list, groups: int) -> list:
    """The row blocks of ``ws`` in the fused order ``concat_s [w0_s; w1_s;
    ...]``, ``w_s`` the s-th of ``groups`` equal row slices of ``w``."""
    for w in ws:
        if w.shape[0] % groups:
            raise ValueError(f"{w.shape[0]} rows do not split into {groups} groups")
    return [w[s * (w.shape[0] // groups) : (s + 1) * (w.shape[0] // groups)] for s in range(groups) for w in ws]


def fuse_rows(ws, groups: int = 1):
    """Fuse [m_i, n] weights (or [m_i] vectors) along the out dim,
    interleaved per tensor-parallel shard: rows ``concat_s [w0_s; w1_s;
    ...]`` with ``w_s`` rows ``[s*m/g, (s+1)*m/g)`` of ``w``, so shard s's
    contiguous slice is its own ``[q; k; v]`` (``groups=1``: ``[w0; w1;
    ...]``).  All dense (torch tensors or numpy arrays) or all
    :class:`QDense` (codes and per-block scales fused with the same rows,
    so separately quantized projections fuse exactly).  Mixing the two in
    one group raises: a dense minority quantized here would hide a
    checkpoint inconsistency."""
    n_q = sum(isinstance(w, QDense) for w in ws)
    if n_q:
        if n_q != len(ws):
            raise ValueError("cannot fuse pre-quantized and dense weights in one group")
        qt = {w.quant_type for w in ws}
        if len(qt) > 1:
            raise ValueError(f"mixed quant_types in fused group: {qt}")
        return QDense(np.concatenate(_interleave([w.codes for w in ws], groups)),
                      np.concatenate(_interleave([w.scales for w in ws], groups)), ws[0].quant_type)
    return torch.cat(_interleave([_host(w) for w in ws], groups))


def _linear(w, cfg: LlamaConfig, device, shards: int = 1) -> Weight:
    """One projection on ``device``: a :class:`QDense` repacked (its codes
    untouched), a dense weight quantized (``cfg.quantize``) or cast to
    ``cfg.dtype``; packed with K in ``shards`` chunks (row-parallel)."""
    if isinstance(w, QDense):
        if not cfg.quantize:
            raise ValueError("pre-quantized (bnb) weights require cfg.quantize=True")
        if w.quant_type != cfg.quant_type:
            raise ValueError(f"checkpoint quant_type {w.quant_type!r} != config quant_type {cfg.quant_type!r}")
        return pack_codes_for_tpu(w.codes, w.scales, dtype=cfg.dtype, shards=shards, quant_type=w.quant_type,
                                  device=device)
    if cfg.quantize:
        return quantize_for_tpu(w, dtype=cfg.dtype, shards=shards, quant_type=cfg.quant_type, device=device)
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
    dequantized exactly to fp32.  Packed for ``cfg.tp_shards``: the fused
    rows interleaved per shard, ``wo`` and ``w_down`` in K chunks (the
    experts with ``cfg.moe_groups``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    g = cfg.tp_shards

    def vector(name):
        return _host(lw[name]).to(dev, torch.float32) if name in lw else None

    qkv_bias = None
    if cfg.attn_bias:
        qkv_bias = fuse_rows([lw["bq"], lw["bk"], lw["bv"]], g).to(dev, torch.float32)
    router = None
    if cfg.num_experts > 1:
        experts, ge = range(cfg.num_experts), cfg.moe_groups
        gu = _stack([_linear(fuse_rows([lw[f"expert{e}.w_gate"], lw[f"expert{e}.w_up"]], ge), cfg, dev)
                     for e in experts])
        dn = _stack([_linear(lw[f"expert{e}.w_down"], cfg, dev, ge) for e in experts])
        router = lw["router"]
        router = _host(router.to_dense() if isinstance(router, QDense) else router).to(dev, torch.float32)
    else:
        gu = _linear(fuse_rows([lw["w_gate"], lw["w_up"]], g), cfg, dev)
        dn = _linear(lw["w_down"], cfg, dev, g)
    return LayerParams(
        wqkv=_linear(fuse_rows([lw["wq"], lw["wk"], lw["wv"]], g), cfg, dev),
        wo=_linear(lw["wo"], cfg, dev, g),
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


def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> LlamaParams:
    """Random weights on ``device`` (default ``cuda``), quantized per
    ``cfg.quantize``: the JAX package's ``init_params``, the same
    ``np.random.default_rng(seed)`` draws in the same order (per layer the
    q/k/v biases, q, k, v, o, then gate, up and down, per expert with the
    router after them; then the embedding and the lm_head), so dense
    leaves equal its bit for bit, and packed ones after the same
    ``quantize_for_tpu``.  Norms are ones."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def dense(mo, ni):
        return (rng.standard_normal((mo, ni)) * (ni**-0.5)).astype(np.float32)

    def ones(n):
        return np.ones(n, np.float32)

    layers = []
    for _ in range(cfg.num_layers):
        lw = {"input_norm": ones(h), "post_attn_norm": ones(h)}
        if cfg.attn_bias:
            lw.update(bq=rng.standard_normal(cfg.q_dim) * 0.02, bk=rng.standard_normal(cfg.kv_dim) * 0.02,
                      bv=rng.standard_normal(cfg.kv_dim) * 0.02)
        lw.update(wq=dense(cfg.q_dim, h), wk=dense(cfg.kv_dim, h), wv=dense(cfg.kv_dim, h), wo=dense(h, cfg.q_dim))
        if cfg.num_experts == 1:
            lw.update(w_gate=dense(inter, h), w_up=dense(inter, h), w_down=dense(h, inter))
        else:
            for e in range(cfg.num_experts):
                lw.update({f"expert{e}.w_gate": dense(inter, h), f"expert{e}.w_up": dense(inter, h),
                           f"expert{e}.w_down": dense(h, inter)})
            lw["router"] = rng.standard_normal((cfg.num_experts, h)) * (h**-0.5)
        if cfg.attn_logit_softcapping is not None or cfg.sliding_window_pattern > 1:  # Gemma-2's block
            lw.update(post_attn_out_norm=ones(h), post_ffw_norm=ones(h))
        if cfg.qk_norm:
            lw.update(q_norm=ones(cfg.head_dim), k_norm=ones(cfg.head_dim))
        layers.append(quantize_layer(lw, cfg, dev))
    embed = (rng.standard_normal((cfg.vocab_size, h)) * 0.02).astype(np.float32)
    head = (rng.standard_normal((cfg.vocab_size, h)) * (h**-0.5)).astype(np.float32)
    return LlamaParams(embed=_host(embed).to(dev, cfg.dtype), layers=layers,
                       final_norm=torch.ones(h, dtype=torch.float32, device=dev), lm_head=_lm_head(head, cfg, dev))


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


def split_fused(y: torch.Tensor, sizes, groups: int = 1) -> List[torch.Tensor]:
    """Split the output features of a fused matmul, y [..., sum(sizes)],
    one tensor per entry of ``sizes``: the inverse of :func:`fuse_rows`
    with the same ``groups``."""
    if groups == 1:
        return list(torch.split(y, list(sizes), dim=-1))
    parts = torch.split(y, [size // groups for _ in range(groups) for size in sizes], dim=-1)
    return [torch.cat(parts[i :: len(sizes)], dim=-1) for i in range(len(sizes))]


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


@dataclasses.dataclass
class BankAB:
    """One projection's adapters of a multi-LoRA bank (``train.lora.
    stack_adapters``) in the form the banked delta reads: ``a`` [A * r, in]
    and ``b`` [out, A * r] in the activation dtype (adapter j's rank rows
    at ``j * r .. (j + 1) * r``), ``num`` = A."""

    a: torch.Tensor
    b: torch.Tensor
    num: int
    scaling: float = 1.0


@dataclasses.dataclass
class BankLayer:
    """One layer's :class:`BankAB` per adapted projection (None: not adapted)."""

    qkv: Optional[BankAB] = None
    o: Optional[BankAB] = None
    gateup: Optional[BankAB] = None
    down: Optional[BankAB] = None


@dataclasses.dataclass
class LoraBank:
    """A multi-LoRA bank in serving form (:func:`prepare_bank`)."""

    layers: List[BankLayer]
    num_adapters: int


def _bank_ab(a: torch.Tensor, b: torch.Tensor, scaling: float, dtype) -> BankAB:
    """A stacked pair (``a`` [A, r, in], ``b`` [A, out, r]) as a :class:`BankAB`
    of ``dtype``: the values of the JAX package's per-call cast."""
    n, r, n_in = a.shape
    return BankAB(a.to(dtype).reshape(n * r, n_in), b.to(dtype).permute(1, 0, 2).reshape(-1, n * r), n, scaling)


def prepare_bank(lora, dtype) -> LoraBank:
    """A stacked bank (``train.lora.stack_adapters``, duck-typed: each pair's
    ``a`` is [A, r, in]) as a :class:`LoraBank` of ``dtype``, made once: the
    serving Engine's, so a decode step reads the bank in its dtype with no
    cast and no transpose."""
    layers, num = [], 0
    for ll in lora.layers:
        fields = {}
        for f in ("qkv", "o", "gateup", "down"):
            ab = getattr(ll, f)
            if ab is None:
                continue
            if ab.a.dim() != 3:
                raise ValueError("a LoRA bank's pairs are stacked [A, r, in]: use train.lora.stack_adapters")
            fields[f] = _bank_ab(ab.a.detach(), ab.b.detach(), ab.scaling, dtype)
            num = fields[f].num
        layers.append(BankLayer(**fields))
    if not num:
        raise ValueError("the LoRA bank adapts no projection")
    return LoraBank(layers, num)


def _bank_size(lora) -> int:
    """The number of adapters of a banked ``lora`` (a :class:`LoraBank` or a
    stacked ``LoraParams``); 0 for one adapter or none."""
    if lora is None:
        return 0
    if isinstance(lora, LoraBank):
        return lora.num_adapters
    ab = next((getattr(lora.layers[0], f) for f in ("qkv", "o", "gateup", "down")
               if getattr(lora.layers[0], f) is not None), None)
    return 0 if ab is None or ab.a.dim() == 2 else ab.a.shape[0]


def _adapter_mask(adapter_ids: torch.Tensor, num: int, dtype) -> torch.Tensor:
    """The one-hot rows [B, A] of ``adapter_ids`` [B] (-1: none, all zero),
    made once per forward with no host read, so a decode chunk captures."""
    return (adapter_ids[:, None] == torch.arange(num, device=adapter_ids.device, dtype=adapter_ids.dtype)).to(dtype)


def _lora_delta(x: torch.Tensor, ab, adapter_ids=None, sel=None) -> Optional[torch.Tensor]:
    """One projection's low-rank update ``(x @ A^T) @ B^T * scaling`` in
    ``x``'s dtype (the QLoRA convention), or None when ``ab`` is None.
    ``ab`` is a ``train.lora.LoraAB`` (duck-typed): one adapter (``a`` [r,
    in]), or a stacked bank (``a`` [A, r, in], or a :class:`BankAB`) with
    ``adapter_ids`` [B] int32 selecting one adapter per row (-1: none,
    delta 0); ``sel`` is their :func:`_adapter_mask`, when the caller made
    it once for every projection.

    The bank's design is the JAX package's: both products run over the
    whole bank, ``x`` [B, S, in] against every adapter's A ([A * r, in]),
    and a one-hot mask of each row's adapter zeroes the other adapters'
    columns of the rank-r intermediate before the product with every B
    ([out, A * r]).  A gather of each row's pair would read the same bank
    bytes at decode (every adapter of a batch of slots may be live) and
    write a copy of them besides, and at a prefill of many rows per
    adapter it would repeat the pair per row.  A row's delta follows its
    own id and its own ``x`` only (the other adapters' terms are exact
    zeros), no shape follows the ids, and nothing reads the host."""
    if ab is None:
        return None
    if isinstance(ab, BankAB) or ab.a.dim() == 3:
        bank = ab if isinstance(ab, BankAB) else _bank_ab(ab.a, ab.b, ab.scaling, x.dtype)
        if sel is None:
            if adapter_ids is None:
                raise ValueError("banked LoRA needs adapter_ids [B]")
            sel = _adapter_mask(adapter_ids, bank.num, x.dtype)
        b, s = x.shape[:2]
        t = x @ bank.a.to(x.dtype).t()  # [B, S, A * r]
        t = (t.view(b, s, bank.num, -1) * sel[:, None, :, None]).view(b, s, -1)
        d = t @ bank.b.to(x.dtype).t()
        return d if bank.scaling == 1.0 else d * bank.scaling
    return (x @ ab.a.to(x.dtype).t()) @ ab.b.to(x.dtype).t() * ab.scaling


def _add_delta(y: torch.Tensor, delta: Optional[torch.Tensor]) -> torch.Tensor:
    """``y`` plus a delta in the activation dtype (at most ``y``'s), summed
    in ``y``'s dtype."""
    return y if delta is None else y + delta


def _col_chunks(w: Weight, nchunks: int) -> Optional[list]:
    """``w`` as ``nchunks`` weights of consecutive out-features (lanes), each
    a contiguous copy the kernels take; None when the padded out dim does
    not split into chunks of whole 128-lane tiles.  A chunk's logical width
    is its padded one (padding lanes give exact zeros), so the chunks'
    outputs side by side are the padded output."""
    if isinstance(w, (PackedNF4, PackedInt8)):
        m_pad, n_pad = w.padded_shape
        if m_pad % nchunks or (m_pad // nchunks) % 128:
            return None
        mc = m_pad // nchunks
        data = "values" if isinstance(w, PackedInt8) else "packed"
        return [dataclasses.replace(w, **{data: getattr(w, data)[..., c * mc : (c + 1) * mc].contiguous()},
                                    scales=w.scales[..., c * mc : (c + 1) * mc].contiguous(), shape=(mc, w.shape[1]),
                                    padded_shape=(mc, n_pad))
                for c in range(nchunks)]
    m = w.shape[-2]
    if m % nchunks:
        return None
    return [w[..., c * (m // nchunks) : (c + 1) * (m // nchunks), :] for c in range(nchunks)]


def _reduced_matmul(x: torch.Tensor, w: Weight, reduce_fn, out_dtype=None, decode: bool = False) -> torch.Tensor:
    """A row-parallel projection and its reduction over the ranks
    (``reduce_fn``), in ``out_dtype`` (fp32: the partial sums are added
    before any rounding to the activation dtype).  Under
    ``NF4TPU_COLLECTIVE_MATMUL=N`` (:func:`collective_chunks`) the output
    columns are computed in N chunks (:func:`_col_chunks`, each a copy of
    its slice of the weight), each reduced on its own; the result is the
    same bits as one reduction."""
    nchunks = collective_chunks() if reduce_fn is not None else 0
    chunks = _col_chunks(w, nchunks) if nchunks > 1 else None
    reduce_fn = reduce_fn or (lambda t: t)
    if chunks is None:
        return reduce_fn(_matmul(x, w, out_dtype=out_dtype, decode=decode))
    parts = [reduce_fn(_matmul(x, wc, out_dtype=out_dtype, decode=decode)) for wc in chunks]
    return torch.cat(parts, dim=-1)[..., : w.shape[-2] if isinstance(w, torch.Tensor) else w.shape[0]]


def _post(cfg: LlamaConfig, t: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Gemma-2/3's RMSNorm of a sublayer's fp32 output before its residual
    add; ``t`` itself without the norm."""
    return t if w is None else rms_norm(t, w, cfg.rms_norm_eps, cfg.rmsnorm_one_plus)


def _layer_forward(cfg, x, lp: LayerParams, layer_cache: Optional[KVCache], positions, seq_lens, cos, sin,
                   kv_len=None, ll=None, train: bool = False, segment_ids=None, cache_index=None, window=None,
                   decode: bool = False, sel=None, reduce_fn=None, copy_fn=None, ring=None):
    """One decoder layer; x [B, S, hidden]; writes this call's K/V into the
    layer's cache views in place at ``cache_index`` (the positions'
    :func:`_cache_index`).  ``window`` is the layer's sliding window
    (:func:`_layer_window`); ``decode`` marks the rows as decode rows (see
    :func:`forward`).  ``ll`` is the layer's LoRA adapters
    (``train.lora.LoraLayer``, or a bank's layer with ``sel`` its rows'
    :func:`_adapter_mask`) or None; ``train=True`` uses no cache
    (attention over this call's own K/V, differentiable paths only, with
    ``segment_ids`` for packed rows).  ``reduce_fn`` sums a row-parallel
    product over the tensor-parallel ranks (see :func:`forward`);
    ``copy_fn`` (training) marks each sublayer's normed input as the input
    of column-parallel products (see :func:`train_forward`).  ``ring``
    ((the ring, the host's (min, max) query position), sequence
    parallelism; see :func:`forward`) sends attention around the ring over
    this call's fresh K/V, after they are written into the rank's cache."""
    b, s, _ = x.shape
    copy_fn = copy_fn or (lambda t: t)

    def delta(t, name):
        return None if ll is None else _lora_delta(t, getattr(ll, name), sel=sel)

    one_plus = cfg.rmsnorm_one_plus
    attn_in = copy_fn(rms_norm(x, lp.input_norm, cfg.rms_norm_eps, one_plus))
    qkv = _add_delta(_matmul(attn_in, lp.wqkv, decode=decode), delta(attn_in, "qkv"))  # one kernel for q+k+v
    if lp.qkv_bias is not None:
        qkv = qkv + lp.qkv_bias.to(qkv.dtype)
    if cfg.tp_shards == 1:
        qk, v = split_fused(qkv, (cfg.q_dim + cfg.kv_dim, cfg.kv_dim))
    else:  # a checkpoint packed for tensor parallelism, on one device
        q, k, v = split_fused(qkv, (cfg.q_dim, cfg.kv_dim, cfg.kv_dim), cfg.tp_shards)
        qk = torch.cat((q, k), dim=-1)
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
            logit_softcap=cfg.attn_logit_softcapping,
        )
    else:
        if cfg.kv_quant:
            (k, v), kv_scale = _quantize_kv(torch.stack((k, v)))
            _write_kv(layer_cache.k_scale, kv_scale[0], cache_index)
            _write_kv(layer_cache.v_scale, kv_scale[1], cache_index)
        _write_kv(layer_cache.k, k, cache_index)
        _write_kv(layer_cache.v, v, cache_index)
    if ring is not None:
        from ..parallel.sp import ring_attention

        k, v = k.to(layer_cache.k.dtype), v.to(layer_cache.v.dtype)  # the representation the cache stores
        attn = ring_attention(
            q, k, v, positions, seq_lens, ring=ring[0], q_pos_range=ring[1],
            scale=cfg.attn_scale,
            sliding_window=window,
            k_scale=None if not cfg.kv_quant else kv_scale[0],
            v_scale=None if not cfg.kv_quant else kv_scale[1],
            logit_softcap=cfg.attn_logit_softcapping,
        )
    elif not train:
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
    # Row-parallel products stay fp32 through the reduction, cast once after
    # it; a LoRA delta joins the partial product before the reduction.
    if ll is None or ll.o is None:
        o_proj = _reduced_matmul(attn, lp.wo, reduce_fn, out_dtype=torch.float32, decode=decode)
    else:
        o_proj = _add_delta(_matmul(attn, lp.wo, out_dtype=torch.float32, decode=decode), delta(attn, "o"))
        o_proj = o_proj if reduce_fn is None else reduce_fn(o_proj)
    x = x + _post(cfg, o_proj, lp.post_attn_out_norm).to(x.dtype)

    mlp_in = copy_fn(rms_norm(x, lp.post_attn_norm, cfg.rms_norm_eps, one_plus))
    if lp.router is not None:
        if ll is not None and (ll.gateup is not None or ll.down is not None):
            raise ValueError("LoRA on MoE expert MLPs is not supported; adapt the attention projections "
                             "(targets=('wqkv', 'wo'))")
        return x + _post(cfg, _moe_mlp(cfg, mlp_in, lp, decode, reduce_fn), lp.post_ffw_norm).to(x.dtype)
    gateup = _add_delta(_matmul(mlp_in, lp.w_gateup, decode=decode), delta(mlp_in, "gateup"))  # one kernel for gate+up
    h = _gated(cfg, gateup, cfg.tp_shards)
    # The product before its delta: a layer's recompute under remat stops
    # after the last tensor the backward saves, so the order keeps w_down's
    # product in it.
    if ll is None or ll.down is None:
        down = _reduced_matmul(h, lp.w_down, reduce_fn, out_dtype=torch.float32, decode=decode)
    else:
        down = _add_delta(_matmul(h, lp.w_down, out_dtype=torch.float32, decode=decode), delta(h, "down"))
        down = down if reduce_fn is None else reduce_fn(down)
    return x + _post(cfg, down, lp.post_ffw_norm).to(x.dtype)


def _gated(cfg: LlamaConfig, gateup: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """act(gate) * up of a fused gate+up output (interleaved in ``groups``),
    the activation in fp32."""
    gate, up = split_fused(gateup, (cfg.intermediate_size, cfg.intermediate_size), groups)
    return _ACTIVATIONS[cfg.activation](gate.float()).to(up.dtype) * up


def _moe_mlp(cfg: LlamaConfig, mlp_in: torch.Tensor, lp: LayerParams, decode: bool = False,
             reduce_fn=None) -> torch.Tensor:
    """The mixture-of-experts MLP (the JAX package's ``_moe_mlp``): fp32
    router logits (full fp32 products: TF32 could flip a route), the top
    ``experts_per_token`` experts of each token, ties to the lower index as
    ``lax.top_k`` breaks them (a stable descending sort), their weights
    renormalized (``moe_norm_topk``) or the full softmax's; then every token
    through every expert in expert order, each expert's fp32 output
    weighted by the token's weight for it (0 where not chosen) into an fp32
    sum.  No shape depends on the routes, so decode chunks capture.
    ``decode``: the rows are decode rows (see :func:`forward`).

    Under tensor parallelism the router is whole on every rank; in
    "tensor" mode each expert's columns and K chunks are the rank's slice,
    in "expert" mode the rank holds ``num_experts`` whole experts, local
    expert e being global expert ``ep_rank * num_experts + e``.  Either way
    ``reduce_fn`` runs once, on the fp32 expert sum."""
    with _ieee_fp32():
        logits = mlp_in.float() @ lp.router.float().t()  # [B, S, E]
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_v, top_i = order.values[..., : cfg.experts_per_token], order.indices[..., : cfg.experts_per_token]
    if cfg.moe_norm_topk:
        weights = torch.softmax(top_v, dim=-1)
    else:
        weights = torch.softmax(logits, dim=-1).gather(-1, top_i)
    per_expert = torch.zeros_like(logits).scatter(-1, top_i, weights)  # [B, S, E], the chosen experts' weights
    off = 0 if cfg.ep_rank is None else cfg.ep_rank * cfg.num_experts
    acc = torch.zeros(mlp_in.shape, dtype=torch.float32, device=mlp_in.device)
    for e, (gu, dn) in enumerate(zip(_experts(lp.w_gateup), _experts(lp.w_down))):
        h = _gated(cfg, _matmul(mlp_in, gu, decode=decode), cfg.moe_groups)
        out = _matmul(h, dn, out_dtype=torch.float32, decode=decode)
        acc = acc + per_expert[..., off + e : off + e + 1] * out
    return acc if reduce_fn is None else reduce_fn(acc)


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
    hidden: bool = False,
    adapter_ids: Optional[torch.Tensor] = None,  # [B] int32: each row's adapter of a banked `lora`, -1 none
    reduce_fn=None,
    gather_fn=None,
    ring_axis=None,  # parallel.sp.Ring: sequence-parallel ring attention
    cache_positions: Optional[torch.Tensor] = None,  # [B, S] the rank's cache slots, when not `positions`
) -> Tuple[torch.Tensor, KVCache]:
    """Embed, run every layer, return fp32 logits ([B, S, V], or [B, V] for
    each row's last valid token with ``last_only``) and the cache, written
    in place.  ``kv_len`` (host int) bounds the slots any query can see.
    ``lora`` is an optional unmerged ``train.lora.LoraParams``: one
    adapter, or a bank (``train.lora.stack_adapters``, or its serving form
    :func:`prepare_bank`) with ``adapter_ids`` choosing each row's.
    ``hidden=True`` returns the last layer's output instead of the logits
    (``[B, S, hidden]``, before the final norm), for a caller that applies
    :func:`lm_head` a part at a time (scoring keeps no ``[B, S, V]``).

    ``decode=True`` marks the S positions of each row as decode rows, not a
    prompt: a speculative verify window of S <= 16 consecutive positions
    on a live cache.  Their projections route by row count as decode's do
    (``_matmul``) and their attention is :func:`~nf4_tpu_torch.ops.
    attention.decode_attention`, so a row's logits follow its own tokens
    and cache only, as a decode step's do.  Prompts pass no marker.

    Tensor parallelism (``parallel/tp.py``): ``params`` are this rank's
    slice, ``cfg`` its ``tp_local_config`` and ``cache`` its heads;
    ``reduce_fn(t)`` sums an fp32 partial product over the ranks, and
    ``gather_fn(logits)`` makes the rank's vocabulary slice of the logits
    full rows (without it the slice is returned, as the JAX package's
    ``forward`` returns it).

    Sequence parallelism (``parallel/sp.py``): ``ring_axis`` is the ring
    (a ``parallel.sp.Ring``; the JAX package's keyword, which names its
    mesh axis) and ``tokens`` the rank's slice of the prompt at its global
    ``positions``; the rank's cache holds its slice only, written at
    ``cache_positions`` (local slots), and attention goes around the ring
    (``parallel.sp.ring_attention``).  ``last_only`` then picks, on each
    rank, the row of its slice nearest each row's last token."""
    check_supported(cfg)
    if lora is not None and reduce_fn is not None:
        raise ValueError("unmerged LoRA adapters cannot run under tensor parallelism; merge_lora them first")
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    tables = _layer_tables(cfg, positions)
    index = _cache_index(positions if cache_positions is None else cache_positions)
    ring = None if ring_axis is None else (ring_axis, (int(positions.min()), int(positions.max())))
    num = _bank_size(lora)
    sel = None
    if num:
        if adapter_ids is None:
            raise ValueError("banked LoRA needs adapter_ids [B]")
        sel = _adapter_mask(adapter_ids, num, x.dtype)
    for i, lp in enumerate(params.layers):
        ll = None if lora is None else lora.layers[i]
        x = _layer_forward(cfg, x, lp, cache.layer(i), positions, seq_lens, *tables[i], kv_len, ll=ll,
                           cache_index=index, window=_layer_window(cfg, i), decode=decode, sel=sel,
                           reduce_fn=reduce_fn, ring=ring)
    if last_only:
        last_idx = torch.clamp(seq_lens - 1 - positions[:, 0], 0, s - 1).long()
        x = x[torch.arange(b, device=x.device), last_idx]
    if hidden:
        return x, cache
    logits = lm_head(params, cfg, x, decode)
    return (logits if gather_fn is None else gather_fn(logits)), cache


def _embed(params: LlamaParams, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embedding rows; scaled by sqrt(hidden) in fp32 with
    ``scale_embeddings`` (Gemma)."""
    x = params.embed[tokens.long()]
    if cfg.scale_embeddings:
        x = (x.float() * cfg.hidden_size**0.5).to(x.dtype)
    return x


def lm_head(params: LlamaParams, cfg: LlamaConfig, x: torch.Tensor, decode: bool = False) -> torch.Tensor:
    """The model's head: fp32 logits of the final norm of hidden states
    ``x`` (``forward(hidden=True)``'s), softcapped with
    ``final_logit_softcapping``; ``decode`` as in :func:`forward`."""
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
    reduce_fn=None,
    copy_fn=None,
) -> torch.Tensor:
    """Full-sequence fp32 logits [B, S, V] for fine-tuning.

    Differs from :func:`prefill` where training needs it: no KV cache (each
    layer attends over its own fresh K/V), attention on the differentiable
    plain paths, and ``remat=True`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant), so the backward recomputes
    the layer's activations instead of keeping all ``L`` layers' of them.
    Gradients flow to ``lora`` and to any dense leaf that requires one
    (a ``quantize=False`` model's projections train in full); the packed
    weights are frozen.  For packed rows (``train.data.pack_sft``)
    ``segment_ids`` makes attention block-diagonal and ``positions`` carries
    the segment-relative rotary phases; the causal mask runs on slot
    indices.  Every family that serves trains: each layer gets its window
    and its RoPE tables (Gemma-2/3's local layers), attention its logit
    softcap, the head the final one; an MoE layer's experts stay frozen
    (LoRA on the attention projections only), their gradient to the
    activations through ``nf4_matmul``'s backward.

    Tensor parallelism (``parallel.tp.train_hooks``): ``params`` and
    ``lora`` are the rank's slices (``train.lora.shard_lora``), ``cfg``
    its ``tp_local_config``; ``reduce_fn`` sums a row-parallel product
    over the ranks and passes its gradient through unchanged; ``copy_fn``
    is the identity on each column-parallel product's input (a sublayer's
    normed input, the head's input), whose backward sums the gradient over
    the ranks, each rank holding only its columns' part of it; the logits
    are the rank's vocabulary slice (the loss, ``train.trainer.
    _tp_lm_loss``, works on the slices, as the JAX package's does)."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    slot_ids = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    seq_lens = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    tables = _layer_tables(cfg, slot_ids if positions is None else positions)
    for i, lp in enumerate(params.layers):
        ll = None if lora is None else lora.layers[i]

        def layer(x, lp=lp, ll=ll, cos=tables[i][0], sin=tables[i][1], window=_layer_window(cfg, i)):
            return _layer_forward(cfg, x, lp, None, slot_ids, seq_lens, cos, sin, ll=ll, train=True,
                                  segment_ids=segment_ids, window=window, reduce_fn=reduce_fn, copy_fn=copy_fn)

        # Under remat each rank recomputes the same layers in the same
        # order (the backward's), so a recompute's collectives meet.
        x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    return lm_head(params, cfg, x if copy_fn is None else copy_fn(x))


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


def decode_step(params, cfg: LlamaConfig, token, cache: KVCache, positions, kv_len: Optional[int] = None,
                lora=None, adapter_ids=None, reduce_fn=None, gather_fn=None):
    """One token per sequence: token [B], positions [B] (the slot being
    written); ``lora`` / ``adapter_ids`` (the multi-LoRA Engine's bank and
    slot adapters) and ``reduce_fn`` / ``gather_fn`` (tensor parallelism)
    as in :func:`forward`.  Returns (logits [B, V], cache)."""
    logits, cache = forward(
        params, cfg, token[:, None], cache, positions[:, None], positions + 1, kv_len=kv_len, lora=lora,
        adapter_ids=adapter_ids, reduce_fn=reduce_fn, gather_fn=gather_fn,
    )
    return logits[:, 0], cache
