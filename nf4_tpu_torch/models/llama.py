"""Llama over packed 4-bit weights (dense Llama, single device): inference
and the fine-tuning forward.

The counterpart of the JAX package's ``models/llama.py``: RMSNorm, rotary
embeddings, GQA attention over a KV cache, SwiGLU MLP.  Every projection
goes through one call site, :func:`_matmul`: the fused 4-bit matmul for
:class:`PackedNF4` weights, the int8 matmul for weights recoded by
:func:`recode_params_int8`.  With ``kv_quant`` the KV cache is int8 with
per-slot absmax scales.  :func:`train_forward` is the cache-free,
differentiable forward of QLoRA fine-tuning: LoRA deltas
(``train.lora``) on the adapted projections, gradients to the adapters
through the packed weights' backward.

PyTorch idiom in place of the JAX one: layers are a Python list iterated by
a loop (the JAX package scans stacked layers), and :func:`forward` writes
the new keys and values into the cache IN PLACE (the JAX package returns a
new cache); it returns the same cache object for a like-for-like signature.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..nf4.format import PackedNF4
from ..ops.attention import attention
from ..ops.int8_serve import PackedInt8, int8_matmul, recode_int8_weight
from ..ops.matmul import nf4_matmul
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
    "decode_step",
    "recode_params_int8",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's configuration fields, so its configuration dicts
    load unchanged; :func:`forward` raises for the ones this port does not
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


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for configuration features this port does not serve yet."""
    missing = {
        "quantize=False (dense projections)": not cfg.quantize,
        "num_experts > 1": cfg.num_experts > 1,
        "attn_bias": cfg.attn_bias,
        "qk_norm": cfg.qk_norm,
        "attn_logit_softcapping": cfg.attn_logit_softcapping is not None,
        "final_logit_softcapping": cfg.final_logit_softcapping is not None,
        "rope_scaling": cfg.rope_scaling is not None,
        "rope_local_theta": cfg.rope_local_theta is not None,
        "tp_shards > 1": cfg.tp_shards > 1,
        "rmsnorm_one_plus": cfg.rmsnorm_one_plus,
        "scale_embeddings": cfg.scale_embeddings,
        "sliding_window_pattern > 1": cfg.sliding_window_pattern > 1,
        f"activation={cfg.activation!r}": cfg.activation != "silu",
    }
    bad = [name for name, on in missing.items() if on]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


Weight = Union[PackedNF4, PackedInt8]


@dataclasses.dataclass
class LayerParams:
    """One decoder layer.  q+k+v and gate+up are fused, one matmul each."""

    wqkv: Weight  # [q_dim + 2*kv_dim, hidden]
    wo: Weight  # [hidden, q_dim]
    w_gateup: Weight  # [2*intermediate, hidden]
    w_down: Weight  # [hidden, intermediate]
    input_norm: torch.Tensor  # fp32 [hidden]
    post_attn_norm: torch.Tensor  # fp32 [hidden]


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


def _matmul(x: torch.Tensor, w: Weight, out_dtype=None) -> torch.Tensor:
    """The one call site of every projection."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, PackedInt8):
        return int8_matmul(x, w, out_dtype=out_dtype)
    return nf4_matmul(x, w, out_dtype=out_dtype)


def recode_params_int8(params: LlamaParams) -> LlamaParams:
    """Every packed 4-bit projection recoded to int8 (see
    :mod:`~nf4_tpu_torch.ops.int8_serve`): twice the weight bytes, values on
    the 4-bit grid up to the int8 rounding of the codebook.  A dense bf16
    lm_head stays as it is."""

    def recode(w):
        return recode_int8_weight(w) if isinstance(w, PackedNF4) else w

    layers = [
        dataclasses.replace(lp, **{n: recode(getattr(lp, n)) for n in ("wqkv", "wo", "w_gateup", "w_down")})
        for lp in params.layers
    ]
    return dataclasses.replace(params, layers=layers, lm_head=recode(params.lm_head))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., D] for the HF 'rotate_half' convention (default rope)."""
    half = cfg.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (cfg.rope_theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
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


def _layer_forward(cfg, x, lp: LayerParams, layer_cache: Optional[KVCache], positions, seq_lens, cos, sin,
                   kv_len=None, ll=None, train: bool = False, segment_ids=None, cache_index=None):
    """One decoder layer; x [B, S, hidden]; writes this call's K/V into the
    layer's cache views in place at ``cache_index`` (the positions'
    :func:`_cache_index`).  ``ll`` is the layer's LoRA adapters
    (``train.lora.LoraLayer``) or None; ``train=True`` uses no cache
    (attention over this call's own K/V, differentiable paths only, with
    ``segment_ids`` for packed rows)."""
    b, s, _ = x.shape

    def delta(t, name):
        return None if ll is None else _lora_delta(t, getattr(ll, name))

    attn_in = rms_norm(x, lp.input_norm, cfg.rms_norm_eps)
    qkv = _add_delta(_matmul(attn_in, lp.wqkv), delta(attn_in, "qkv"))  # one kernel for q+k+v
    qk, v = split_fused(qkv, (cfg.q_dim + cfg.kv_dim, cfg.kv_dim))
    # RoPE of the q and k heads in one pass.
    qk = apply_rope(qk.reshape(b, s, cfg.num_heads + cfg.num_kv_heads, cfg.head_dim).transpose(1, 2), cos, sin)
    q, k = qk.split((cfg.num_heads, cfg.num_kv_heads), dim=1)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    if train:
        attn = attention(
            q, k, v, positions, seq_lens,
            scale=cfg.attn_scale,
            sliding_window=cfg.sliding_window,
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
            sliding_window=cfg.sliding_window,
            k_scale=layer_cache.k_scale,
            v_scale=layer_cache.v_scale,
            kv_len=kv_len,
        )
    attn = attn.transpose(1, 2).reshape(b, s, cfg.q_dim)
    o_proj = _add_delta(_matmul(attn, lp.wo, out_dtype=torch.float32), delta(attn, "o"))
    x = x + o_proj.to(x.dtype)

    mlp_in = rms_norm(x, lp.post_attn_norm, cfg.rms_norm_eps)
    gateup = _add_delta(_matmul(mlp_in, lp.w_gateup), delta(mlp_in, "gateup"))  # one kernel for gate+up
    gate, up = split_fused(gateup, (cfg.intermediate_size, cfg.intermediate_size))
    h = F.silu(gate.float()).to(up.dtype) * up
    down = _add_delta(_matmul(h, lp.w_down, out_dtype=torch.float32), delta(h, "down"))
    return x + down.to(x.dtype)


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
) -> Tuple[torch.Tensor, KVCache]:
    """Embed, run every layer, return fp32 logits ([B, S, V], or [B, V] for
    each row's last valid token with ``last_only``) and the cache, written
    in place.  ``kv_len`` (host int) bounds the slots any query can see.
    ``lora`` is an optional unmerged ``train.lora.LoraParams``."""
    check_supported(cfg)
    b, s = tokens.shape
    x = params.embed[tokens.long()]
    cos, sin = rope_tables(cfg, positions)
    index = _cache_index(positions)
    for i, lp in enumerate(params.layers):
        ll = None if lora is None else lora.layers[i]
        x = _layer_forward(cfg, x, lp, cache.layer(i), positions, seq_lens, cos, sin, kv_len, ll=ll,
                           cache_index=index)
    if last_only:
        last_idx = torch.clamp(seq_lens - 1 - positions[:, 0], 0, s - 1).long()
        x = x[torch.arange(b, device=x.device), last_idx]
    return _logits(params, cfg, x), cache


def _logits(params: LlamaParams, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.rms_norm_eps)
    if isinstance(params.lm_head, (PackedNF4, PackedInt8)):
        return _matmul(x, params.lm_head, out_dtype=torch.float32)
    return _dense_logits(x, params.lm_head.to(x.dtype))


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
    indices."""
    check_supported(cfg)
    b, s = tokens.shape
    x = params.embed[tokens.long()]
    slot_ids = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    seq_lens = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_tables(cfg, slot_ids if positions is None else positions)
    for i, lp in enumerate(params.layers):
        ll = None if lora is None else lora.layers[i]

        def layer(x, lp=lp, ll=ll):
            return _layer_forward(cfg, x, lp, None, slot_ids, seq_lens, cos, sin,
                                  ll=ll, train=True, segment_ids=segment_ids)

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


def decode_step(params, cfg: LlamaConfig, token, cache: KVCache, positions, kv_len: Optional[int] = None):
    """One token per sequence: token [B], positions [B] (the slot being
    written).  Returns (logits [B, V], cache)."""
    logits, cache = forward(
        params, cfg, token[:, None], cache, positions[:, None], positions + 1, kv_len=kv_len
    )
    return logits[:, 0], cache
