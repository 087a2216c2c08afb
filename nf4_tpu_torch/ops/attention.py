"""Attention: naive and chunked plain PyTorch, and prefill flash (kernel C).

One math contract for every path (the JAX package's ``ops/attention.py``):
a key slot t is visible to a query at position p iff ``t <= p`` (causal),
``t < seq_len`` and, with a static window w, ``t > p - w``.  Softmax and
accumulation are fp32; q, k, v and the output are the working dtype (bf16
in serving), and probabilities round to it before the P.V product.

* ``naive_attention`` materializes the [B, KV, G, S, T] fp32 scores.  It
  serves short prefills.
* ``decode_attention`` serves decode rows over fixed key blocks of
  ``DECODE_KV_BLOCK`` slots, so a row's output does not depend on how far
  past its position the cache is read: one query per row, or a
  speculative verify window of up to ``DECODE_MAX_QUERIES`` consecutive
  positions per row; decode attention is plain tensor code in the JAX
  package too.
* ``chunked_attention`` streams the softmax over query and key chunks and
  skips key chunks a query chunk cannot see (bounded memory for long
  prefills where the kernel does not apply).
* ``flash_attention`` runs the hand-written kernel ``csrc/flash_attn.cu``
  on CUDA tensors and its plain version :func:`_flash_plain` on CPU ones
  (``NF4TPU_BACKEND``, ``utils/env.py``: under ``jnp`` the dispatcher
  takes the plain paths on the card too, as the JAX package's does).
  Its shape contract is the TPU kernel's: head size D = 64 or any multiple
  of 128, any GQA group G = H / KV, any S and T (ragged edges masked in
  the kernel).  A 64-row query tile packs sc = floor(64 / G) positions of
  all G heads of a KV head (one position of 64 heads for G > 64, several
  tiles per position); the key tiles have 64 slots, 32 at D = 256.

Every caller passes per-row contiguous positions (``pos0 + arange(S)``),
which the flash kernel needs.

int8 KV: k and v are int8 with fp32 per-slot absmax scales ``k_scale`` /
``v_scale`` [B, KV, T].  Every path folds them in without materializing a
dequantized cache: scores are multiplied by ``scale`` and then by
``k_scale / 127``; the softmax normaliser takes the unscaled probabilities,
which are then multiplied by ``v_scale / 127`` before their rounding to the
working dtype and the P.V product.

Packed training rows (``segment_ids`` [B, S], self-attention only): a
query sees a key only when their segment ids also match (block-diagonal
attention); the positions are then slot indices.  The training forward
asks for ``differentiable=True``, which never takes kernel C (it has no
backward): the plain paths run under autograd, as the JAX package's XLA
paths do under ``jax.grad``.

Logit softcapping (Gemma-2, ``logit_softcap=cap``): every plain path maps
the scores to ``tanh(s / cap) * cap`` after the scale and the int8
``k_scale / 127`` factor and before the mask, in the JAX package's order.
Kernel C takes no softcap, as the TPU kernel takes none: a softcapped
prefill stays on the plain paths.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils import env, trace
from ._cuda import Kernel

__all__ = ["attention", "naive_attention", "decode_attention", "chunked_attention", "flash_attention"]

_NEG = -1e30
# Key slots per block of decode_attention: the Engine's kv bucket
# (serve/engine.py, Engine.KV_BUCKET) is a multiple of it, so a decode
# chunk reads whole blocks.
DECODE_KV_BLOCK = 512
# The most queries per row decode_attention takes: a speculative verify
# window of spec_k + 1 positions (the Engine's spec_k < 16).
DECODE_MAX_QUERIES = 16
# Query rows per kernel query tile (one warpgroup): the GQA-packed [G, sc]
# rows, sc = floor(64 / G) positions (1 for G > 64, the tile then holding 64
# heads of one position); rows G * sc .. 63 are idle.
_FLASH_ROWS = 64


def _flash_sc(g: int) -> int:
    """Positions per kernel query tile for a GQA group of ``g`` heads."""
    return max(1, _FLASH_ROWS // g)


def _flash_tile(d: int) -> int:
    """Cache slots per kernel key tile, which the plain version's key chunks
    mirror: 64, or 32 at D = 256 (the kernel's registers)."""
    return 32 if d == 256 else 64


def _flash_head_dim(d: int) -> bool:
    """The head sizes kernel C takes: the TPU kernel's."""
    return d == 64 or d % 128 == 0

_KERNEL = Kernel(
    "flash_attention", "flash_attn", "flash_attention_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4
    + [ctypes.c_int] * 2 + [ctypes.c_float],
)
_INT8_KERNEL = Kernel(
    "flash_attention_int8", "flash_attn", "flash_attention_int8",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
    + [ctypes.c_int] * 2 + [ctypes.c_float],
)


def _visibility(t_ids, positions, seq_lens, sliding_window, q_seg=None, k_seg=None):
    """Bool [B, S, C]: key slots ``t_ids`` [C] visible to ``positions``
    [B, S]; with segment ids, only where ``q_seg`` [B, S] equals ``k_seg``
    [B, C]."""
    t = t_ids[None, None, :]
    p = positions[:, :, None]
    vis = (t <= p) & (t < seq_lens[:, None, None])
    if sliding_window is not None:
        vis = vis & (t > p - sliding_window)
    if q_seg is not None:
        vis = vis & (q_seg[:, :, None] == k_seg[:, None, :])
    return vis


def _softcap(scores, cap: Optional[float]):
    """``tanh(scores / cap) * cap``; the scores themselves when ``cap`` is None."""
    return scores if cap is None else torch.tanh(scores / cap) * cap


def _int8_factor(kv_scale):
    """[B, KV, C] absmax scales -> the [B, KV, 1, 1, C] factor scale / 127."""
    return (kv_scale * (1.0 / 127.0))[:, :, None, None, :]


def _check_segments(segment_ids, s, t_max):
    if segment_ids is not None and t_max != s:
        raise ValueError("segment_ids requires self-attention (S == T)")


def naive_attention(
    q, k, v, positions, seq_lens, *, scale: float, sliding_window: Optional[int] = None,
    k_scale=None, v_scale=None, segment_ids=None, logit_softcap: Optional[float] = None,
):
    """q [B, H, S, D], k/v [B, KV, T, D] (bf16, or int8 with k_scale/v_scale
    [B, KV, T]), positions [B, S], seq_lens [B], segment_ids [B, S]."""
    b, nh, s, d = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    _check_segments(segment_ids, s, t_max)
    qg = q.reshape(b, nkv, nh // nkv, s, d).float()
    scores = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    if k_scale is not None:
        scores = scores * _int8_factor(k_scale)
    scores = _softcap(scores, logit_softcap)
    t_ids = torch.arange(t_max, device=q.device)
    vis = _visibility(t_ids, positions, seq_lens, sliding_window, segment_ids, segment_ids)
    scores = torch.where(vis[:, None, None], scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * _int8_factor(v_scale)
    probs = probs.to(q.dtype).float()
    out = torch.matmul(probs, v.float()[:, :, None])
    return out.reshape(b, nh, s, d).to(q.dtype)


def decode_attention(
    q, k, v, positions, seq_lens, *, scale: float, sliding_window: Optional[int] = None,
    k_scale=None, v_scale=None, kv_len: Optional[int] = None, logit_softcap: Optional[float] = None,
):
    """Decode attention: q [B, H, S, D] with S <= ``DECODE_MAX_QUERIES``
    queries per row (one in decode, a verify window of consecutive
    positions in speculative decoding), k/v [B, KV, T, D] as in
    :func:`naive_attention`, reading the key blocks ``[t0, t0 +
    DECODE_KV_BLOCK)`` (cut at T) for ``t0 < kv_len``.  One fp32 copy of
    each block's K and V serves every query of the block's rows: the G
    heads of a KV head and the S positions are the rows of one product.

    Each block's scores, sums and P.V product are computed with the same
    shapes whatever ``kv_len``; the softmax takes the maximum over every
    block read (exact in any order), and a block wholly past a query's
    position adds exact zeros to that query's sums.  So a row's output is
    a function of its queries and the cache up to its own positions: it
    does not depend on ``kv_len``, and so not on its batchmates' positions
    or the decode chunk it runs in.  No host read.  The mask's bias is
    added after the softcap: capped, a masked slot would be visible.

    On CUDA tensors the layer's device markers (``utils/trace.py``) come
    first and last on the stream, in eager steps and captured graphs
    alike, so a profiler shows this layer's device time between them.  They
    belong to the layer, not to its kernels: any later implementation of
    decode attention (a fused kernel, say) keeps them around itself."""
    b, nh, s, d = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    if not 1 <= s <= DECODE_MAX_QUERIES:
        raise ValueError(f"decode_attention takes 1 to {DECODE_MAX_QUERIES} queries per row, got S={s}")
    trace.mark_decode_attn("begin", q)
    kv_len = t_max if kv_len is None else min(kv_len, t_max)
    bk, g = b * nkv, nh // nkv
    qg = q.reshape(bk, g * s, d).float()  # rows (head of the group, position)
    block = DECODE_KV_BLOCK
    read = min(-(-kv_len // block) * block, t_max)
    t_ids = torch.arange(read, device=q.device)
    vis = _visibility(t_ids, positions, seq_lens, sliding_window)  # [B, S, read]
    # One bias row per query row; with one query it broadcasts over the heads.
    bias = torch.where(vis, 0.0, _NEG)[:, None, None].expand(b, nkv, g if s > 1 else 1, s, read)
    bias = bias.reshape(bk, -1, read)
    scores, m = [], None
    for t0 in range(0, read, block):
        t1 = min(t0 + block, t_max)
        kc = k[:, :, t0:t1].float().reshape(bk, t1 - t0, d)
        if k_scale is None and logit_softcap is None:
            sc = torch.baddbmm(bias[:, :, t0:t1], qg, kc.transpose(1, 2), alpha=scale)
        else:
            factor = scale if k_scale is None else (k_scale[:, :, t0:t1] * (scale / 127.0)).reshape(bk, 1, t1 - t0)
            sc = _softcap(torch.bmm(qg, kc.transpose(1, 2)) * factor, logit_softcap) + bias[:, :, t0:t1]
        top = sc.amax(dim=-1, keepdim=True)
        m = top if m is None else torch.maximum(m, top)
        scores.append(sc)
    l = o = None
    for t0, sc in zip(range(0, read, block), scores):
        t1 = min(t0 + block, t_max)
        p = torch.exp(sc - m)
        part = p.sum(dim=-1, keepdim=True)
        l = part if l is None else l + part
        if v_scale is not None:
            p = p * (v_scale[:, :, t0:t1] * (1.0 / 127.0)).reshape(bk, 1, t1 - t0)
        pv = torch.bmm(p.to(q.dtype).float(), v[:, :, t0:t1].float().reshape(bk, t1 - t0, d))
        o = pv if o is None else o + pv
    out = (o / l).reshape(b, nh, s, d).to(q.dtype)
    trace.mark_decode_attn("end", q)
    return out


def chunked_attention(
    q, k, v, positions, seq_lens, *, scale: float, sliding_window: Optional[int] = None,
    k_scale=None, v_scale=None, q_chunk: int = 512, kv_chunk: int = 512, segment_ids=None,
    logit_softcap: Optional[float] = None,
):
    """Streaming softmax over (query chunk, key chunk) pairs; key chunks a
    query chunk cannot see are skipped (one host read of the chunk's
    position range per query chunk)."""
    b, nh, s, d = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    _check_segments(segment_ids, s, t_max)
    g = nh // nkv
    qg = q.reshape(b, nkv, g, s, d)
    outs = []
    for s0 in range(0, s, q_chunk):
        qt = qg[:, :, :, s0 : s0 + q_chunk].float()
        pos_t = positions[:, s0 : s0 + q_chunk]
        seg_t = None if segment_ids is None else segment_ids[:, s0 : s0 + q_chunk]
        max_pos, min_pos = int(pos_t.max()), int(pos_t.min())
        sc = qt.shape[3]
        m = torch.full((b, nkv, g, sc), _NEG, device=q.device)
        l = torch.zeros((b, nkv, g, sc), device=q.device)
        o = torch.zeros((b, nkv, g, sc, d), device=q.device)
        for t0 in range(0, t_max, kv_chunk):
            if t0 > max_pos or (
                sliding_window is not None and t0 + kv_chunk - 1 <= min_pos - sliding_window
            ):
                continue  # wholly invisible: contributes nothing
            kc = k[:, :, t0 : t0 + kv_chunk].float()
            vc = v[:, :, t0 : t0 + kv_chunk]
            sct = torch.matmul(qt, kc[:, :, None].transpose(-1, -2)) * scale
            if k_scale is not None:
                sct = sct * _int8_factor(k_scale[:, :, t0 : t0 + kv_chunk])
            sct = _softcap(sct, logit_softcap)
            t_ids = torch.arange(t0, t0 + kc.shape[2], device=q.device)
            seg_c = None if segment_ids is None else segment_ids[:, t0 : t0 + kv_chunk]
            vis = _visibility(t_ids, pos_t, seq_lens, sliding_window, seg_t, seg_c)
            sct = torch.where(vis[:, None, None], sct, torch.full_like(sct, _NEG))
            m_new = torch.maximum(m, sct.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sct - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            if v_scale is not None:
                p = p * _int8_factor(v_scale[:, :, t0 : t0 + kv_chunk])
            o = o * alpha[..., None] + torch.matmul(p.to(q.dtype).float(), vc.float()[:, :, None])
            m = m_new
        outs.append((o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, nh, s, d)


def _flash_plain(q, k, v, pos0, seq_lens, scale, sliding_window=None, k_scale=None, v_scale=None):
    """The plain version of kernel C: the same online softmax over the
    kernel's key tiles (:func:`_flash_tile`), for all query rows at once.
    Any shape.  pos0 [B]."""
    s, d = q.shape[2], q.shape[3]
    positions = pos0[:, None] + torch.arange(s, device=q.device)[None, :]
    return chunked_attention(q, k, v, positions, seq_lens, scale=scale, sliding_window=sliding_window,
                             k_scale=k_scale, v_scale=v_scale, q_chunk=s, kv_chunk=_flash_tile(d))


def _check_scale_plane(sp, k) -> None:
    if sp.dtype != torch.float32 or sp.shape != k.shape[:3] or sp.stride(2) != 1 or sp.device != k.device:
        raise ValueError(f"int8 KV scales must be fp32 {tuple(k.shape[:3])} with contiguous slots, on k's device")


def _flash_kernel(q, k, v, pos0, seq_lens, scale, sliding_window=None, k_scale=None, v_scale=None):
    """Launch kernel C: q bf16 [B, H, S, D] contiguous; k/v bf16, or int8
    with fp32 scale planes k_scale/v_scale [B, KV, T], [B, KV, T, D] with
    contiguous rows (views of the cache are read in place); pos0,
    seq_lens [B]."""
    b, nh, s, d = q.shape
    nkv, t_max = k.shape[1], k.shape[2]
    int8_kv = k_scale is not None
    kv_dtype = torch.int8 if int8_kv else torch.bfloat16
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError("kernel C takes bf16 q and bf16 k, v, or int8 k, v with k_scale and v_scale")
    if not _flash_head_dim(d) or nh % nkv:
        raise ValueError(f"kernel C needs D = 64 or a multiple of 128 and KV | H; got D={d}, H={nh}, KV={nkv}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)} / {tuple(v.shape)}")
    if k.stride(3) != 1 or k.stride(2) != d or v.stride(3) != 1 or v.stride(2) != d:
        raise ValueError("k and v need contiguous [T, D] rows")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    q = q.contiguous()
    pos0 = pos0.to(device=q.device, dtype=torch.int32).contiguous()
    lens = seq_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    tail = (_flash_sc(nh // nkv), int(sliding_window or 0), float(scale))
    if int8_kv:
        _check_scale_plane(k_scale, k)
        _check_scale_plane(v_scale, v)
        _INT8_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                     out.data_ptr(), pos0.data_ptr(), lens.data_ptr(), b, nh, nkv, s, t_max, d,
                     k.stride(0), k.stride(1), v.stride(0), v.stride(1), k_scale.stride(0),
                     k_scale.stride(1), v_scale.stride(0), v_scale.stride(1), *tail)
    else:
        _KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), pos0.data_ptr(), lens.data_ptr(),
                b, nh, nkv, s, t_max, d, k.stride(0), k.stride(1), v.stride(0), v.stride(1), *tail)
    return out


def flash_attention(
    q, k, v, positions, seq_lens, *, scale: float, sliding_window: Optional[int] = None,
    k_scale=None, v_scale=None,
):
    """Prefill flash attention; ``positions[b]`` MUST be ``pos0_b + arange(S)``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 KV needs both k_scale and v_scale")
    fn = _flash_kernel if env.use_kernel(q) else _flash_plain
    return fn(q, k, v, positions[:, 0], seq_lens, scale, sliding_window, k_scale, v_scale)


# Take the chunked or flash path once the naive score tensor (B*H*S*T fp32)
# would reach 512 MB.  The threshold is the JAX package's, not re-derived
# for the H100.
_CHUNKED_MIN_SCORE_ELEMS = 1 << 27


def _flash_eligible(q, s: int, d: int) -> bool:
    """Kernel C applies: the kernel backend for ``q``'s device (``auto``: a
    CUDA tensor; ``utils/env.py``), a bf16 tensor, a head size the kernel
    takes (D = 64 or any multiple of 128, the TPU kernel's condition; any
    GQA group) and enough rows."""
    return env.backend(q.device) == "pallas" and q.dtype == torch.bfloat16 and _flash_head_dim(d) and s >= 256


def attention(
    q, k, v, positions, seq_lens, *, scale, sliding_window=None,
    k_scale=None, v_scale=None, kv_len: Optional[int] = None,
    differentiable: bool = False, segment_ids=None, logit_softcap: Optional[float] = None,
    decode: bool = False,
):
    """Dispatching entry point; see the module docstring for the contract
    (``positions[b]`` must be ``pos0_b + arange(S)``).  ``kv_len`` is an optional host-side
    bound: no query sees a slot at or past it, so the plain paths read only
    ``k[:, :, :kv_len]`` (the JAX package's chunk-skipping decode path reads
    only the live prefix the same way; here the caller knows its length).
    One query per row is decode, and so are the rows of a speculative
    verify window (``decode``, S <= ``DECODE_MAX_QUERIES``):
    :func:`decode_attention`, whose output does not depend on ``kv_len``.  The dispatch thresholds use the full
    cache length, as the JAX package's do.  ``differentiable=True``
    (training), ``segment_ids`` (packed rows) and ``logit_softcap`` keep to
    the plain paths."""
    b, nh, s, d = q.shape
    t_max = k.shape[2]
    if (s == 1 or decode) and not differentiable and segment_ids is None:
        return decode_attention(q, k, v, positions, seq_lens, scale=scale, sliding_window=sliding_window,
                                k_scale=k_scale, v_scale=v_scale, kv_len=kv_len, logit_softcap=logit_softcap)
    opts = dict(k_scale=k_scale, v_scale=v_scale, segment_ids=segment_ids, logit_softcap=logit_softcap)
    large = s > 1 and b * nh * s * t_max >= _CHUNKED_MIN_SCORE_ELEMS
    plain_only = differentiable or segment_ids is not None or logit_softcap is not None
    if large and not plain_only and _flash_eligible(q, s, d):
        return flash_attention(
            q, k, v, positions, seq_lens, scale=scale, sliding_window=sliding_window,
            k_scale=k_scale, v_scale=v_scale,
        )
    if kv_len is not None and kv_len < t_max:
        k, v = k[:, :, :kv_len], v[:, :, :kv_len]
        for n in ("k_scale", "v_scale"):
            opts[n] = None if opts[n] is None else opts[n][:, :, :kv_len]
    if large:
        return chunked_attention(
            q, k, v, positions, seq_lens, scale=scale, sliding_window=sliding_window,
            q_chunk=min(512, s), **opts,
        )
    return naive_attention(
        q, k, v, positions, seq_lens, scale=scale, sliding_window=sliding_window, **opts
    )
