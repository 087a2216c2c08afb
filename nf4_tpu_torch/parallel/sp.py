"""Sequence parallelism: ring-attention prefill over a process group.

The counterpart of the JAX package's ``parallel/sp.py``.  A prompt's
sequence axis is split over the ranks of a ring, each rank holding a
contiguous slice of the prompt and the whole weights: every sublayer but
attention runs on the rank's own tokens (norms, projections and MLPs are
pointwise over the sequence), and attention, the one op that couples
positions, passes the ranks' K/V blocks around the ring, one hop a step,
while an fp32 streaming softmax merges each block into the rank's queries
(the online (max, normalizer, accumulator) of ``ops.attention.
chunked_attention``, over ring steps instead of key chunks; the
probabilities stay fp32 through the product with V, where the JAX ring and
the cache paths round them to bf16 first, so the ring's result is the exact
streaming softmax's up to fp32 association).  A block that
lies wholly in the future of a rank's queries, or wholly behind their
window, is skipped; every hop still runs on every rank, so the
collectives of all ranks meet.  An int8 KV cache rides the ring as int8
codes and per-token scales, folded into the scores and the probabilities
as the cache paths fold them.  The attention is plain torch, as the JAX
package's is XLA code: no kernel, and no ``[S, S]`` score matrix (each
block's scores are taken a chunk of queries at a time).

The ring is a :class:`Ring`: a process group whose ranks hold the same
weights.  :func:`ring_of` makes it from a ``parallel.mesh.Mesh`` of tp = 1,
over its dp axis (the JAX package composes sp with data parallelism and
leaves tp x sp for later; a tp > 1 mesh raises).

A hop is built from ``all_reduce``, the one collective that gloo takes for
CUDA tensors as well as nccl: each rank writes its block into its
successor's place of a zero-filled ``[n, ...]`` buffer and the buffers are
summed (adding zeros is exact), so a hop moves n times a block's bytes.
On gloo with ranks sharing a card, those bytes go through the host: the
hops' times there are the host's, not the ring's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models.llama import LlamaConfig, LlamaParams, forward, init_kv_cache
from ..ops.attention import _NEG, _int8_factor, _softcap, _visibility
from .mesh import Mesh
from .tp import _sum

__all__ = ["Ring", "ring_of", "ring_attention", "sp_prefill"]

# Queries per chunk of a block's scores: [B, KV, G, Q_CHUNK, Sl] fp32.
Q_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ranks of a sequence-parallel ring: ``group`` (a process group of
    ``size`` ranks, this one ``rank`` in it), and the ``mesh`` whose
    ``stats`` count its collectives."""

    mesh: Mesh
    group: Any
    size: int
    rank: int


def ring_of(mesh: Mesh) -> Ring:
    """The ring over the data-parallel axis of a tp = 1 mesh (each rank holds
    the whole model); raises on a tensor-parallel mesh (tp x sp is not
    supported, as in the JAX package)."""
    if mesh.tp > 1:
        raise ValueError(f"sequence parallelism runs over ranks that hold the whole model; the mesh has tp={mesh.tp} "
                         "(tp x sp is not supported)")
    return Ring(mesh=mesh, group=mesh.dp_group, size=mesh.dp, rank=mesh.dp_rank)


def _hop(ring: Ring, t: torch.Tensor) -> torch.Tensor:
    """``t`` of the previous rank of the ring (rank r receives rank r - 1's),
    through the zero-filled sum over the ring (module docstring)."""
    buf = t.new_zeros((ring.size, *t.shape))
    buf[(ring.rank + 1) % ring.size] = t
    return _sum(buf, ring.mesh, ring.group)[ring.rank]


def ring_attention(q, k, v, positions, seq_lens, *, ring: Ring, scale: float, sliding_window: Optional[int] = None,
                   k_scale=None, v_scale=None, logit_softcap: Optional[float] = None, q_pos_range=None):
    """Attention of this rank's queries q [B, H, Sl, D] (global
    ``positions`` [B, Sl]) over every rank's fresh keys and values, k and v
    [B, KV, Sl, D] (the cache's dtype, or int8 codes with fp32 ``k_scale``
    / ``v_scale`` [B, KV, Sl]) passed around the ring; rank j's keys hold
    positions ``j Sl .. (j + 1) Sl - 1``.  ``seq_lens`` [B] the visible
    length of each row.  ``q_pos_range`` (the host's (min, max) of the
    query positions, read from ``positions`` when None) decides which
    blocks are skipped.  Returns [B, H, Sl, D] in q's dtype."""
    b, nh, sl, d = q.shape
    nkv = k.shape[1]
    g = nh // nkv
    qg = q.reshape(b, nkv, g, sl, d)
    lo, hi = q_pos_range if q_pos_range is not None else (int(positions.min()), int(positions.max()))
    kv = torch.stack((k, v))
    scales = None if k_scale is None else torch.stack((k_scale, v_scale))
    chunks = [(s0, min(s0 + Q_CHUNK, sl)) for s0 in range(0, sl, Q_CHUNK)]
    state = []
    for s0, s1 in chunks:
        shape = (b, nkv, g, s1 - s0)
        state.append([torch.full(shape, _NEG, device=q.device), torch.zeros(shape, device=q.device),
                      torch.zeros((*shape, d), device=q.device)])
    for i in range(ring.size):
        # After i hops the resident block came from rank (rank - i).
        t0 = ((ring.rank - i) % ring.size) * sl
        relevant = t0 <= hi and (sliding_window is None or t0 + sl - 1 > lo - sliding_window)
        if relevant:
            t_ids = torch.arange(t0, t0 + sl, device=q.device)
            kc, vc = kv[0].float()[:, :, None], kv[1]
            for (s0, s1), st in zip(chunks, state):
                m, l, o = st
                sc = torch.matmul(qg[:, :, :, s0:s1].float(), kc.transpose(-1, -2)) * scale
                if scales is not None:
                    sc = sc * _int8_factor(scales[0])
                sc = _softcap(sc, logit_softcap)
                vis = _visibility(t_ids, positions[:, s0:s1], seq_lens, sliding_window)
                sc = torch.where(vis[:, None, None], sc, torch.full_like(sc, _NEG))
                m_new = torch.maximum(m, sc.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(dim=-1)
                if scales is not None:
                    p = p * _int8_factor(scales[1])
                o = o * alpha[..., None] + torch.matmul(p, vc.float()[:, :, None])
                st[:] = m_new, l, o
        if i < ring.size - 1:  # every rank hops, whether or not it used the block
            kv = _hop(ring, kv)
            if scales is not None:
                scales = _hop(ring, scales)
    outs = [(o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype) for _, l, o in state]
    return torch.cat(outs, dim=3).reshape(b, nh, sl, d)


def sp_prefill(params: LlamaParams, cfg: LlamaConfig, tokens: torch.Tensor, ring: Ring,
               seq_lens: Optional[torch.Tensor] = None):
    """Sequence-parallel prefill of the whole prompts ``tokens`` [B, S] (the
    same on every rank of ``ring``; S a multiple of the ring's size): this
    rank runs its slice of S, attention through :func:`ring_attention`.
    ``seq_lens`` [B] allows right-padded rows: row i attends to its first
    ``seq_lens[i]`` tokens only, and its logits are those of position
    ``seq_lens[i] - 1``, from whichever rank holds it, summed over the
    ring.  Default: every row is S tokens.

    Returns ``(last-token logits [B, V] fp32, cache, seq_lens)``, the same
    on every rank: the cache in the usual layout ([L, B, KV, max_seq_len,
    D], the prompt's slots filled, each rank's slice summed into a
    zero-filled buffer over the ring), so decoding goes on through the
    ordinary paths."""
    b, s = tokens.shape
    n = ring.size
    if s % n:
        raise ValueError(f"prompt length {s} must divide over {n} sequence-parallel ranks")
    if s > cfg.max_seq_len:
        raise ValueError(f"prompt length {s} > max_seq_len {cfg.max_seq_len}")
    dev = tokens.device
    sl = s // n
    if seq_lens is None:
        seq_lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    else:
        seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=dev)
        if seq_lens.shape != (b,):
            raise ValueError("seq_lens must be [B]")
    offset = ring.rank * sl
    local = torch.arange(sl, dtype=torch.int32, device=dev)
    positions = (offset + local).expand(b, sl)
    cache = init_kv_cache(dataclasses.replace(cfg, max_seq_len=sl), b, device=dev)
    logits, cache = forward(params, cfg, tokens[:, offset : offset + sl], cache, positions, seq_lens, last_only=True,
                            ring_axis=ring, cache_positions=local.expand(b, sl))
    owner = torch.div(seq_lens - 1, sl, rounding_mode="floor") == ring.rank
    logits = _sum(torch.where(owner[:, None], logits.float(), 0.0), ring.mesh, ring.group)
    full = init_kv_cache(cfg, b, device=dev)
    for name, t in cache.planes().items():
        prompt = t.new_zeros((*t.shape[:3], s, *t.shape[4:]))
        prompt[:, :, :, offset : offset + sl] = t
        getattr(full, name)[:, :, :, :s] = _sum(prompt, ring.mesh, ring.group)
    return logits, full, seq_lens
