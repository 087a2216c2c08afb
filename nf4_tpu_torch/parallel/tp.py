"""Tensor parallelism over packed weights, one rank per process.

The counterpart of the JAX package's ``parallel/tp.py`` (Megatron-style):

* Column-parallel (out-features sharded, the lane axis of the packed
  layout): the fused ``wqkv`` and ``w_gateup`` (and ``qkv_bias``), whose
  rows are interleaved per shard at pack time (``models.llama.fuse_rows``)
  so that each rank's contiguous slice is its own ``[q; k; v]`` (``[gate;
  up]``); the lm_head by vocabulary rows.
* Row-parallel (in-features sharded, whole K chunks of a ``shards > 1``
  packed weight): ``wo`` and ``w_down``, each followed by a sum over the
  ranks (``all_reduce``): one per attention block and one per MLP.
* The KV cache holds the rank's ``num_kv_heads / tp`` heads: attention
  needs no collective.
* MoE: "tensor" mode shards each expert as the dense MLP; "expert" mode
  gives each rank ``num_experts / tp`` whole experts.  Norms, the router
  and the embedding are whole on every rank.
* Data parallelism (the mesh's ``dp`` axis, the JAX package's
  ``data_axis``): the batch splits contiguously over the dp groups, dp
  group d holding rows ``[d B / dp, (d + 1) B / dp)`` (:func:`dp_rows`)
  and their cache rows only (:func:`init_sharded_kv_cache`); the weights
  are whole on each dp group.  The entry points take and return the whole
  batch, as the JAX package's global arrays: each rank runs its rows and
  the rows' logits are gathered over ``mesh.dp_group``
  (:func:`gather_rows`).

Where the JAX package keeps every leaf global and lets ``shard_map`` hand
each device its slice, here :func:`localize_params` cuts this rank's slice
out and makes it contiguous (the kernels take no strided weight), so a
rank holds only its share.  The vocabulary-sliced logits are gathered to
full rows before sampling (:func:`gather_vocab`), so every rank samples
from the same bits and picks the same token with no broadcast (the
sampler's noise is a hash of the seed and the position).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.llama import KVCache, LlamaConfig, LlamaParams, forward, init_kv_cache
from ..nf4.format import PackedNF4, interleave_perm, permute_out_features, rechunk_shards
from ..ops.int8_serve import PackedInt8
from .mesh import Mesh

__all__ = [
    "tp_local_config",
    "localize_params",
    "local_slice",
    "local_meta",
    "shard_axis",
    "shard_kinds",
    "is_local",
    "all_reduce",
    "dp_sum",
    "dp_rows",
    "gather_rows",
    "gather_vocab",
    "tp_hooks",
    "sum_over_tp",
    "train_hooks",
    "init_sharded_kv_cache",
    "repack_tp",
    "tp_forward",
    "tp_prefill",
    "tp_decode_step",
]


def tp_local_config(cfg: LlamaConfig, tp: int, rank: int = 0) -> LlamaConfig:
    """The architecture of one rank's slice: heads, KV heads and the MLP
    width divided by ``tp``, ``tp_shards`` 1 (the slice is one shard); in
    MoE "expert" mode the expert count divided instead and ``ep_rank`` set
    to ``rank``.  Raises where the degree does not divide the model or
    does not match the pack (``repack_tp`` moves a checkpoint between
    degrees)."""
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} % tp {tp} != 0")
    if cfg.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} % tp {tp} != 0 (KV-head replication is not supported)")
    if cfg.tp_shards != tp:
        raise ValueError(f"params were packed for tp_shards={cfg.tp_shards} but the mesh has tp={tp}; fused "
                         "column-parallel weights are interleaved per shard, so the degrees must match "
                         "(quantize with the right tp_shards, or repack_tp the checkpoint)")
    expert_mode = cfg.num_experts > 1 and cfg.moe_shard == "expert"
    moe_fields = {}
    if expert_mode:
        if cfg.num_experts % tp:
            raise ValueError(f"num_experts {cfg.num_experts} % tp {tp} != 0 (moe_shard='expert' needs a whole "
                             "number of experts per rank)")
        moe_fields = dict(num_experts=cfg.num_experts // tp, ep_rank=rank)
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size if expert_mode else cfg.intermediate_size // tp,
        tp_shards=1,
        **moe_fields,
    )


def shard_kinds(cfg: LlamaConfig) -> dict:
    """How each sharded projection splits: "col", "row" or "expert"."""
    expert = cfg.num_experts > 1 and cfg.moe_shard == "expert"
    return {"wqkv": "col", "wo": "row", "w_gateup": "expert" if expert else "col",
            "w_down": "expert" if expert else "row"}


# The axis each kind of sharding cuts, from the end, for a packed tensor
# (packed bytes, int8 values, scales: [.., K rows, out lanes]) and for a
# dense weight ([.., out, in]); an expert-stacked weight is [.., E, ., .].
_AXES = {("col", True): -1, ("col", False): -2, ("row", True): -2, ("row", False): -1,
         ("expert", True): -3, ("expert", False): -3}


def local_slice(t, axis: int, tp: int, rank: int):
    """Rank ``rank``'s ``1 / tp`` of ``t`` along ``axis`` (negative, from
    the end, so stacked leading axes are kept whole).  ``t`` is anything
    sliceable with a ``shape``: a tensor, or a checkpoint's lazily read
    entry."""
    size = t.shape[axis]
    if size % tp:
        raise ValueError(f"an axis of {size} does not split over tp={tp}")
    step = size // tp
    return t[(slice(None),) * (len(t.shape) + axis) + (slice(rank * step, (rank + 1) * step),)]


def shard_axis(kind: str, packed: bool) -> int:
    """The axis (from the end) that ``kind`` sharding cuts in a packed
    weight's tensors or, ``packed=False``, a dense weight."""
    return _AXES[kind, packed]


def local_meta(w, kind: str, tp: int) -> dict:
    """The metadata of a packed weight's slice (``shape``, ``padded_shape``,
    ``shards``; the JAX package's ``_localize_weight``), after checking
    that it shards; ``w`` needs only those three fields."""
    m, n = w.shape
    m_pad, n_pad = w.padded_shape
    if kind == "expert":
        return {}
    if kind == "col":
        # Shard s's rows begin at s * m / tp and its lanes at s * m_pad / tp:
        # they meet only where no padding lane lies in between.
        if m % tp or m_pad % (tp * 128) or m != m_pad:
            raise ValueError(f"out_features {m} (padded {m_pad}) are not column-shardable over {tp}: each shard "
                             "needs whole 128-lane tiles and no padding")
        return dict(shape=(m // tp, n), padded_shape=(m_pad // tp, n_pad))
    if w.shards != tp:
        raise ValueError(f"a row-parallel weight must be packed with shards={tp}, got {w.shards} (set "
                         "LlamaConfig.tp_shards before quantizing, or repack_tp)")
    return dict(shape=(m, n // tp), padded_shape=(m_pad, n_pad // tp), shards=1)


def _localize_weight(w, kind: str, tp: int, rank: int):
    """Rank ``rank``'s slice of one weight, each tensor a contiguous copy."""
    if isinstance(w, torch.Tensor):
        return local_slice(w, _AXES[kind, False], tp, rank).contiguous()
    data = "values" if isinstance(w, PackedInt8) else "packed"
    meta = local_meta(w, kind, tp)
    axis = _AXES[kind, True]
    return dataclasses.replace(w, **{data: local_slice(getattr(w, data), axis, tp, rank).contiguous()},
                               scales=local_slice(w.scales, axis, tp, rank).contiguous(), **meta)


def is_local(params: LlamaParams, cfg: LlamaConfig, tp: int) -> bool:
    """Are ``params`` already one rank's slice (``localize_params``,
    ``load_packed_sharded``) of a model of config ``cfg``, rather than the
    whole model?  Read from ``wo``'s in-features, which a slice divides."""
    wo = params.layers[0].wo
    n = wo.shape[1] if isinstance(wo, (PackedNF4, PackedInt8)) else wo.shape[-1]
    return tp > 1 and n == cfg.q_dim // tp


def localize_params(params: LlamaParams, cfg: LlamaConfig, tp: int, rank: int) -> LlamaParams:
    """Rank ``rank``'s slice of the whole-model ``params`` (packed for
    ``cfg.tp_shards == tp``), every sharded tensor a contiguous copy with
    its metadata rewritten for the slice; the embedding, the norms and the
    router are the same tensors (whole on every rank)."""
    tp_local_config(cfg, tp, rank)  # the same refusals
    kinds = shard_kinds(cfg)
    layers = []
    for lp in params.layers:
        fields = {name: _localize_weight(getattr(lp, name), kind, tp, rank) for name, kind in kinds.items()}
        if lp.qkv_bias is not None:
            fields["qkv_bias"] = local_slice(lp.qkv_bias, -1, tp, rank).contiguous()
        layers.append(dataclasses.replace(lp, **fields))
    return dataclasses.replace(params, layers=layers, lm_head=_localize_weight(params.lm_head, "col", tp, rank))


def _sync(t: torch.Tensor) -> float:
    """The host clock once the device's queued work is done."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _sum(t: torch.Tensor, mesh: Mesh, group) -> torch.Tensor:
    """``torch.distributed.all_reduce`` of ``t`` over ``group``, counted in
    ``mesh.stats``; in place on ``t`` when it is contiguous."""
    t = t.contiguous()
    t0 = _sync(t) if mesh.timed else None
    dist.all_reduce(t, group=group)
    mesh.stats["calls"] += 1
    mesh.stats["bytes"] += t.numel() * t.element_size()
    if t0 is not None:
        mesh.stats["seconds"] += _sync(t) - t0
    return t


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the mesh's tensor-parallel axis:
    ``torch.distributed.all_reduce`` over ``mesh.tp_group``, every rank
    receiving the same bits.  In place on ``t`` when it is contiguous."""
    return _sum(t, mesh, mesh.tp_group)


def dp_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's data-parallel axis
    (``mesh.dp_group``), the same bits on every rank; in place on ``t``
    when it is contiguous."""
    return _sum(t, mesh, mesh.dp_group)


def dp_rows(batch_size: int, mesh: Mesh) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a batch of ``batch_size`` that this rank's
    data-parallel group holds: the batch split contiguously over ``dp``, as
    the JAX package shards it (``P(data_axis)``).  Raises where ``dp`` does
    not divide the batch."""
    if batch_size % mesh.dp:
        raise ValueError(f"batch_size {batch_size} must be a multiple of the data-parallel degree {mesh.dp}")
    n = batch_size // mesh.dp
    return mesh.dp_rank * n, (mesh.dp_rank + 1) * n


def gather_rows(t: torch.Tensor, mesh: Mesh, batch_size: int) -> torch.Tensor:
    """The whole batch [batch_size, ...] from each data-parallel group's
    rows (:func:`dp_rows`), the same bits on every rank: each rank writes
    its rows into a zero-filled buffer and the buffers are summed over
    ``mesh.dp_group`` (:func:`gather_vocab`'s route, which gloo takes for
    CUDA tensors).  ``t`` itself at dp = 1."""
    if mesh.dp == 1:
        return t
    lo, hi = dp_rows(batch_size, mesh)
    full = t.new_zeros((batch_size, *t.shape[1:]))
    full[lo:hi] = t
    return dp_sum(full, mesh)


def gather_vocab(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Full logit rows [..., V] from each rank's vocabulary slice [..., V /
    tp] (rank r's at ``r * V / tp``), through ``torch.distributed.
    all_reduce`` over ``mesh.tp_group``: each rank writes its slice into a
    zero-filled full-width buffer and the buffers are summed (adding zeros
    is exact).  gloo takes CUDA tensors for ``all_reduce`` but not for
    ``all_gather``, so one route serves both backends."""
    vl = logits.shape[-1]
    full = logits.new_zeros((*logits.shape[:-1], vl * mesh.tp))
    full[..., mesh.tp_rank * vl : (mesh.tp_rank + 1) * vl] = logits
    return all_reduce(full, mesh)


def tp_hooks(mesh: Mesh) -> dict:
    """``forward``'s tensor-parallel keywords for this rank: ``reduce_fn``
    (:func:`all_reduce`) and ``gather_fn`` (:func:`gather_vocab`); none at
    tp = 1 (a data-parallel mesh), where the rank holds the whole model."""
    if mesh.tp == 1:
        return {}
    return dict(reduce_fn=functools.partial(all_reduce, mesh=mesh),
                gather_fn=functools.partial(gather_vocab, mesh=mesh))


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``t`` over ``group`` (a row-parallel product's partial
    sums, a loss's partial sums); its gradient passes through unchanged:
    every rank's output is the same sum, and every rank's loss gradient is
    the whole gradient of that sum, which is each partial's gradient."""

    @staticmethod
    def forward(ctx, t, mesh, group):
        return _sum(t.clone(), mesh, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToRanks(torch.autograd.Function):
    """``t`` itself, an input every rank holds whole that feeds its
    column-parallel product; its gradient summed over ``group``: each rank
    computes only its own columns' part of it."""

    @staticmethod
    def forward(ctx, t, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.clone(), ctx.mesh, ctx.group), None, None


def sum_over_tp(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:func:`all_reduce` over the tensor-parallel group, differentiable
    (the gradient passes through unchanged)."""
    return _SumOverRanks.apply(t, mesh, mesh.tp_group)


def train_hooks(mesh: Mesh) -> dict:
    """``train_forward``'s tensor-parallel keywords for this rank, each a
    differentiable collective over ``mesh.tp_group``: ``reduce_fn``
    (:func:`sum_over_tp`) and ``copy_fn`` (the identity whose backward sums
    the gradient); none at tp = 1.  The logits stay vocabulary slices
    (``train.trainer``'s loss works on them)."""
    if mesh.tp == 1:
        return {}
    return dict(reduce_fn=functools.partial(sum_over_tp, mesh=mesh),
                copy_fn=lambda t: _CopyToRanks.apply(t, mesh, mesh.tp_group))


def init_sharded_kv_cache(cfg: LlamaConfig, batch_size: int, mesh: Mesh) -> KVCache:
    """This rank's zeroed KV cache: its data-parallel group's
    ``batch_size / dp`` rows (:func:`dp_rows`) over its ``num_kv_heads /
    tp`` heads, on the mesh's device."""
    lo, hi = dp_rows(batch_size, mesh)
    return init_kv_cache(tp_local_config(cfg, mesh.tp, mesh.tp_rank), hi - lo, device=mesh.device)


def repack_tp(params: LlamaParams, cfg: LlamaConfig, tp: int):
    """A packed model moved to another tensor-parallel degree by indexing
    alone (no dequantization, no requantization): the fused column-parallel
    weights' out-features permuted from the old interleave to the new
    (:func:`~nf4_tpu_torch.nf4.format.permute_out_features`), the
    row-parallel ones re-chunked (``rechunk_shards``).  Bit for bit what
    quantizing with ``tp_shards=tp`` gives.  Returns ``(params, cfg)`` with
    ``cfg.tp_shards = tp``.  Whole-model params only; int8-recoded weights
    raise (recode after repacking)."""
    g0 = cfg.tp_shards
    if g0 == tp:
        return params, cfg
    sizes = {"wqkv": (cfg.q_dim, cfg.kv_dim, cfg.kv_dim), "w_gateup": (cfg.intermediate_size,) * 2}

    def col_perm(field):
        """New position -> old position."""
        return np.argsort(interleave_perm(sizes[field], g0))[interleave_perm(sizes[field], tp)]

    def repack(w, field):
        if isinstance(w, PackedInt8):
            raise TypeError("repack_tp operates on 4-bit checkpoints; recode to int8 after repacking "
                            "(recode_params_int8)")
        if field in sizes:
            perm = col_perm(field)
            if isinstance(w, PackedNF4):
                return permute_out_features(w, perm)
            return w.index_select(-2, torch.as_tensor(perm, device=w.device))
        return rechunk_shards(w, tp) if isinstance(w, PackedNF4) else w

    # "expert" mode packs the experts with one group at any degree (whole
    # experts per rank): only the attention projections move.
    fields = ("wqkv", "wo") if cfg.num_experts > 1 and cfg.moe_shard == "expert" else (
        "wqkv", "wo", "w_gateup", "w_down")
    layers = []
    for lp in params.layers:
        new = {f: repack(getattr(lp, f), f) for f in fields}
        if lp.qkv_bias is not None:
            new["qkv_bias"] = lp.qkv_bias.index_select(-1, torch.as_tensor(col_perm("wqkv"), device=lp.qkv_bias.device))
        layers.append(dataclasses.replace(lp, **new))
    return dataclasses.replace(params, layers=layers), dataclasses.replace(cfg, tp_shards=tp)


def tp_forward(params_local: LlamaParams, cfg: LlamaConfig, mesh: Mesh, tokens, cache: KVCache, positions, seq_lens,
               last_only: bool = False, kv_len: Optional[int] = None):
    """One rank's forward over its slice: ``params_local`` from
    :func:`localize_params` (or ``load_packed_sharded``), ``cache`` its
    rows and heads (:func:`init_sharded_kv_cache`), ``cfg`` the whole
    model's; ``tokens``, ``positions`` and ``seq_lens`` are the whole
    batch, of which the rank runs its data-parallel group's rows
    (:func:`dp_rows`).  Reaches one ``all_reduce`` over the
    tensor-parallel group per row-parallel product and one for the logits,
    and at dp > 1 one over the data-parallel group for the rows.  Returns
    (full fp32 logits of the whole batch [B, S, V], or [B, V] with
    ``last_only``, the same on every rank; the cache, written in place)."""
    cfg_local = tp_local_config(cfg, mesh.tp, mesh.tp_rank)
    b = tokens.shape[0]
    lo, hi = dp_rows(b, mesh)
    logits, cache = forward(params_local, cfg_local, tokens[lo:hi], cache, positions[lo:hi], seq_lens[lo:hi],
                            last_only=last_only, kv_len=kv_len, **tp_hooks(mesh))
    return gather_rows(logits, mesh, b), cache


def tp_prefill(params_local: LlamaParams, cfg: LlamaConfig, mesh: Mesh, tokens, cache: Optional[KVCache] = None):
    """Full prompts [B, S] from position 0 (:func:`tp_forward`); returns
    (logits [B, S, V], this rank's cache)."""
    b, s = tokens.shape
    if cache is None:
        cache = init_sharded_kv_cache(cfg, b, mesh)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    seq_lens = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return tp_forward(params_local, cfg, mesh, tokens, cache, positions, seq_lens, kv_len=s)


def tp_decode_step(params_local: LlamaParams, cfg: LlamaConfig, mesh: Mesh, token, cache: KVCache, positions,
                   kv_len: Optional[int] = None):
    """One token per sequence (token [B] at positions [B]) through
    :func:`tp_forward`; returns (logits [B, V], this rank's cache)."""
    logits, cache = tp_forward(params_local, cfg, mesh, token[:, None], cache, positions[:, None], positions + 1,
                               kv_len=kv_len)
    return logits[:, 0], cache
