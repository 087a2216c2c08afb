"""The LoRA training step over frozen packed 4-bit weights.

The loss is next-token cross entropy through ``models.llama.train_forward``
(cache-free, differentiable attention); gradients go to the LoRA adapters
only: the packed base weights are frozen, and ``nf4_matmul``'s backward
stops at activations.

Parity with the JAX package's optax optimizers (same update math; the
float operations run in another order):

* ``optax.adamw(lr)`` is ``torch.optim.AdamW(lora.parameters(), lr,
  betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)`` (optax's defaults;
  torch's AdamW defaults to weight_decay 1e-2);
* ``optax.sgd(lr)`` is ``torch.optim.SGD(lora.parameters(), lr)``.

Over a mesh (``parallel.mesh.Mesh``, one process per rank, the JAX
package's ``make_train_step(mesh=)``):

* data parallelism: each rank takes its data-parallel group's rows of the
  batch (``parallel.tp.dp_rows``), and the loss and the adapter gradients
  are averaged over ``mesh.dp_group`` before the same optimizer step on
  every rank (a masked loss averages the groups' masked means, as the JAX
  package defines it);
* tensor parallelism, on a checkpoint packed for ``tp_shards = mesh.tp``:
  each rank holds its slice of the weights and of the adapters
  (``train.lora.shard_lora``), the forward's collectives are
  differentiable (``parallel.tp.train_hooks``), the cross entropy is
  assembled from the vocabulary slices of the logits (:func:`_tp_lm_loss`),
  and the gradients of the adapter leaves every rank holds whole are
  summed over ``mesh.tp_group``.  The result is the single-device
  gradient of the same loss.  (The JAX package's tensor-parallel step
  returns tp times it: the transpose of its forward's ``psum`` inside
  ``shard_map(check_vma=False)`` sums the gradient once more.)
* both at once, and ``accum_steps`` over either.

A ``tp_shards > 1`` checkpoint on one device, with no mesh, trains as the
JAX package's tp = 1 branch: its fused rows split by their interleave.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.llama import LlamaConfig, LlamaParams, check_supported, train_forward
from .lora import LoraParams, check_basis

__all__ = ["lm_loss", "make_train_step"]


def lm_loss(
    params: LlamaParams,
    lora: Optional[LoraParams],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int
    loss_mask: Optional[torch.Tensor] = None,  # [B, S]: weight of each TARGET token
    remat: bool = False,
    positions: Optional[torch.Tensor] = None,  # [B, S] (packed rows)
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] (packed rows)
) -> torch.Tensor:
    """Mean next-token cross entropy (fp32 scalar).

    Position ``t`` of ``loss_mask`` weights the prediction OF token ``t``
    (from position ``t-1``); position 0 is ignored.  Without a mask, all
    ``B*(S-1)`` predictions count equally.  ``positions``/``segment_ids``
    come from ``train.data.pack_sft``, whose loss mask already zeroes
    cross-segment targets."""
    logits = train_forward(
        params, cfg, tokens[:, :-1], lora=lora, remat=remat,
        positions=None if positions is None else positions[:, :-1],
        segment_ids=None if segment_ids is None else segment_ids[:, :-1],
    )
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    if loss_mask is None:
        return nll.mean()
    m = loss_mask[:, 1:].float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _tp_lm_loss(params_local, lora, cfg_local, mesh, tokens, loss_mask, remat, positions, segment_ids):
    """:func:`lm_loss` on a rank of a tensor-parallel group (the JAX
    package's ``_tp_lm_loss``): the forward over the rank's slices, whose
    logits are the rank's vocabulary slice; the log-sum-exp from a max and
    a sum over the slices, the target logit summed from its owning slice.
    Every rank returns the same loss."""
    from ..parallel.tp import all_reduce, sum_over_tp, train_hooks

    logits = train_forward(
        params_local, cfg_local, tokens[:, :-1], lora=lora, remat=remat,
        positions=None if positions is None else positions[:, :-1],
        segment_ids=None if segment_ids is None else segment_ids[:, :-1], **train_hooks(mesh),
    )
    lg = logits.float()  # [B, S-1, V / tp]
    v_local = lg.shape[-1]
    # The max over the slices, a constant of the gradient (d lse / d m = 0):
    # each rank's maxima in a zero-filled [tp, B, S-1], summed over the ranks.
    maxima = lg.new_zeros((mesh.tp, *lg.shape[:-1]))
    maxima[mesh.tp_rank] = lg.detach().amax(dim=-1)
    m = all_reduce(maxima, mesh).amax(dim=0)
    lse = torch.log(sum_over_tp(torch.exp(lg - m[..., None]).sum(dim=-1), mesh)) + m
    local_idx = tokens[:, 1:].long() - mesh.tp_rank * v_local
    in_slice = (local_idx >= 0) & (local_idx < v_local)
    picked = lg.gather(-1, local_idx.clamp(0, v_local - 1)[..., None])[..., 0]
    nll = lse - sum_over_tp(torch.where(in_slice, picked, 0.0), mesh)
    w = loss_mask[:, 1:].float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _mesh_tp(cfg: LlamaConfig, mesh) -> int:
    """The tensor-parallel degree a step trains at, after the JAX package's
    checks: the mesh's tp on a checkpoint packed for it, 1 (data
    parallelism only, the tp ranks redundant) on a ``tp_shards = 1`` one or
    with no mesh."""
    if mesh is None or cfg.tp_shards == 1 or mesh.tp == 1:
        return 1
    tp = mesh.tp
    if tp != cfg.tp_shards:
        raise ValueError(f"checkpoint tp_shards={cfg.tp_shards} but the mesh has tp={tp}: repack_tp the checkpoint "
                         "or resize the mesh")
    if cfg.vocab_size % tp:
        raise ValueError(f"vocab {cfg.vocab_size} % tp {tp} != 0 (the lm_head is vocabulary-sharded)")
    if cfg.quantize_lm_head and cfg.vocab_size % (tp * 128):
        raise ValueError(f"quantize_lm_head under tp={tp} needs vocab_size % {tp * 128} == 0 (got "
                         f"{cfg.vocab_size}) so that the packed lanes' slices are the vocabulary's")
    return tp


def make_train_step(
    cfg: LlamaConfig,
    optimizer: torch.optim.Optimizer,
    remat: bool = False,
    mesh=None,
    accum_steps: int = 1,
):
    """Build ``step(params, lora, tokens, loss_mask=None, positions=None,
    segment_ids=None) -> loss``: gradients of :func:`lm_loss` with respect
    to ``lora``, then one ``optimizer.step()``.  ``optimizer`` holds
    ``lora``'s parameters (and its own state); ``lora`` is updated in place.
    The returned loss is detached, the same on every rank of a mesh.

    ``accum_steps > 1`` splits the batch into that many microbatches, runs
    them one after another and averages their gradients before ONE update
    (activation memory scales with the microbatch).  The batch must divide
    evenly; a masked loss averages per-microbatch means, as the JAX
    package's does.

    ``mesh`` (module docstring): every rank calls ``step`` with the whole
    batch (microbatch i is rows ``[i B / accum, (i + 1) B / accum)``, split
    over the dp groups as the JAX package splits it); under tensor
    parallelism ``params`` are the rank's slice (``parallel.tp.
    localize_params`` or ``models.loader.load_packed_sharded``; the whole
    model's are localized at every call) and ``lora`` its slice
    (``train.lora.shard_lora``, whose parameters ``optimizer`` holds), with
    ``lora.tp_basis == cfg.tp_shards``."""
    check_supported(cfg)
    tp = _mesh_tp(cfg, mesh)
    dp = 1 if mesh is None else mesh.dp
    if tp > 1:
        from ..parallel.tp import is_local, localize_params, tp_local_config

        cfg_local = tp_local_config(cfg, tp, mesh.tp_rank)
    materialize = mesh is not None or accum_steps > 1

    def loss_of(params, lora, tokens, loss_mask, positions, segment_ids):
        if tp > 1:
            return _tp_lm_loss(params, lora, cfg_local, mesh, tokens, loss_mask, remat, positions, segment_ids)
        return lm_loss(params, lora, cfg, tokens, loss_mask, remat, positions, segment_ids)

    def step(params, lora, tokens, loss_mask=None, positions=None, segment_ids=None):
        check_basis(lora, cfg)
        if tp > 1 and not is_local(params, cfg, tp):
            params = localize_params(params, cfg, tp, mesh.tp_rank)
        optimizer.zero_grad(set_to_none=True)
        b, s = tokens.shape
        if b % accum_steps:
            raise ValueError(f"batch {b} must divide accum_steps {accum_steps}")
        mb = b // accum_steps
        if mb % dp:
            raise ValueError(f"a microbatch of {mb} rows must divide over dp={dp}")
        if materialize:
            # Concrete defaults, as the JAX package's shard_map and
            # microbatch scan need: an all-ones mask, slot positions and
            # one segment are exactly the unpacked semantics.
            dev = tokens.device
            if loss_mask is None:
                loss_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
            if positions is None:
                positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
            if segment_ids is None:
                segment_ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
        lo, hi = (0, mb) if dp == 1 else (mesh.dp_rank * (mb // dp), (mesh.dp_rank + 1) * (mb // dp))
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(accum_steps):
            rows = slice(i * mb + lo, i * mb + hi)
            part = loss_of(params, lora, tokens[rows], None if loss_mask is None else loss_mask[rows],
                           None if positions is None else positions[rows],
                           None if segment_ids is None else segment_ids[rows])
            (part / accum_steps if accum_steps > 1 else part).backward()
            loss = loss + part.detach()
        if accum_steps > 1:
            loss = loss / accum_steps
        if mesh is not None:
            loss = _reduce_grads(lora, loss, mesh, tp, dp)
        optimizer.step()
        return loss.detach()

    return step


def _reduce_grads(lora, loss: torch.Tensor, mesh, tp: int, dp: int) -> torch.Tensor:
    """After a rank's backward: the gradients of the adapter leaves every
    tensor-parallel rank holds whole summed over ``mesh.tp_group`` (each
    rank computed only its columns' part), then every gradient and the
    loss averaged over ``mesh.dp_group``; each collective one flat buffer.
    Returns the averaged loss."""
    from ..parallel.tp import all_reduce, dp_sum
    from .lora import lora_partition_specs

    named = [(n, p) for n, p in lora.named_parameters() if p.grad is not None]
    if tp > 1:
        axes = lora_partition_specs(lora)
        whole = [p.grad for n, p in named if axes[n] is None]
        if whole:
            flat = all_reduce(torch.cat([g.reshape(-1) for g in whole]), mesh)
            _unflatten(flat, whole)
    if dp > 1:
        grads = [p.grad for _, p in named]
        flat = dp_sum(torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)]), mesh) / dp
        _unflatten(flat[:-1], grads)
        loss = flat[-1]
    return loss


def _unflatten(flat: torch.Tensor, tensors) -> None:
    """Copy consecutive pieces of ``flat`` back into ``tensors``."""
    off = 0
    for t in tensors:
        t.copy_(flat[off : off + t.numel()].view_as(t))
        off += t.numel()
