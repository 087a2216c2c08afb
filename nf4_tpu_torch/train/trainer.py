"""The LoRA training step over frozen packed 4-bit weights (one device).

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

Data and tensor parallelism (the JAX package's ``mesh``) wait for the
multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.llama import LlamaConfig, LlamaParams, check_supported, train_forward
from .lora import LoraParams

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
    The returned loss is detached.

    ``accum_steps > 1`` splits the batch into that many microbatches, runs
    them one after another and averages their gradients before ONE update
    (activation memory scales with the microbatch).  The batch must divide
    evenly; a masked loss averages per-microbatch means, as the JAX
    package's does."""
    if mesh is not None or cfg.tp_shards > 1:
        raise NotImplementedError("not ported yet: data- and tensor-parallel training (a dp x tp mesh, "
                                  "lora.tp_basis); tensor-parallel serving is Engine(mesh=)")
    check_supported(cfg)

    def step(params, lora, tokens, loss_mask=None, positions=None, segment_ids=None):
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = lm_loss(params, lora, cfg, tokens, loss_mask, remat, positions, segment_ids)
            loss.backward()
        else:
            b, s = tokens.shape
            if b % accum_steps:
                raise ValueError(f"batch {b} must divide accum_steps {accum_steps}")
            # Concrete defaults, as the JAX package's microbatch scan needs:
            # an all-ones mask, slot positions and one segment are exactly
            # the unpacked semantics.
            dev = tokens.device
            if loss_mask is None:
                loss_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
            if positions is None:
                positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
            if segment_ids is None:
                segment_ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
            mb = b // accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                part = lm_loss(params, lora, cfg, tokens[rows], loss_mask[rows], remat,
                               positions[rows], segment_ids[rows])
                (part / accum_steps).backward()
                loss = loss + part.detach()
            loss = loss / accum_steps
        optimizer.step()
        return loss.detach()

    return step
