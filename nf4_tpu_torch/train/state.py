"""Resumable training state: save and restore a fine-tuning run.

A train state is (adapters, optimizer state, step counter); the frozen
packed base checkpoint is not part of it (it never changes, and
``models.loader`` saves it).  The layout is the JAX package's
``train/state.py``, two sibling files:

* ``path + ".lora.npz"``: the adapters in :func:`~.lora.save_lora`'s
  format, so a train-state checkpoint is also an adapter file either
  package loads;
* ``path``: the optimizer half, plain ``.npz`` without pickle: ``__fmt__``,
  ``__step__``, ``__n_leaves__`` and ``leaf_{i}``, the torch optimizer's
  state tensors in order (parameter by parameter, each parameter's state
  keys sorted), with ``__names__`` naming each as ``"{param}.{key}"``.

The optimizer half holds a torch optimizer's state (for AdamW: ``step``,
``exp_avg``, ``exp_avg_sq``); it does not load into optax, nor does an
optax state load here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .lora import LoraConfig, LoraParams, load_lora, save_lora

__all__ = ["save_train_state", "load_train_state"]

_FMT = 1


def save_train_state(
    path: str,
    lora: LoraParams,
    lcfg: LoraConfig,
    optimizer: torch.optim.Optimizer,
    step: int = 0,
) -> None:
    """Write adapters + ``optimizer``'s state + the step counter (see the
    module docstring for the two files)."""
    save_lora(path + ".lora.npz", lora, lcfg)
    state = optimizer.state_dict()["state"]
    names, leaves = [], []
    for p in sorted(state):
        for key in sorted(state[p]):
            value = state[p][key]
            names.append(f"{p}.{key}")
            leaves.append(value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value))
    arrays = {
        "__fmt__": np.int64(_FMT),
        "__step__": np.int64(step),
        "__n_leaves__": np.int64(len(leaves)),
        "__names__": np.asarray(names, dtype=np.str_),
    }
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"] = leaf
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_train_state(
    path: str,
    make_optimizer: Callable,
    device=None,
) -> Tuple[LoraParams, LoraConfig, torch.optim.Optimizer, int]:
    """Inverse of :func:`save_train_state`.

    ``make_optimizer(params)`` must build the same kind of optimizer that
    was saved (e.g. ``lambda ps: torch.optim.AdamW(ps, lr=1e-4,
    weight_decay=1e-4)``); it receives the restored adapters' parameters,
    and the saved state is poured back in by position.  Returns ``(lora,
    lcfg, optimizer, step)``, ready to resume where the run left off."""
    lora, lcfg = load_lora(path + ".lora.npz", device=device)
    optimizer = make_optimizer(lora.parameters())
    with np.load(path) as z:
        fmt = int(z["__fmt__"])
        if fmt != _FMT:
            raise ValueError(f"unknown train-state format {fmt} (expected {_FMT})")
        step = int(z["__step__"])
        n = int(z["__n_leaves__"])
        names = [str(s) for s in z["__names__"]]
        saved = [z[f"leaf_{i}"] for i in range(n)]
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {}
    for name, arr in zip(names, saved):
        p, key = name.split(".", 1)
        p = int(p)
        if p >= len(params):
            raise ValueError(f"optimizer state for parameter {p}, but the optimizer has {len(params)}")
        if arr.ndim and tuple(arr.shape) != tuple(params[p].shape):
            raise ValueError(f"optimizer-state leaf {name} has shape {arr.shape}, parameter {tuple(params[p].shape)}")
        state.setdefault(p, {})[key] = torch.from_numpy(np.array(arr))
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)  # casts each moment to its parameter's dtype and device
    return lora, lcfg, optimizer, step
