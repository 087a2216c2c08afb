"""LoRA adapters over frozen packed 4-bit weights (the QLoRA recipe).

The counterpart of the JAX package's ``train/lora.py``: the 4-bit base
weights stay packed and frozen (``ops.matmul.nf4_matmul`` gives gradients
to activations only), and training updates low-rank ``B @ A`` deltas added
to the adapted projections' outputs.

* Adapters live in the model's fused row basis (``wqkv`` = [q;k;v],
  ``w_gateup`` = [gate;up]): one adapter per fused projection.
* A is ``N(0, 1/in)`` from ``np.random.default_rng(seed)``, drawn in the
  JAX package's order, so A is bit-identical to its; B is zeros, so an
  adapted model equals the base model at step 0.
* Parameters are fp32 ``nn.Parameter``s (optimizer precision); the forward
  casts them to the activation dtype per use.
* Files are the JAX package's ``.npz`` schema (``__rank__``, ``__alpha__``,
  ``__tp_basis__``, ``__targets__``, ``{name}.a`` [L, r, in], ``{name}.b``
  [L, out, r]): adapters written by either package load in the other.

PyTorch idiom in place of the JAX one: the adapters are ``nn.Module``s
with one :class:`LoraLayer` per layer (the JAX package stacks ``[L, ...]``
leaves); ``lora.parameters()`` is what an optimizer takes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.llama import LlamaConfig
from ..utils.device import resolve_device

__all__ = [
    "LoraConfig",
    "LoraAB",
    "LoraLayer",
    "LoraParams",
    "init_lora",
    "save_lora",
    "load_lora",
]

_TARGETS = ("wqkv", "wo", "w_gateup", "w_down")
_TARGET_FIELD = {"wqkv": "qkv", "wo": "o", "w_gateup": "gateup", "w_down": "down"}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Adapter hyper-parameters."""

    rank: int = 8
    alpha: float = 16.0
    # Which projections get adapters, by LayerParams field name.
    targets: Tuple[str, ...] = _TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def __post_init__(self):
        bad = set(self.targets) - set(_TARGETS)
        if bad:
            raise ValueError(f"unknown LoRA targets {sorted(bad)}; pick from {_TARGETS}")


class LoraAB(nn.Module):
    """One projection's low-rank pair: ``delta(x) = (x @ A^T) @ B^T * scaling``."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, scaling: float):
        super().__init__()
        self.a = nn.Parameter(a.float())  # [r, in]
        self.b = nn.Parameter(b.float())  # [out, r]
        self.scaling = float(scaling)


class LoraLayer(nn.Module):
    """One layer's adapters; ``None`` = projection not adapted."""

    def __init__(self, qkv: Optional[LoraAB] = None, o: Optional[LoraAB] = None,
                 gateup: Optional[LoraAB] = None, down: Optional[LoraAB] = None):
        super().__init__()
        self.qkv, self.o, self.gateup, self.down = qkv, o, gateup, down


class LoraParams(nn.Module):
    """The trainable adapters, one :class:`LoraLayer` per layer.

    ``tp_basis`` records the ``cfg.tp_shards`` the adapters were
    initialized against (the fused projections' row order depends on it);
    the port trains on one device, so it is 1 for adapters it makes."""

    def __init__(self, layers: List[LoraLayer], tp_basis: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.tp_basis = int(tp_basis)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _target_dims(cfg: LlamaConfig, name: str) -> Tuple[int, int]:
    """(out_features, in_features) of each adaptable projection."""
    return {
        "wqkv": (cfg.q_dim + 2 * cfg.kv_dim, cfg.hidden_size),
        "wo": (cfg.hidden_size, cfg.q_dim),
        "w_gateup": (2 * cfg.intermediate_size, cfg.hidden_size),
        "w_down": (cfg.hidden_size, cfg.intermediate_size),
    }[name]


def _from_stacked(stacked: dict, num_layers: int, scaling: float, tp_basis: int, device) -> LoraParams:
    """LoraParams on ``device`` from ``{field: (a [L, r, in], b [L, out, r])}``
    numpy pairs (fields absent = not adapted)."""
    layers = []
    for i in range(num_layers):
        fields = {
            f: LoraAB(torch.from_numpy(np.array(a[i], np.float32)).to(device),
                      torch.from_numpy(np.array(b[i], np.float32)).to(device), scaling)
            for f, (a, b) in stacked.items()
        }
        layers.append(LoraLayer(**fields))
    return LoraParams(layers, tp_basis=tp_basis)


def init_lora(cfg: LlamaConfig, lcfg: LoraConfig, seed: int = 0, device=None) -> LoraParams:
    """Adapters for every layer on ``device`` (default ``cuda``): A gaussian
    (the JAX package's draws, bit for bit), B zero."""
    if cfg.num_experts > 1 and ("w_gateup" in lcfg.targets or "w_down" in lcfg.targets):
        raise ValueError("LoRA on MoE expert MLPs is not supported; use LoraConfig(targets=('wqkv', 'wo'))")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    L, r = cfg.num_layers, lcfg.rank
    stacked = {}
    for name in _TARGETS:
        if name not in lcfg.targets:
            continue
        out_d, in_d = _target_dims(cfg, name)
        a = rng.standard_normal((L, r, in_d)).astype(np.float32) * (in_d**-0.5)
        stacked[_TARGET_FIELD[name]] = (a, np.zeros((L, out_d, r), np.float32))
    return _from_stacked(stacked, L, lcfg.scaling, cfg.tp_shards, dev)


def save_lora(path: str, lora: LoraParams, lcfg: LoraConfig) -> None:
    """Write adapters + config to one ``.npz``, the JAX package's schema
    (per-layer pairs stacked to ``[L, ...]``)."""
    arrays = {
        "__rank__": np.int64(lcfg.rank),
        "__alpha__": np.float64(lcfg.alpha),
        "__tp_basis__": np.int64(lora.tp_basis),
    }
    targets = []
    for name in _TARGETS:
        field = _TARGET_FIELD[name]
        if getattr(lora.layers[0], field) is None:
            continue
        targets.append(name)
        abs_ = [getattr(ll, field) for ll in lora.layers]
        arrays[f"{name}.a"] = np.stack([ab.a.detach().cpu().numpy() for ab in abs_])
        arrays[f"{name}.b"] = np.stack([ab.b.detach().cpu().numpy() for ab in abs_])
    arrays["__targets__"] = np.asarray(targets)
    np.savez(path, **arrays)


def load_lora(path: str, device=None) -> Tuple[LoraParams, LoraConfig]:
    """Inverse of :func:`save_lora`; adapters come back fp32 on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        targets = tuple(str(t) for t in z["__targets__"])
        lcfg = LoraConfig(rank=int(z["__rank__"]), alpha=float(z["__alpha__"]), targets=targets)
        tp_basis = int(z["__tp_basis__"]) if "__tp_basis__" in z else 1
        if not targets:
            raise ValueError(f"{path}: the adapter file adapts no projection")
        stacked = {_TARGET_FIELD[name]: (z[f"{name}.a"], z[f"{name}.b"]) for name in targets}
        num_layers = next(iter(stacked.values()))[0].shape[0]
        return _from_stacked(stacked, num_layers, lcfg.scaling, tp_basis, dev), lcfg
