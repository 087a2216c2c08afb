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
* Tensor parallelism (the JAX trainer's ``lora_partition_specs``): a
  column target (``qkv``, ``gateup``) shards B on its out-features, a row
  target (``o``, ``down``) A on its in-features, each rank holding the
  slice that meets its slice of the packed weight; the other side is
  whole on every rank.  :func:`shard_lora` cuts a rank's slice out,
  :func:`gather_lora` puts the slices back together on every rank (saving
  and merging take the whole set).
* :func:`stack_adapters` stacks adapters into a multi-LoRA bank, served
  per request (``serve.engine.Engine(lora_bank=)``); :func:`merge_lora`
  folds one adapter into the base weights (``W + scaling * B @ A``),
  requantized by the port's quantizer.

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

from ..models.llama import LlamaConfig, LlamaParams
from ..nf4.format import PackedNF4, quantize_for_tpu
from ..ops.dequant import dequantize
from ..ops.matmul import _ieee_fp32
from ..utils.device import resolve_device

__all__ = [
    "LoraConfig",
    "LoraAB",
    "LoraLayer",
    "LoraParams",
    "init_lora",
    "stack_adapters",
    "merge_lora",
    "save_lora",
    "load_lora",
    "lora_partition_specs",
    "shard_lora",
    "gather_lora",
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
    a rank's slice (:func:`shard_lora`) keeps its whole set's."""

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


def stack_adapters(loras) -> LoraParams:
    """Stack adapters (each :class:`LoraParams` of one adapter, ranks and
    scalings free) into one multi-LoRA BANK for per-request serving
    (``serve.engine.Engine(lora_bank=)``): each layer's pairs gain an
    adapter axis, ``a`` [A, r_max, in] and ``b`` [A, out, r_max] (the JAX
    package's ``[L, A, ...]`` leaves, per layer).  The JAX package's
    normalizations, none of which changes an adapter's function: each
    adapter's ``scaling`` folded into its ``a`` (the bank's is 1.0); ranks
    zero-padded to the largest; a projection some adapters leave out gets
    zero pairs for them.  The bank lives on the adapters' device, fp32."""
    loras = list(loras)
    if not loras:
        raise ValueError("stack_adapters needs at least one adapter")
    bases = {lo.tp_basis for lo in loras}
    if len(bases) != 1:
        raise ValueError(f"adapters were initialized against different tp_shards bases {sorted(bases)}: "
                         "their fused-row layouts are incompatible")
    depth = {len(lo.layers) for lo in loras}
    if len(depth) != 1:
        raise ValueError(f"adapters of different depths {sorted(depth)}")
    layers = []
    for i in range(depth.pop()):
        fields = {}
        for f in _TARGET_FIELD.values():
            abs_ = [getattr(lo.layers[i], f) for lo in loras]
            present = [ab for ab in abs_ if ab is not None]
            if not present:
                continue
            if any(ab.a.dim() != 2 for ab in present):
                raise ValueError("stack_adapters takes single adapters, not banks")
            rmax = max(ab.a.shape[0] for ab in present)
            (out_d, _), in_d = present[0].b.shape, present[0].a.shape[1]
            dev = present[0].a.device
            a = torch.zeros((len(abs_), rmax, in_d), dtype=torch.float32, device=dev)
            b = torch.zeros((len(abs_), out_d, rmax), dtype=torch.float32, device=dev)
            with torch.no_grad():
                for j, ab in enumerate(abs_):
                    if ab is not None:
                        r = ab.a.shape[0]
                        a[j, :r] = ab.a.float() * ab.scaling
                        b[j, :, :r] = ab.b.float()
            fields[f] = LoraAB(a, b, 1.0)
        layers.append(LoraLayer(**fields))
    return LoraParams(layers, tp_basis=loras[0].tp_basis)


# The side each target shards under tensor parallelism, as an axis from
# the end of a and b (a [r, in], b [out, r]); None: whole on every rank.
_TP_AXES = {"qkv": (None, -2), "gateup": (None, -2), "o": (-1, None), "down": (-1, None)}


def lora_partition_specs(lora: LoraParams) -> dict:
    """``{parameter name: axis}`` of every adapter parameter (its name in
    ``lora.named_parameters()``): the axis from the end that tensor
    parallelism shards, or None where every rank holds it whole (the JAX
    trainer's ``lora_partition_specs`` and, by None, its
    ``_lora_replicated_mask``)."""
    out = {}
    for i, ll in enumerate(lora.layers):
        for field, (a_ax, b_ax) in _TP_AXES.items():
            if getattr(ll, field) is not None:
                out[f"layers.{i}.{field}.a"], out[f"layers.{i}.{field}.b"] = a_ax, b_ax
    return out


def check_basis(lora: LoraParams, cfg: LlamaConfig) -> None:
    """Raise unless the adapters were made for ``cfg.tp_shards``'s fused-row
    layout (``lora.tp_basis``)."""
    if lora.tp_basis != cfg.tp_shards:
        raise ValueError(f"adapter tp_basis={lora.tp_basis} != cfg.tp_shards={cfg.tp_shards}: the adapters' fused "
                         "rows follow another interleave and would meet the wrong channels; use the checkpoint "
                         "(and config) they were made for, or init_lora against this one")


def shard_lora(lora: LoraParams, cfg: LlamaConfig, mesh) -> LoraParams:
    """This rank's slice of the whole adapter set ``lora`` for the mesh's
    tensor-parallel degree (:func:`lora_partition_specs`), new parameters
    (contiguous copies) for an optimizer of the rank's own.  ``cfg`` is
    the whole model's; ``lora.tp_basis`` must be its ``tp_shards``."""
    check_basis(lora, cfg)
    if mesh.tp == 1:
        return lora
    from ..parallel.tp import local_slice

    layers = []
    for ll in lora.layers:
        fields = {}
        for field, (a_ax, b_ax) in _TP_AXES.items():
            ab = getattr(ll, field)
            if ab is None:
                continue
            a, b = (t.detach() if ax is None else local_slice(t.detach(), ax, mesh.tp, mesh.tp_rank)
                    for t, ax in ((ab.a, a_ax), (ab.b, b_ax)))
            fields[field] = LoraAB(a.clone(), b.clone(), ab.scaling)
        layers.append(LoraLayer(**fields))
    return LoraParams(layers, tp_basis=lora.tp_basis)


def gather_lora(lora_local: LoraParams, mesh) -> LoraParams:
    """The whole adapter set on every rank from each rank's slice
    (:func:`shard_lora`), through the zero-filled sum over
    ``mesh.tp_group`` that gloo takes for CUDA tensors; detached fp32
    parameters.  ``lora_local`` itself at tp = 1."""
    if mesh.tp == 1:
        return lora_local
    from ..parallel.tp import all_reduce

    def whole(t, axis):
        t = t.detach()
        if axis is None:
            return t.clone()
        n = t.shape[axis]
        full = t.new_zeros((*t.shape[: t.dim() + axis], n * mesh.tp, *t.shape[t.dim() + axis + 1 :]))
        full.narrow(axis, mesh.tp_rank * n, n).copy_(t)
        return all_reduce(full, mesh)

    layers = []
    for ll in lora_local.layers:
        fields = {}
        for field, (a_ax, b_ax) in _TP_AXES.items():
            ab = getattr(ll, field)
            if ab is not None:
                fields[field] = LoraAB(whole(ab.a, a_ax), whole(ab.b, b_ax), ab.scaling)
        layers.append(LoraLayer(**fields))
    return LoraParams(layers, tp_basis=lora_local.tp_basis)


def merge_lora(params: LlamaParams, lora: LoraParams, cfg: LlamaConfig, quantize: bool = True,
               method: str = "auto") -> LlamaParams:
    """Fold one adapter into the base weights: ``W' = W + scaling * B @ A``
    (the JAX package's ``merge_lora``), one projection at a time on the
    weights' device.  A packed weight is dequantized exactly (on the card
    kernel A), ``B @ A`` is a full fp32 product (no TF32), and
    ``quantize=True`` quantizes each merged weight back to the packed
    layout with :func:`~nf4_tpu_torch.nf4.format.quantize_for_tpu`
    (``method``; the weight's ``quant_type`` kept; on the card the device
    quantizer): the merged values move to the nearest point of the new
    grid, as a fine-tuned dense checkpoint's do when it is quantized.
    ``quantize=False`` returns dense ``cfg.dtype`` weights.  Each weight
    keeps its shard count (``shards``; 1 for a dense weight): a
    row-parallel weight of a ``tp_shards > 1`` checkpoint is packed in K
    chunks again, so the merged checkpoint slices per rank as the one it
    came from.  The merged model serves with no adapter, on every path."""
    check_basis(lora, cfg)
    if len(lora.layers) != len(params.layers):
        raise ValueError(f"{len(lora.layers)} adapter layers for {len(params.layers)} model layers")
    layers = []
    for lp, ll in zip(params.layers, lora.layers):
        new = {}
        for name, field in _TARGET_FIELD.items():
            ab = getattr(ll, field)
            if ab is None:
                continue
            if ab.a.dim() != 2:
                raise ValueError("merge_lora takes one adapter, not a bank")
            pw = getattr(lp, name)
            packed = isinstance(pw, PackedNF4)
            if packed and pw.packed.dim() != 2 or not packed and pw.dim() != 2:
                raise ValueError(f"LoRA on MoE expert MLPs is not supported ({name})")
            with torch.no_grad(), _ieee_fp32():
                w = dequantize(pw, torch.float32) if packed else pw.float()
                delta = ab.b.detach().to(w.device, torch.float32) @ ab.a.detach().to(w.device, torch.float32)
                merged = w + ab.scaling * delta
            if quantize:
                qt = pw.quant_type if packed else cfg.quant_type
                new[name] = quantize_for_tpu(merged, dtype=cfg.dtype, shards=pw.shards if packed else 1,
                                             method=method, quant_type=qt, device=w.device)
            else:
                new[name] = merged.to(cfg.dtype)
        layers.append(dataclasses.replace(lp, **new))
    return dataclasses.replace(params, layers=layers)


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
