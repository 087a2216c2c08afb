"""The weight bridge: parameters and configurations from the JAX package.

:func:`params_from_numpy` takes the JAX package's ``LlamaParams`` with its
leaves as numpy arrays (``jax.tree.map(np.asarray, params)``), read by
attribute only: ``embed``, ``final_norm``, ``lm_head`` and the stacked
``[L, ...]`` ``layers.{wqkv, wo, w_gateup, w_down}`` (each with ``packed``,
``scales``, ``shape``, ``padded_shape``, ``dtype``, ``shards`` and
``quant_type``; an int8-recoded one with ``values`` and ``scales``; or a
dense array; an MoE model's ``w_gateup`` and ``w_down`` expert-stacked,
``[L, E, ...]``), ``layers.{input_norm, post_attn_norm}`` and, where
present, ``layers.{qkv_bias, q_norm, k_norm, router, post_attn_out_norm,
post_ffw_norm}``.  It returns the port's params with the layers split (an
expert-stacked weight stays one weight with a leading ``[E]`` axis).  The
packed bytes, int8 values and scales are copied as they are: the layouts
are shared.

:func:`config_to_dict` / :func:`config_from_dict` are the JAX package's
configuration dicts (its ``models/loader.py``), as packed checkpoints
store them.

:func:`lora_from_numpy` takes the JAX package's ``train.lora.LoraParams``
with numpy leaves (``layers.{qkv, o, gateup, down}``, each None or with
``a`` [L, r, in], ``b`` [L, out, r] and ``scaling``; and ``tp_basis``) and
returns the port's adapters, one layer each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..nf4.format import PackedNF4
from ..ops.int8_serve import PackedInt8
from ..train.lora import LoraAB, LoraLayer, LoraParams
from ..utils.device import resolve_device
from .llama import LayerParams, LlamaConfig, LlamaParams

__all__ = ["params_from_numpy", "lora_from_numpy", "config_from_dict", "config_to_dict"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _torch_dtype(dtype_obj) -> torch.dtype:
    return _DTYPES[np.dtype(dtype_obj).name if not isinstance(dtype_obj, str) else dtype_obj]


def _tensor(arr, device) -> torch.Tensor:
    """numpy (including a bfloat16 extension dtype) -> torch on device."""
    arr = np.array(arr, copy=True)  # writable and contiguous
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _weight(w, i, device):
    """Layer ``i`` of a stacked weight (``i=None``: an unstacked one)."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if hasattr(w, "packed"):
        return PackedNF4(
            packed=_tensor(pick(w.packed), device),
            scales=_tensor(pick(w.scales), device),
            shape=tuple(int(d) for d in w.shape),
            padded_shape=tuple(int(d) for d in w.padded_shape),
            dtype=_torch_dtype(w.dtype),
            shards=int(w.shards),
            quant_type=str(w.quant_type),
        )
    if hasattr(w, "values"):
        return PackedInt8(
            values=_tensor(pick(w.values), device),
            scales=_tensor(pick(w.scales), device),
            shape=tuple(int(d) for d in w.shape),
            padded_shape=tuple(int(d) for d in w.padded_shape),
            dtype=_torch_dtype(w.dtype),
            shards=int(w.shards),
        )
    return _tensor(pick(w), device)


# The layer vectors a model may have (fp32, one per layer).
_OPTIONAL_LAYER_FIELDS = ("qkv_bias", "q_norm", "k_norm", "router", "post_attn_out_norm", "post_ffw_norm")


def params_from_numpy(tree, cfg: LlamaConfig, device=None) -> LlamaParams:
    """The port's params on ``device`` (default ``cuda``) from the JAX
    package's numpy-leaved params."""
    dev = resolve_device(device)
    lt = tree.layers
    optional = [n for n in _OPTIONAL_LAYER_FIELDS if getattr(lt, n, None) is not None]
    layers = [
        LayerParams(
            wqkv=_weight(lt.wqkv, i, dev),
            wo=_weight(lt.wo, i, dev),
            w_gateup=_weight(lt.w_gateup, i, dev),
            w_down=_weight(lt.w_down, i, dev),
            input_norm=_tensor(lt.input_norm[i], dev),
            post_attn_norm=_tensor(lt.post_attn_norm[i], dev),
            **{n: _tensor(getattr(lt, n)[i], dev) for n in optional},
        )
        for i in range(cfg.num_layers)
    ]
    return LlamaParams(
        embed=_tensor(tree.embed, dev),
        layers=layers,
        final_norm=_tensor(tree.final_norm, dev),
        lm_head=_weight(tree.lm_head, None, dev),
    )


def lora_from_numpy(tree, device=None):
    """The port's ``LoraParams`` on ``device`` (default ``cuda``) from the
    JAX package's numpy-leaved adapters."""
    dev = resolve_device(device)
    fields = ("qkv", "o", "gateup", "down")
    present = {f: getattr(tree.layers, f) for f in fields if getattr(tree.layers, f) is not None}
    if not present:
        raise ValueError("the adapters adapt no projection")
    num_layers = next(iter(present.values())).a.shape[0]
    layers = [
        LoraLayer(**{f: LoraAB(_tensor(ab.a[i], dev), _tensor(ab.b[i], dev), float(ab.scaling))
                     for f, ab in present.items()})
        for i in range(num_layers)
    ]
    return LoraParams(layers, tp_basis=int(tree.tp_basis))


def config_to_dict(cfg: LlamaConfig) -> dict:
    """A JSON-serializable dict of ``cfg`` (the dtype by its name), as the
    JAX package's ``config_to_dict`` writes it: ``ep_rank`` (runtime only,
    as its ``ep_axis``) is left out."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "ep_rank"}
    out["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return out


def config_from_dict(d: dict) -> LlamaConfig:
    """A LlamaConfig from the JAX package's ``config_to_dict`` output (JSON
    round-trips tolerated: lists become tuples, the dtype is its name).
    Keys this port does not know are ignored."""
    known = {f.name for f in dataclasses.fields(LlamaConfig)}

    def detuple(v):
        return tuple(detuple(x) for x in v) if isinstance(v, (list, tuple)) else v

    kwargs = {}
    for k, v in d.items():
        if k not in known:
            continue
        if k == "dtype":
            v = _torch_dtype(str(v))
        elif isinstance(v, list):
            v = detuple(v)
        kwargs[k] = v
    return LlamaConfig(**kwargs)
