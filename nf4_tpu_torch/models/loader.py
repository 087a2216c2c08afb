"""Packed checkpoints: quantize once, reload fast.

The counterpart of ``save_packed`` / ``load_packed`` / ``load_packed_auto``
in the JAX package's ``models/loader.py``, with the same schema and the same
``"nf4_tpu"`` metadata key, so either package reads what the other wrote:

* ``layers.<name>.packed`` / ``.scales`` for the packed projections
  (``wqkv``, ``wo``, ``w_gateup``, ``w_down``), stacked over the layer axis
  (an MoE model's expert-stacked ``w_gateup`` and ``w_down`` as ``[L, E,
  ...]``); ``layers.<name>`` for dense projections, the two norms and,
  where the model has them, ``qkv_bias``, ``q_norm``, ``k_norm``,
  ``router``, ``post_attn_out_norm`` and ``post_ffw_norm``; top-level
  ``embed``, ``final_norm`` and ``lm_head`` (or ``lm_head.packed`` /
  ``.scales``).
* metadata: each packed weight's logical ``shapes``, ``shards`` and
  ``quant_types``; ``dtypes`` (the ``.npz`` keys stored as bf16 bits); the
  ``dtype``; and the whole ``config``, so a checkpoint describes itself.

``.npz`` always works: bf16 tensors are stored as uint16 bit patterns and
read back through a torch view.  ``.safetensors`` needs the ``safetensors``
package.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Dict, Tuple

import numpy as np
import torch

from ..nf4.format import PackedNF4
from ..ops.int8_serve import PackedInt8
from ..utils.device import resolve_device
from .convert import _OPTIONAL_LAYER_FIELDS as _OPTIONAL_FIELDS
from .convert import config_from_dict, config_to_dict
from .llama import LayerParams, LlamaConfig, LlamaParams

__all__ = ["save_packed", "load_packed", "load_packed_auto"]

_LINEAR_FIELDS = ("wqkv", "wo", "w_gateup", "w_down")
_NORM_FIELDS = ("input_norm", "post_attn_norm")


def _safetensors(module: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            ".safetensors checkpoints need the 'safetensors' package, which is not installed; "
            "use a .npz path instead"
        ) from e


def _put_weight(tensors: dict, meta: dict, key: str, name: str, ws: list, stacked: bool) -> None:
    """Store weight ``name`` (one per layer when ``stacked``) under ``key``."""
    join = torch.stack if stacked else (lambda ts: ts[0])
    w = ws[0]
    if isinstance(w, PackedInt8):
        raise ValueError("int8-recoded weights are a serving format: save the packed 4-bit params")
    if isinstance(w, PackedNF4):
        tensors[f"{key}.packed"] = join([x.packed for x in ws])
        tensors[f"{key}.scales"] = join([x.scales for x in ws])
        meta["shapes"][name] = list(w.shape)
        meta["shards"][name] = w.shards
        meta["quant_types"][name] = w.quant_type
    else:
        tensors[key] = join(ws)


def save_packed(path: str, params: LlamaParams, cfg: LlamaConfig) -> None:
    """Write packed params and their config: ``.safetensors`` by extension,
    else an ``.npz`` archive (bf16 stored as uint16 bits)."""
    meta = {
        "shapes": {}, "shards": {}, "quant_types": {}, "dtypes": {},
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "config": config_to_dict(cfg),
    }
    tensors: Dict[str, torch.Tensor] = {"embed": params.embed, "final_norm": params.final_norm}
    _put_weight(tensors, meta, "lm_head", "lm_head", [params.lm_head], stacked=False)
    for name in _LINEAR_FIELDS:
        _put_weight(tensors, meta, f"layers.{name}", name, [getattr(lp, name) for lp in params.layers], True)
    for name in _NORM_FIELDS + _OPTIONAL_FIELDS:
        if getattr(params.layers[0], name) is not None:
            tensors[f"layers.{name}"] = torch.stack([getattr(lp, name) for lp in params.layers])
    tensors = {k: t.detach().cpu().contiguous() for k, t in tensors.items()}

    if path.endswith(".safetensors"):
        _safetensors("safetensors.torch").save_file(tensors, path, metadata={"nf4_tpu": json.dumps(meta)})
        return
    arrays = {}
    for key, t in tensors.items():
        if t.dtype == torch.bfloat16:
            arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
            meta["dtypes"][key] = "bfloat16"
        else:
            arrays[key] = t.numpy()
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def _read_packed(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A save_packed artifact -> (CPU tensors by key, metadata)."""
    if path.endswith(".safetensors"):
        with _safetensors("safetensors").safe_open(path, framework="pt") as f:
            meta = json.loads(f.metadata()["nf4_tpu"])
            return {k: f.get_tensor(k) for k in f.keys()}, meta
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        data = {}
        for key in z.files:
            if key == "__meta__":
                continue
            arr = z[key]
            if meta["dtypes"].get(key) == "bfloat16":
                data[key] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                data[key] = torch.from_numpy(arr)
    return data, meta


def _assemble(data: Dict[str, torch.Tensor], meta: dict, cfg: LlamaConfig, device) -> LlamaParams:
    dev = resolve_device(device)
    # Checkpoints from before the "shards" / "quant_types" fields were all
    # written with shards=1 and NF4.
    shards, quant_types = meta.get("shards", {}), meta.get("quant_types", {})

    def weight(key, name, i=None):
        pick = (lambda t: t.to(dev)) if i is None else (lambda t: t[i].to(dev))
        if f"{key}.packed" not in data:
            return pick(data[key])
        packed = data[f"{key}.packed"]
        m, n = meta["shapes"][name]
        return PackedNF4(
            packed=pick(packed),
            scales=pick(data[f"{key}.scales"]),
            shape=(m, n),
            padded_shape=(packed.shape[-1], 2 * packed.shape[-2]),
            dtype=cfg.dtype,
            shards=int(shards.get(name, 1)),
            quant_type=str(quant_types.get(name, "nf4")),
        )

    vectors = [name for name in _NORM_FIELDS + _OPTIONAL_FIELDS if f"layers.{name}" in data]
    layers = [
        LayerParams(
            **{name: weight(f"layers.{name}", name, i) for name in _LINEAR_FIELDS},
            **{name: data[f"layers.{name}"][i].to(dev) for name in vectors},
        )
        for i in range(cfg.num_layers)
    ]
    return LlamaParams(
        embed=weight("embed", "embed"),
        layers=layers,
        final_norm=weight("final_norm", "final_norm"),
        lm_head=weight("lm_head", "lm_head"),
    )


def load_packed(path: str, cfg: LlamaConfig, device=None) -> LlamaParams:
    """Params saved by :func:`save_packed` (``.npz`` or ``.safetensors``),
    on ``device`` (default ``cuda``)."""
    data, meta = _read_packed(path)
    return _assemble(data, meta, cfg, device)


def load_packed_auto(path: str, device=None, **overrides) -> Tuple[LlamaParams, LlamaConfig]:
    """Params AND their config from a self-describing checkpoint, on
    ``device`` (default ``cuda``).  ``overrides`` are serving-time fields
    applied on top (e.g. ``kv_quant=True``, ``max_seq_len=4096``)."""
    data, meta = _read_packed(path)
    if "config" not in meta:
        raise ValueError(
            f"{path} has no 'config' in its metadata: use load_packed(path, cfg) with the model's config"
        )
    cfg = dataclasses.replace(config_from_dict(meta["config"]), **overrides)
    return _assemble(data, meta, cfg, device), cfg
