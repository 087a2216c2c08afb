"""Adapters from bitsandbytes-style modules to the flat :class:`QuantState`.

Inputs may be torch tensors, numpy arrays or anything ``np.asarray`` takes.
The attribute schema is bnb's ``Linear4bit``: uint8 packed weight, uint8
``quant_state.absmax``, fp32 ``state2.absmax`` / ``state2.code``, fp32
``offset``, blocksizes 64/256.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import ABSMAX_BLOCK, NF4_BLOCK, QuantState

__all__ = ["quant_state_from_module", "quant_state_from_arrays"]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _out_dtype(dtype_obj) -> torch.dtype:
    """The torch dtype a module's ``quant_state.dtype`` names (any
    framework's dtype object, or its name)."""
    name = str(dtype_obj)
    if "bfloat16" in name:
        return torch.bfloat16
    if "float16" in name:
        return torch.float16
    return torch.float32


def quant_state_from_arrays(
    packed,
    absmax,
    shape,
    *,
    absmax32=None,
    offset=0.0,
    code2=None,
    dtype=torch.float16,
    quant_type="nf4",
) -> QuantState:
    """Build a flat QuantState from raw arrays.  ``absmax`` is uint8
    (double-quantized; needs ``absmax32``) or fp32 (uncompressed)."""
    packed = _to_numpy(packed).astype(np.uint8).ravel()
    absmax = _to_numpy(absmax)
    shape = tuple(int(s) for s in shape)
    nblocks = -(-int(np.prod(shape)) // NF4_BLOCK)

    if absmax.dtype == np.uint8:
        if absmax32 is None:
            raise ValueError("uint8 absmax requires absmax32")
        return QuantState(
            packed=packed,
            absmax_u8=absmax.ravel()[:nblocks],
            absmax32=_to_numpy(absmax32).astype(np.float32).ravel(),
            offset=np.float32(offset),
            shape=shape,
            dtype=dtype,
            blocksize=NF4_BLOCK,
            blocksize2=ABSMAX_BLOCK,
            code2=None if code2 is None else _to_numpy(code2).astype(np.float32),
            quant_type=quant_type,
        )

    return QuantState(
        packed=packed,
        absmax_u8=np.zeros(nblocks, dtype=np.uint8),
        absmax32=absmax.astype(np.float32).ravel()[:nblocks],
        offset=np.float32(0.0),
        shape=shape,
        dtype=dtype,
        quant_type=quant_type,
    )


def quant_state_from_module(module) -> QuantState:
    """Extract a QuantState from a bitsandbytes-style ``Linear4bit`` module
    (duck-typed: ``weight.data``, ``weight.quant_state``, ``out_features``,
    ``in_features``)."""
    weight = module.weight
    qs = weight.quant_state
    packed = weight.data if hasattr(weight, "data") else weight
    m = int(module.out_features)
    n = int(module.in_features)

    # bnb carries its codebook choice on quant_state.quant_type ("fp4" is
    # bnb's default).
    quant_type = str(getattr(qs, "quant_type", "nf4") or "nf4").lower()
    state2 = getattr(qs, "state2", None)
    absmax32 = _to_numpy(state2.absmax) if state2 is not None else None
    code2 = _to_numpy(state2.code) if state2 is not None and hasattr(state2, "code") else None
    offset = float(_to_numpy(qs.offset)) if getattr(qs, "offset", None) is not None else 0.0

    return quant_state_from_arrays(
        packed,
        _to_numpy(qs.absmax),
        (m, n),
        absmax32=absmax32,
        offset=offset,
        code2=code2,
        dtype=_out_dtype(getattr(qs, "dtype", "float16")),
        quant_type=quant_type,
    )
