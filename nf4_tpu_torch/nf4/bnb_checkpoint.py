"""bitsandbytes-serialized 4-bit weights in HF checkpoints ("*-bnb-4bit").

transformers saves a bnb ``Linear4bit`` as a group of sibling tensors
beside the packed weight (bitsandbytes ``QuantState.as_dict(packed=True)``):

    {prefix}.weight                                uint8 [numel/2, 1]
    {prefix}.weight.absmax                         uint8 [nblocks] (double-quantized)
                                                   or fp32 [nblocks] (compress_statistics=False)
    {prefix}.weight.quant_map                      fp32 [16]  (the 4-bit codebook)
    {prefix}.weight.nested_absmax                  fp32 [ceil(nblocks/256)] (double-quantized only)
    {prefix}.weight.nested_quant_map               fp32 [256] (dynamic code) (double-quantized only)
    {prefix}.weight.quant_state.bitsandbytes__nf4  uint8 (a JSON blob), or ...__fp4

The JSON blob carries ``quant_type``, ``blocksize``, ``dtype``, ``shape``
and, with double-quantized statistics, ``nested_blocksize``,
``nested_dtype`` and ``nested_offset``.  This module groups the tensors back
into a flat :class:`~nf4_tpu_torch.nf4.reference.QuantState` and decodes it
to a :class:`~nf4_tpu_torch.nf4.format.QDense`: the codes bitsandbytes
chose pass into the packed layout untouched (a repack, never a
requantization).  The counterpart of the JAX package's
``nf4/bnb_checkpoint.py``.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .adapters import _to_numpy, quant_state_from_arrays
from .format import QDense, qdense_from_state
from .reference import NF4_BLOCK

__all__ = ["BNB_SIDECAR_RE", "BnbWeightGroup", "is_bnb_sidecar", "qdense_from_group"]

# Sidecar keys relative to the base "....weight" tensor.
BNB_SIDECAR_RE = re.compile(
    r"^(?P<base>.+\.weight)\.(?P<part>absmax|quant_map|nested_absmax|"
    r"nested_quant_map|quant_state\.bitsandbytes__(?:nf4|fp4))$"
)


def is_bnb_sidecar(key: str) -> Optional[Tuple[str, str]]:
    """(base weight key, part name) when ``key`` is a bnb sidecar tensor."""
    m = BNB_SIDECAR_RE.match(key)
    if not m:
        return None
    part = m.group("part")
    if part.startswith("quant_state."):
        part = "quant_state"
    return m.group("base"), part


class BnbWeightGroup:
    """The packed weight and sidecars of one quantized Linear.  Tensors may
    arrive in any order and, in sharded checkpoints, from different files;
    :meth:`complete` turns true once everything the metadata needs is in."""

    def __init__(self, base_key: str):
        self.base_key = base_key
        self.parts: Dict[str, np.ndarray] = {}

    def add(self, part: str, tensor) -> None:
        self.parts[part] = _to_numpy(tensor)

    @property
    def meta(self) -> Optional[dict]:
        blob = self.parts.get("quant_state")
        if blob is None:
            return None
        return json.loads(np.asarray(blob, dtype=np.uint8).tobytes().decode("utf-8"))

    def complete(self) -> bool:
        if "weight" not in self.parts or "quant_state" not in self.parts:
            return False
        absmax = self.parts.get("absmax")
        if absmax is None:
            return False
        if absmax.dtype == np.uint8:
            return "nested_absmax" in self.parts and "nested_quant_map" in self.parts
        return True


def qdense_from_group(group: BnbWeightGroup) -> QDense:
    """Decode a complete sidecar group to codes and exact fp32 block scales."""
    if not group.complete():
        raise ValueError(f"incomplete bnb group {group.base_key}")
    meta = group.meta
    quant_type = str(meta.get("quant_type", "nf4")).lower()
    if quant_type not in ("nf4", "fp4"):
        raise ValueError(f"{group.base_key}: unsupported quant_type {quant_type!r}")
    blocksize = int(meta.get("blocksize", NF4_BLOCK))
    if blocksize != NF4_BLOCK:
        raise ValueError(f"{group.base_key}: blocksize {blocksize} != {NF4_BLOCK} (only the bnb default is supported)")
    shape = tuple(int(s) for s in meta["shape"])
    if len(shape) != 2:
        raise ValueError(f"{group.base_key}: non-2D shape {shape}")
    state = quant_state_from_arrays(
        group.parts["weight"],
        group.parts["absmax"],
        shape,
        absmax32=group.parts.get("nested_absmax"),
        offset=float(meta.get("nested_offset", 0.0)),
        code2=group.parts.get("nested_quant_map"),
        dtype=torch.float16,
        quant_type=quant_type,
    )
    return qdense_from_state(state)
