"""The flat bitsandbytes-layout quantization state and its host-side decode.

Only what packing needs: the :class:`QuantState` container, nibble
unpacking and the exact fp32 absmax double-dequantization.  The NumPy
quantize/dequantize oracle stays with the JAX package as the tests' oracle.

Storage format (bitsandbytes ``quantize_4bit(..., compress_statistics=True)``):
``packed`` holds element ``2i`` in the HIGH nibble and ``2i+1`` in the LOW
nibble of byte ``i`` over the row-major flattened weight; ``absmax_u8`` has
one dynamic-code index per 64-element block, ``absmax32`` one fp32 scale per
256 absmax codes, and ``offset`` is added back after decoding:

    absmax[b] = code2[absmax_u8[b]] * absmax32[b // 256] + offset
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .lut import dynamic_code

__all__ = [
    "QuantState",
    "unpack_nibbles",
    "dequantize_absmax",
    "NF4_BLOCK",
    "ABSMAX_BLOCK",
]

NF4_BLOCK = 64  # one absmax per 64 weight values
ABSMAX_BLOCK = 256  # one fp32 absmax32 per 256 absmax codes


@dataclasses.dataclass
class QuantState:
    """Flat bitsandbytes-layout 4-bit quantization state for one tensor."""

    packed: np.ndarray  # uint8 [ceil(numel/2)]
    absmax_u8: np.ndarray  # uint8 [ceil(numel/64)]
    absmax32: np.ndarray  # fp32  [ceil(ceil(numel/64)/256)]
    offset: np.float32  # fp32 scalar
    shape: Tuple[int, ...]  # logical tensor shape
    dtype: np.dtype  # output dtype
    blocksize: int = NF4_BLOCK
    blocksize2: int = ABSMAX_BLOCK
    # Override of the dynamic absmax codebook (bnb's quant_state.state2.code).
    code2: np.ndarray | None = None
    quant_type: str = "nf4"  # "nf4" or "fp4": which 16-entry table

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))


def unpack_nibbles(packed: np.ndarray, numel: int) -> np.ndarray:
    """uint8 bytes -> uint8 indices [numel], high nibble first."""
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    out = np.stack([(packed >> 4) & 0xF, packed & 0xF], axis=1).ravel()
    return out[:numel]


def dequantize_absmax(state: QuantState) -> np.ndarray:
    """The fp32 per-block absmax: code2[u8] * absmax32[blk] + offset."""
    if state.absmax_u8 is None or state.absmax32.shape[0] == state.absmax_u8.shape[0]:
        # Uncompressed statistics: absmax32 holds one fp32 value per block.
        return state.absmax32.astype(np.float32)
    code2 = state.code2 if state.code2 is not None else dynamic_code()
    vals = code2[state.absmax_u8]
    blk = np.arange(vals.shape[0]) // state.blocksize2
    return (vals * state.absmax32[blk] + state.offset).astype(np.float32)
