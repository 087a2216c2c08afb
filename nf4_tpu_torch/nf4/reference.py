"""The bit-exact NumPy 4-bit quantization oracle and the flat
bitsandbytes-layout quantization state.

The same NumPy code as the JAX package's ``nf4/reference.py`` (the tests
hold the two byte for byte), kept here so the port never imports that
package: the :class:`QuantState` container, :func:`quantize_nf4` /
:func:`dequantize_nf4` (NF4 and FP4, double-quantized or raw fp32
statistics), the dynamic-code blockwise quantizer of the statistics, nibble
packing and the exact fp32 absmax double-dequantization.  It is slow
(``np.searchsorted``-bound); bulk quantization runs on the card
(``nf4.fast_quant``), byte-identical to it.

Storage format (bitsandbytes ``quantize_4bit(..., compress_statistics=True)``):
``packed`` holds element ``2i`` in the HIGH nibble and ``2i+1`` in the LOW
nibble of byte ``i`` over the row-major flattened weight; ``absmax_u8`` has
one dynamic-code index per 64-element block, ``absmax32`` one fp32 scale per
256 absmax codes, and ``offset`` (the mean of the raw fp32 absmax) is added
back after decoding:

    absmax[b] = code2[absmax_u8[b]] * absmax32[b // 256] + offset
    w_flat[i] = CODE[nibble_i] * absmax[i // 64]   (fp32, then cast)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .lut import code_midpoints, dynamic_code, fp4_order_and_mids, get_code

__all__ = [
    "QuantState",
    "quantize_nf4",
    "dequantize_nf4",
    "dequantize_absmax",
    "quantize_to_code",
    "quantize_blockwise_u8",
    "pack_nibbles",
    "unpack_nibbles",
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


def quantize_to_code(x: np.ndarray, code: np.ndarray) -> np.ndarray:
    """Map fp32 values in [-1, 1] to nearest-codebook indices.

    A value goes to the higher index only when strictly greater than the
    midpoint (the ``x > mid`` comparisons of bitsandbytes' quantizer
    trees): ``idx = #{midpoints < x}``, ``np.searchsorted(mids, x,
    side='left')``.  A non-monotone SIGN-MAGNITUDE table (fp4:
    ``code[8+i] == -code[i]``, ``code[:8] >= 0``) quantizes as bnb's
    dQuantizeFP4: the nearest non-negative magnitude by the same rule, plus
    the sign bit when ``x < 0`` (so ``-0.0`` and ``0.0`` both take the
    positive branch, as the CUDA ``x < 0.0f`` test does)."""
    x = np.asarray(x, dtype=np.float32)
    code = np.asarray(code, dtype=np.float32)
    if code.shape[0] != 16 or np.all(np.diff(code) >= 0):
        mids = code_midpoints(code)
        idx = np.searchsorted(mids, x, side="left")
        return idx.astype(np.uint8)
    order, mids = fp4_order_and_mids(code)
    pos = np.searchsorted(mids, np.abs(x), side="left")
    idx = order[pos] + np.where(x < 0, 8, 0).astype(np.uint8)
    return idx.astype(np.uint8)


def _block_absmax(x_flat: np.ndarray, blocksize: int) -> np.ndarray:
    n = x_flat.shape[0]
    nblocks = -(-n // blocksize)
    pad = nblocks * blocksize - n
    if pad:
        x_flat = np.concatenate([x_flat, np.zeros(pad, dtype=x_flat.dtype)])
    return np.abs(x_flat.reshape(nblocks, blocksize)).max(axis=1).astype(np.float32)


def quantize_blockwise_u8(x_flat: np.ndarray, blocksize: int = ABSMAX_BLOCK) -> Tuple[np.ndarray, np.ndarray]:
    """Blockwise 8-bit quantization with the dynamic codebook: (uint8
    codes, fp32 per-block absmax).  bitsandbytes' inner ("state2")
    quantization of the absmax stream under ``compress_statistics=True``."""
    x_flat = np.asarray(x_flat, dtype=np.float32).ravel()
    code = dynamic_code()
    absmax = _block_absmax(x_flat, blocksize)
    n = x_flat.shape[0]
    nblocks = absmax.shape[0]
    pad = nblocks * blocksize - n
    xp = np.concatenate([x_flat, np.zeros(pad, dtype=np.float32)]) if pad else x_flat
    scale = np.where(absmax > 0, absmax, np.float32(1.0))
    normalized = (xp.reshape(nblocks, blocksize) / scale[:, None]).astype(np.float32)
    codes = quantize_to_code(normalized, code).ravel()[:n]
    return codes, absmax


def pack_nibbles(idx_flat: np.ndarray) -> np.ndarray:
    """Pack 4-bit indices two per byte, the first element in the HIGH nibble."""
    idx_flat = np.asarray(idx_flat, dtype=np.uint8).ravel()
    if idx_flat.shape[0] % 2:
        idx_flat = np.concatenate([idx_flat, np.zeros(1, dtype=np.uint8)])
    pairs = idx_flat.reshape(-1, 2)
    return ((pairs[:, 0] << 4) | (pairs[:, 1] & 0xF)).astype(np.uint8)


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


def quantize_nf4(
    w: np.ndarray,
    dtype: np.dtype | None = None,
    compress_statistics: bool = True,
    quant_type: str = "nf4",
) -> QuantState:
    """Quantize a tensor to the flat 4-bit layout, with double-quantized
    statistics (``compress_statistics``) or raw fp32 ones.  ``quant_type``
    "nf4" (default) or "fp4": bnb's ``quantize_4bit(..., quant_type=...)``;
    the storage is the same, only the 16-entry codebook differs."""
    w = np.asarray(w)
    if dtype is None:
        dtype = w.dtype if w.dtype in (np.float16,) else np.dtype(np.float32)
    shape = w.shape
    w_flat = w.astype(np.float32).ravel()
    n = w_flat.shape[0]

    absmax = _block_absmax(w_flat, NF4_BLOCK)
    nblocks = absmax.shape[0]
    pad = nblocks * NF4_BLOCK - n
    wp = np.concatenate([w_flat, np.zeros(pad, dtype=np.float32)]) if pad else w_flat
    scale = np.where(absmax > 0, absmax, np.float32(1.0))
    normalized = (wp.reshape(nblocks, NF4_BLOCK) / scale[:, None]).astype(np.float32)
    idx = quantize_to_code(normalized, get_code(quant_type)).ravel()[:n]
    packed = pack_nibbles(idx)

    if compress_statistics:
        offset = np.float32(absmax.mean(dtype=np.float64))
        absmax_u8, absmax32 = quantize_blockwise_u8(absmax - offset, ABSMAX_BLOCK)
    else:
        # Raw fp32 absmax in absmax32, one per block (absmax_u8 unused):
        # bitsandbytes(compress_statistics=False).
        offset = np.float32(0.0)
        absmax_u8 = np.zeros(nblocks, dtype=np.uint8)
        absmax32 = absmax.astype(np.float32)

    return QuantState(
        packed=packed,
        absmax_u8=absmax_u8,
        absmax32=absmax32.astype(np.float32),
        offset=offset,
        shape=tuple(shape),
        dtype=np.dtype(dtype),
        blocksize=NF4_BLOCK,
        blocksize2=ABSMAX_BLOCK,
        quant_type=quant_type,
    )


def dequantize_nf4(state: QuantState, dtype: np.dtype | None = None) -> np.ndarray:
    """Dequantize to the logical shape: ``CODE[nibble] * absmax_blk`` in
    fp32, cast once to ``dtype`` (default the state's; numpy dtypes)."""
    out_dtype = np.dtype(dtype if dtype is not None else state.dtype)
    n = state.numel
    idx = unpack_nibbles(state.packed, n)
    absmax = dequantize_absmax(state)
    blk = np.arange(n) // state.blocksize
    vals = (get_code(state.quant_type)[idx] * absmax[blk]).astype(np.float32)
    return vals.astype(out_dtype).reshape(state.shape)
