"""The packed NF4 weight format, over torch tensors.

Byte for byte the JAX package's layout (``nf4_tpu/nf4/format.py``), so
packed checkpoints and the NumPy oracle are shared:

* The semantic weight is ``W[m, n]`` (m = out_features, n = in_features;
  4-bit blocks of 64 run along n, as in bitsandbytes).
* Storage is transposed, K-major: ``packed[j, r]`` (uint8,
  ``[n_pad/2, m_pad]``) holds ``W^T[2j, r]`` in its LOW nibble and
  ``W^T[2j+1, r]`` in its HIGH nibble.
* ``scales[g, r]`` (fp32, ``[n_pad/64, m_pad]``) is the fully dequantized
  scale of rows ``[64g, 64g+64)`` of ``W^T``.
* n is padded to a multiple of 1024 and m to a multiple of 128; padding
  carries scale 0 and so dequantizes to exact 0.

``shards > 1`` packs the K dimension as ``shards`` independent chunks, each
padded and pair-packed on its own (the row-parallel layout).

:class:`QDense` is the host-side intermediate between a flat
(bitsandbytes-layout) :class:`QuantState` and the packed layout: per-element
codes and exact fp32 block scales, so fusing and splitting rows stays exact
and :func:`pack_codes_for_tpu` carries the codes through untouched.
:func:`quantize_for_tpu` quantizes a dense weight straight into the packed
layout, with the NumPy oracle, the C++ host quantizer (``nf4.native``) or on
the device (``nf4.fast_quant``), byte-identical every way;
:func:`to_quant_state` goes back to the flat layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .lut import get_code
from .reference import (
    ABSMAX_BLOCK, NF4_BLOCK, QuantState, dequantize_absmax, pack_nibbles, quantize_nf4, unpack_nibbles,
)

__all__ = [
    "PackedNF4",
    "QDense",
    "pack_for_tpu",
    "pack_codes_for_tpu",
    "qdense_from_state",
    "quantize_for_tpu",
    "chunk_views",
    "to_quant_state",
    "pad_to",
]


def pad_to(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


@dataclasses.dataclass
class PackedNF4:
    """One 4-bit weight in the packed layout (see module docstring)."""

    packed: torch.Tensor  # uint8 [n_pad//2, m_pad]
    scales: torch.Tensor  # fp32  [n_pad//64, m_pad]
    shape: Tuple[int, int]  # logical (m, n)
    padded_shape: Tuple[int, int]  # (m_pad, n_pad)
    dtype: torch.dtype  # default output dtype
    shards: int = 1
    quant_type: str = "nf4"  # "nf4" or "fp4": the table the nibbles index

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + self.scales.numel() * 4


def _absmax_grid(state: QuantState) -> np.ndarray:
    """Per-(row, block) fp32 scales [m, n // 64] of a flat QuantState."""
    m, n = state.shape
    if n % NF4_BLOCK:
        raise ValueError(f"in_features must be a multiple of {NF4_BLOCK}, got {n}")
    return dequantize_absmax(state).reshape(m, n // NF4_BLOCK)


@dataclasses.dataclass
class QDense:
    """A quantized but unpacked weight, on the host: per-element 4-bit
    codebook indices and exactly dequantized fp32 per-64-block scales.
    Rows (out-features) are rows of both, so fusing q/k/v or splitting a
    pre-fused tensor is plain indexing, and packing it is free of any
    dequantization."""

    codes: np.ndarray  # uint8 [m, n] codebook indices
    scales: np.ndarray  # fp32 [m, n // 64] dequantized block scales
    quant_type: str = "nf4"

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.codes.shape)

    @property
    def nbytes(self) -> int:
        return self.codes.nbytes + self.scales.nbytes

    def rows(self, r0: int, r1: int) -> "QDense":
        """Out-feature (row) slice: exact, the scales are per row."""
        return QDense(self.codes[r0:r1], self.scales[r0:r1], self.quant_type)

    def to_dense(self) -> np.ndarray:
        """Exact fp32 dequantization (``CODE[idx] * scale_block``)."""
        vals = get_code(self.quant_type)[self.codes]
        return vals * np.repeat(self.scales, NF4_BLOCK, axis=1)


def qdense_from_state(state: QuantState) -> QDense:
    """A flat QuantState's codes and exactly dequantized scales (the
    double-quantized statistics resolved to fp32 once)."""
    if len(state.shape) != 2:
        raise ValueError(f"expected a 2D weight, got shape {state.shape}")
    m, n = state.shape
    codes = unpack_nibbles(state.packed, m * n).reshape(m, n)
    return QDense(codes, _absmax_grid(state), state.quant_type)


def _pack_codes(codes: torch.Tensor, scales: torch.Tensor, dtype, shards: int, quant_type: str) -> PackedNF4:
    """Codes uint8 [m, n] and fp32 scales [m, n // 64], both on the target
    device, into the packed layout there: each K chunk padded, transposed
    and pair-packed (K row 2j low nibble, 2j+1 high), its scales padded
    with 0 and transposed."""
    m, n = codes.shape
    if n % (shards * NF4_BLOCK):
        raise ValueError(f"in_features {n} must split into {shards} chunk(s) of whole {NF4_BLOCK}-blocks")
    if tuple(scales.shape) != (m, n // NF4_BLOCK):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(m, n // NF4_BLOCK)}")
    n_chunk = n // shards
    m_pad, n_chunk_pad = pad_to(m, 128), pad_to(n_chunk, 1024)
    nb = n_chunk // NF4_BLOCK
    packed_chunks, scale_chunks = [], []
    for s in range(shards):
        idx_t = torch.nn.functional.pad(codes[:, s * n_chunk : (s + 1) * n_chunk].t(),
                                        (0, m_pad - m, 0, n_chunk_pad - n_chunk))  # [n_chunk_pad, m_pad]
        packed_chunks.append((idx_t[1::2] << 4) | (idx_t[0::2] & 0xF))
        scale_chunks.append(torch.nn.functional.pad(scales[:, s * nb : (s + 1) * nb].t(),
                                                    (0, m_pad - m, 0, n_chunk_pad // NF4_BLOCK - nb)))
    return PackedNF4(
        packed=torch.cat(packed_chunks).contiguous(),
        scales=torch.cat(scale_chunks).contiguous(),
        shape=(m, n),
        padded_shape=(m_pad, n_chunk_pad * shards),
        dtype=dtype,
        shards=shards,
        quant_type=quant_type,
    )


def pack_codes_for_tpu(
    idx, scales, dtype=torch.bfloat16, shards: int = 1, quant_type: str = "nf4", device=None
) -> PackedNF4:
    """Per-element codes uint8 [m, n] and fp32 block scales [m, n // 64]
    (numpy) into the packed layout on ``device`` (default ``cuda``): a
    layout change only, so externally quantized codes (bnb checkpoints)
    round-trip bit for bit.  The name is the JAX package's."""
    dev = resolve_device(device)
    codes = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.uint8)).to(dev)
    sc = torch.from_numpy(np.ascontiguousarray(scales, dtype=np.float32)).to(dev)
    return _pack_codes(codes, sc, dtype, shards, quant_type)


def pack_for_tpu(
    state: QuantState, dtype=torch.bfloat16, shards: int = 1, device=None
) -> PackedNF4:
    """Convert a flat (bitsandbytes-layout) QuantState to the packed layout
    on ``device`` (default ``cuda``): a pure layout change of the codes,
    with the double-quantized statistics resolved once to exact fp32 block
    scales.  The name is the JAX package's; the layout is the same."""
    qd = qdense_from_state(state)
    return pack_codes_for_tpu(qd.codes, qd.scales, dtype, shards, state.quant_type, device)


def _host_fp32(w) -> np.ndarray:
    """A dense weight (torch tensor or array) as a host fp32 array: the
    upcast of bf16 and fp16 values is exact."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, dtype=np.float32)


_METHODS = ("auto", "oracle", "device", "native")
# ``method="auto"`` sends a weight of at least this many elements bound for
# a card to the card quantizer (the JAX package's size rule).
_DEVICE_MIN_NUMEL = 1 << 22


def quantize_for_tpu(
    w, dtype=torch.bfloat16, shards: int = 1, method: str = "auto", quant_type: str = "nf4", device=None
) -> PackedNF4:
    """Quantize a dense [m, n] weight (torch tensor or numpy array; fp32,
    bf16 or fp16) straight into the packed layout on ``device`` (default
    ``cuda``), with bitsandbytes' statistics (double-quantized absmax,
    dynamic code, offset) resolved to fp32 block scales.

    ``method``: ``"oracle"`` runs the NumPy oracle (``nf4.reference``) on
    the host; ``"native"`` the C++ host quantizer (``nf4.native``; raises
    when it cannot be built or ``NF4TPU_NATIVE=0``); ``"device"``
    ``nf4.fast_quant`` on ``device``; ``"auto"`` the card quantizer for a
    weight of at least 2^22 elements bound for a card, else ``"native"``
    where it is available, else ``"device"`` on whatever device the weight
    goes to.  All give the same bytes.  ``shards > 1`` (tensor-parallel
    packing) is not ported yet."""
    if method not in _METHODS:
        raise ValueError(f"method={method!r}; expected {'|'.join(_METHODS)}")
    if shards != 1:
        raise NotImplementedError("not ported yet: shards > 1 (tensor-parallel packing)")
    get_code(quant_type)  # raises for an unknown quant_type
    dev = resolve_device(device)
    from . import native

    if method == "auto":
        if int(np.prod(np.shape(w))) >= _DEVICE_MIN_NUMEL and dev.type == "cuda":
            method = "device"
        elif native.available():
            method = "native"
        else:
            method = "device"
    if method == "oracle":
        state = quantize_nf4(_host_fp32(w), dtype=np.float16, quant_type=quant_type)
        return pack_for_tpu(state, dtype=dtype, device=dev)
    if method == "native":
        return native.quantize_for_tpu_native(w, dtype=dtype, quant_type=quant_type, device=dev)
    from .fast_quant import quantize_for_tpu_device

    return quantize_for_tpu_device(w, dtype=dtype, quant_type=quant_type, device=dev)


def chunk_views(pw: PackedNF4) -> list:
    """Split a ``shards > 1`` weight into per-chunk standalone views (row
    slices of ``packed``/``scales``, no copy).  Chunk s covers in-features
    ``[s*n/shards, (s+1)*n/shards)``."""
    if pw.shards == 1:
        return [pw]
    m, n = pw.shape
    m_pad, n_pad = pw.padded_shape
    n_chunk_pad = n_pad // pw.shards
    half = n_chunk_pad // 2
    srows = n_chunk_pad // NF4_BLOCK
    return [
        PackedNF4(
            packed=pw.packed[s * half : (s + 1) * half],
            scales=pw.scales[s * srows : (s + 1) * srows],
            shape=(m, n // pw.shards),
            padded_shape=(m_pad, n_chunk_pad),
            dtype=pw.dtype,
            shards=1,
            quant_type=pw.quant_type,
        )
        for s in range(pw.shards)
    ]


def to_quant_state(pw: PackedNF4, dtype=torch.float16) -> QuantState:
    """The inverse of :func:`pack_for_tpu` over the logical region: a flat
    (bitsandbytes-layout) state whose dequantized values are ``pw``'s, bit
    for bit.  The scales are carried uncompressed in ``absmax32`` (the
    packed layout holds them fully dequantized; re-deriving uint8 codes
    would lose bits), with ``absmax_u8`` zeros and ``offset`` 0.  ``dtype``
    is recorded as numpy's where numpy has it (fp16, fp32)."""
    m, n = pw.shape
    n_chunk = n // pw.shards
    idx_parts, scale_parts = [], []
    for view in chunk_views(pw):
        packed = view.packed.cpu().numpy()
        idx_t = np.empty((2 * packed.shape[0], packed.shape[1]), dtype=np.uint8)
        idx_t[0::2] = packed & 0xF
        idx_t[1::2] = packed >> 4
        idx_parts.append(idx_t.T[:m, :n_chunk])
        scale_parts.append(view.scales.cpu().numpy().T[:m, : n_chunk // NF4_BLOCK])
    idx = np.concatenate(idx_parts, axis=1)
    scales = np.concatenate(scale_parts, axis=1)  # [m, n // 64]
    dtype = {torch.float16: np.float16, torch.float32: np.float32}.get(dtype, dtype)
    return QuantState(
        packed=pack_nibbles(idx.ravel()),
        absmax_u8=np.zeros(m * n // NF4_BLOCK, dtype=np.uint8),
        absmax32=scales.ravel().astype(np.float32),
        offset=np.float32(0.0),
        shape=(m, n),
        dtype=dtype if isinstance(dtype, torch.dtype) else np.dtype(dtype),
        blocksize=NF4_BLOCK,
        blocksize2=ABSMAX_BLOCK,
        quant_type=pw.quant_type,
    )
