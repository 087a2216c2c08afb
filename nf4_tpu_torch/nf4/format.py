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
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .reference import NF4_BLOCK, QuantState, dequantize_absmax, unpack_nibbles

__all__ = ["PackedNF4", "pack_for_tpu", "chunk_views", "pad_to"]


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


def pack_for_tpu(
    state: QuantState, dtype=torch.bfloat16, shards: int = 1, device=None
) -> PackedNF4:
    """Convert a flat (bitsandbytes-layout) QuantState to the packed layout
    on ``device`` (default ``cuda``): a pure layout change of the codes,
    with the double-quantized statistics resolved once to exact fp32 block
    scales.  The name is the JAX package's; the layout is the same."""
    dev = resolve_device(device)
    if len(state.shape) != 2:
        raise ValueError(f"expected a 2D weight, got shape {state.shape}")
    m, n = state.shape
    if n % (shards * NF4_BLOCK):
        raise ValueError(f"in_features {n} must split into {shards} chunk(s) of whole 64-blocks")
    idx = unpack_nibbles(state.packed, m * n).reshape(m, n)
    scales = dequantize_absmax(state).reshape(m, n // NF4_BLOCK)
    quant_type = state.quant_type

    n_chunk = n // shards
    m_pad = pad_to(m, 128)
    n_chunk_pad = pad_to(n_chunk, 1024)
    packed_chunks, scale_chunks = [], []
    for s in range(shards):
        idx_c = np.zeros((m_pad, n_chunk_pad), dtype=np.uint8)
        idx_c[:m, :n_chunk] = idx[:, s * n_chunk : (s + 1) * n_chunk]
        sc_c = np.zeros((m_pad, n_chunk_pad // NF4_BLOCK), dtype=np.float32)
        nb = n_chunk // NF4_BLOCK
        sc_c[:m, :nb] = scales[:, s * nb : (s + 1) * nb]
        idx_t = idx_c.T  # [n_chunk_pad, m_pad]
        packed_chunks.append(((idx_t[1::2] << 4) | (idx_t[0::2] & 0xF)).astype(np.uint8))
        scale_chunks.append(sc_c.T)

    # ascontiguousarray: concatenating one transposed chunk keeps its
    # column-major order, and the kernels take row-major tensors.
    return PackedNF4(
        packed=torch.from_numpy(np.ascontiguousarray(np.concatenate(packed_chunks, axis=0))).to(dev),
        scales=torch.from_numpy(np.ascontiguousarray(np.concatenate(scale_chunks, axis=0))).to(dev),
        shape=(m, n),
        padded_shape=(m_pad, n_chunk_pad * shards),
        dtype=dtype,
        shards=shards,
        quant_type=quant_type,
    )


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
