"""int8-recode serving mode: 4-bit weights re-stored as int8 (kernel D).

The counterpart of the JAX package's ``ops/int8_serve.py``.  A packed 4-bit
weight is re-stored as ``values = round(127 * CODE[code])`` int8, K-major
``[n_pad, m_pad]``, with ``scales' = scales * (1/127)``: the weight stays on
the 4-bit grid up to the int8 rounding of the codebook, and decoding it is
one int8 -> bf16 convert and one scale multiply.

bf16 activations on a CUDA tensor run the hand-written kernel
``csrc/int8_matmul.cu`` (at decode kernel B's mma.sync decode kernel,
``csrc/decode_mma.cuh``, with the int8 rows paired into A registers; at
prefill kernel B's pipelined wgmma main loop with an int8 decode): weight
values ``bf16(int8 * bf16(scale))``, a bf16 product with fp32
accumulation.  On a CPU tensor the plain version
:func:`_int8_matmul_plain` computes the same values.  fp32 and fp16
activations take the JAX package's XLA path (fp32 weights, fp32 product;
TF32 off), on either device.  ``NF4TPU_BACKEND`` and
``NF4TPU_MATMUL_TILE`` (``utils/env.py``) act on kernel D as on kernel B
(``ops/matmul.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..nf4.format import PackedNF4, pad_to
from ..nf4.lut import get_code
from ..nf4.reference import NF4_BLOCK
from ..utils import env
from ._cuda import Kernel
from .dequant import _OUT_KIND
from .matmul import (
    _DECODE_ROWS, _decode_ksplit, _decode_tiles, _prefill_ksplit, _prefill_layouts, _prefill_rows, _row_unit,
    _tile_counters, _tile_plan,
)

__all__ = ["PackedInt8", "recode_int8_weight", "int8_matmul"]

_KERNEL = Kernel(
    "int8_matmul", "int8_matmul", "int8_matmul_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6,
)
# Kernel D's decode kernel: its shape query (source, C symbol).
_D_DECODE = ("int8_matmul", "int8_matmul_bf16_decode_shape")

# A weight whose packed bytes exceed this recodes in chunks of whole scale
# rows, so the int64 index intermediates stay bounded (the JAX package's
# limit).
_RECODE_CHUNK_BYTES = 32 * 2**20


@dataclasses.dataclass
class PackedInt8:
    """K-major int8 recode of a 4-bit weight: ``W^T = values * scales``
    with ``scales`` expanded over blocks of 64 K rows."""

    values: torch.Tensor  # int8 [n_pad, m_pad]
    scales: torch.Tensor  # fp32 [n_pad//64, m_pad]
    shape: Tuple[int, int]  # logical (m, n)
    padded_shape: Tuple[int, int]  # (m_pad, n_pad)
    dtype: torch.dtype
    # K rows are stored as ``shards`` independently padded chunks (from the
    # source PackedNF4); activations are padded per chunk.
    shards: int = 1

    @property
    def nbytes(self) -> int:
        return self.values.numel() + self.scales.numel() * 4


def _lut8(quant_type: str, device) -> torch.Tensor:
    """round(127 * code) as int8, computed in float64 (the JAX package's)."""
    lut = np.round(127.0 * np.asarray(get_code(quant_type), np.float64)).astype(np.int8)
    return torch.from_numpy(lut).to(device)


def _recode(packed: torch.Tensor, scales: torch.Tensor, lut8: torch.Tensor):
    b = packed.to(torch.int64)
    khalf, m_pad = b.shape
    codes = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=1).reshape(2 * khalf, m_pad)
    # Multiply by the fp32 of 1/127; dividing by 127 differs in the last bit.
    return lut8[codes], scales * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=scales.device)


def recode_int8_weight(pw: PackedNF4) -> PackedInt8:
    """Convert a packed 4-bit weight to the int8 serving representation.

    K-chunked (``shards > 1``) weights need nothing special: chunk c's byte
    row j sits at global row c*half + j and expands to K rows 2(c*half + j)
    and 2(c*half + j) + 1, the global K order.  An expert-stacked weight
    (a leading ``[E]`` axis) recodes one expert at a time."""
    if pw.packed.dim() == 3:
        parts = [recode_int8_weight(dataclasses.replace(pw, packed=p, scales=sc))
                 for p, sc in zip(pw.packed.unbind(0), pw.scales.unbind(0))]
        return dataclasses.replace(parts[0], values=torch.stack([q.values for q in parts]),
                                   scales=torch.stack([q.scales for q in parts]))
    lut8 = _lut8(pw.quant_type, pw.packed.device)
    kh = pw.packed.shape[0]
    if pw.packed.numel() > _RECODE_CHUNK_BYTES:
        # Chunks of whole scale rows (32 byte rows = 64 K rows = 1 scale row).
        chunks = next(c for c in (16, 8, 4, 2, 1) if kh % c == 0 and (kh // c) % 32 == 0)
        step, srow = kh // chunks, kh // chunks // 32
        parts = [
            _recode(pw.packed[i * step : (i + 1) * step], pw.scales[i * srow : (i + 1) * srow], lut8)
            for i in range(chunks)
        ]
        values = torch.cat([p[0] for p in parts])
        scales = torch.cat([p[1] for p in parts])
    else:
        values, scales = _recode(pw.packed, pw.scales, lut8)
    return PackedInt8(
        values=values.contiguous(), scales=scales.contiguous(), shape=pw.shape,
        padded_shape=pw.padded_shape, dtype=pw.dtype, shards=pw.shards,
    )


def _int8_weight_t(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """W^T [n_pad, m_pad] as kernel D decodes it: bf16(int8 * bf16(scale))
    (a product of an 8-bit integer and a bf16 value is exact in fp32, so
    one rounding)."""
    sexp = scales.to(torch.bfloat16).float().repeat_interleave(NF4_BLOCK, dim=0)
    return (values.float() * sexp).to(torch.bfloat16)


def _int8_matmul_plain(x_pad, values, scales, out_dtype) -> torch.Tensor:
    """The plain version of kernel D: x bf16 [B, n_pad] -> [B, m_pad]."""
    return (x_pad.float() @ _int8_weight_t(values, scales).float()).to(out_dtype)


def _int8_matmul_exact(x_pad, values, scales, out_dtype) -> torch.Tensor:
    """fp32 weights and an fp32 product: the JAX package's XLA path for
    fp32/fp16 activations (``_int8_matmul_jnp``).  On CUDA the product is
    full fp32 as long as ``torch.backends.cuda.matmul.allow_tf32`` keeps
    its default, False."""
    n_pad, m_pad = values.shape
    w = (values.float().reshape(n_pad // NF4_BLOCK, NF4_BLOCK, m_pad) * scales[:, None, :]).reshape(n_pad, m_pad)
    return (x_pad.float() @ w).to(out_dtype)


def _int8_matmul_kernel(x_pad, values, scales, out_dtype, rows=None) -> torch.Tensor:
    """Launch kernel D on CUDA tensors; x_pad rows a multiple of
    :func:`~nf4_tpu_torch.ops.matmul._pick_bm` (16: the decode kernel, which
    sums its K splits itself; 64: the prefill kernel, which masks its
    ragged last row tile).  ``rows`` forces a prefill layout (256 x 128 or
    128 x 256 blocks); by default kernel B's
    :func:`~nf4_tpu_torch.ops.matmul._prefill_rows` picks it."""
    b_pad, n_pad = x_pad.shape
    if x_pad.dtype != torch.bfloat16 or values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("kernel D takes bf16 x, int8 values and fp32 scales")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"output dtype {out_dtype} not in {list(_OUT_KIND)}")
    m_pad = values.shape[1]
    bm = _row_unit(b_pad)
    if values.shape[0] != n_pad or n_pad % NF4_BLOCK or m_pad % 128 or b_pad % bm:
        raise ValueError(f"bad shapes: x {tuple(x_pad.shape)}, values {tuple(values.shape)}")
    if scales.shape != (n_pad // NF4_BLOCK, m_pad):
        raise ValueError(f"bad scales shape {tuple(scales.shape)}")
    if not (x_pad.is_contiguous() and values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("kernel D needs contiguous operands")
    if not (x_pad.device == values.device == scales.device):
        raise ValueError("operands on different devices")
    dev = x_pad.device
    tile = env.matmul_tile_override()
    if tile is not None:
        bm, ksplit = _tile_plan("kernel D", tile, n_pad, m_pad, dev, _D_DECODE, _prefill_layouts(m_pad), NF4_BLOCK)
    counters = None
    if bm == _DECODE_ROWS:
        if tile is None:
            ksplit = _decode_ksplit(b_pad, m_pad, n_pad // NF4_BLOCK, dev, _D_DECODE)
        counters = _tile_counters(dev, _decode_tiles(b_pad, m_pad, dev, _D_DECODE)).data_ptr()
    elif tile is None:
        bm = rows or _prefill_rows(b_pad, m_pad)
        ksplit = _prefill_ksplit(m_pad, n_pad // NF4_BLOCK, dev)
    return _launch_d(x_pad, values, scales, out_dtype, bm, counters, ksplit)


def _launch_d(x_pad, values, scales, out_dtype, bm, counters, ksplit) -> torch.Tensor:
    """Allocate the output (and the K-split partials) and launch kernel D
    as it is told: blocks of ``bm`` rows, ``ksplit`` K splits,
    ``counters`` the decode kernel's tile counters (a pointer or None)."""
    (b_pad, n_pad), m_pad, dev = x_pad.shape, values.shape[1], x_pad.device
    out = torch.empty((b_pad, m_pad), dtype=out_dtype, device=dev)
    work = torch.empty((ksplit, b_pad, m_pad), dtype=torch.float32, device=dev) if ksplit > 1 else None
    _KERNEL(x_pad.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), counters, b_pad, n_pad, m_pad, bm, ksplit,
            _OUT_KIND[out_dtype])
    return out


def int8_matmul(x: torch.Tensor, p8: PackedInt8, out_dtype=None, prefill: bool = False) -> torch.Tensor:
    """``x @ W^T`` for an int8-recoded weight of logical shape [m, n]; ``x``
    has any leading batch shape and trailing dim n.  ``prefill``: the rows
    are prompt tokens, which take the prefill kernel whatever their count
    (see :func:`~nf4_tpu_torch.ops.matmul._pick_bm`)."""
    m, n = p8.shape
    m_pad, n_pad = p8.padded_shape
    *batch, xn = x.shape
    assert xn == n, f"x trailing dim {xn} != in_features {n}"
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    B = 1
    for d in batch:
        B *= d
    x2 = x.reshape(B, n)
    kernel = x2.dtype == torch.bfloat16 and env.use_kernel(x2)
    b_pad = pad_to(max(B, 1), _row_unit(B, prefill) if kernel else 16)
    if n_pad != n:
        # Pad per K chunk: each chunk's rows are padded on their own.
        s = p8.shards
        x2 = torch.nn.functional.pad(x2.reshape(B, s, n // s), (0, n_pad // s - n // s)).reshape(B, n_pad)
    if b_pad != B:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, b_pad - B))
    if x2.dtype != torch.bfloat16:
        fn = _int8_matmul_exact
    else:
        fn = _int8_matmul_kernel if kernel else _int8_matmul_plain
    y = fn(x2.contiguous(), p8.values, p8.scales, out_dtype)
    return y[:B, :m].reshape(*batch, m)
