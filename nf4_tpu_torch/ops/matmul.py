"""Fused 4-bit dequant-matmul ``y = x @ W^T`` with W kept packed (kernels B
and E), and its gradient with respect to ``x``.

bf16 activations on a CUDA tensor run the hand-written kernel
``csrc/matmul.cu`` (kernel B: mma.sync with the weights as the A operand
at decode, a pipelined wgmma dequant-GEMM at prefill): weight values ``bf16(bf16(code) *
bf16(scale))``, a bf16 product with fp32 accumulation, within the 2e-2
contract of the JAX package's bf16 path.  fp32 and fp16 activations run
``csrc/matmul_exact.cu`` (kernel E: SIMT FFMA at decode, 3xTF32 on wgmma at
prefill): the oracle's fp32 weight values and an fp32 product with fp32
accumulation, the JAX package's exact path, within 1e-5 of the largest
output.  On a CPU tensor the plain versions :func:`_matmul_bf16_plain` and
:func:`_matmul_exact_plain` compute the same values.

The backward is the JAX package's custom VJP (``_nf4_matmul_bwd``): the
packed weight is frozen (the QLoRA contract), so only ``x`` gets a
gradient, ``dx = g @ W`` with W dequantized exactly to fp32 (kernel A on
CUDA) and a true fp32 product, cast to ``x``'s dtype.  Nothing but the
packed weight is kept for the backward.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..nf4.format import PackedNF4, chunk_views, pad_to
from ..nf4.reference import NF4_BLOCK
from . import _cuda
from ._cuda import Kernel
from .dequant import _OUT_KIND, _bf16_weight_t, _dequant_t_plain, dequantize_t
from .lut_eval import byte_word_table, code_tensor

__all__ = ["nf4_matmul"]

_KERNEL = Kernel(
    "matmul_bf16", "matmul", "nf4_matmul_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2,
)
_EXACT_KERNEL = Kernel(
    "matmul_exact", "matmul_exact", "nf4_matmul_exact",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 2,
)
_X_KIND = {torch.float32: 0, torch.float16: 2}


@contextlib.contextmanager
def _ieee_fp32():
    """fp32 matrix products in full fp32 inside the block, whatever
    ``torch.set_float32_matmul_precision`` says outside it (the JAX
    package's ``Precision.HIGHEST``).  The setting is process-wide: it is
    set and restored around the product."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _matmul_bf16_plain(x_pad, packed, scales, out_dtype, quant_type="nf4") -> torch.Tensor:
    """The plain version of kernel B: x bf16 [B, n_pad] -> [B, m_pad]."""
    wt = _bf16_weight_t(packed, scales, quant_type)
    return (x_pad.float() @ wt.float()).to(out_dtype)


def _matmul_exact_plain(x_pad, packed, scales, out_dtype, quant_type="nf4") -> torch.Tensor:
    """The plain version of kernel E: fp32 weights (exact dequant), fp32
    product, for fp32/fp16 activations."""
    wt = _dequant_t_plain(packed, scales, torch.float32, quant_type)
    with _ieee_fp32():
        return (x_pad.float() @ wt).to(out_dtype)


def _pick_bm(b: int) -> int:
    """The multiple the batch rows are padded to: 16 for decode-sized
    batches (the decode kernels of B, D and E), else 64 (their prefill
    blocks of 128 or 256 rows mask their ragged last tile)."""
    return 16 if b <= 16 else 64


def _pick_ksplit(tiles: int, nkb: int, device) -> int:
    """K splits so the (columns x rows) tiles times the splits give at least
    two blocks per SM; 1 when the tiles alone do."""
    want = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    if tiles >= want:
        return 1
    return _even_splits(nkb, min(nkb, -(-want // tiles)))


def _even_splits(nkb: int, ksplit: int) -> int:
    per = -(-nkb // ksplit)
    return -(-nkb // per)  # no empty split


# Kernel B's decode blocks: 16 batch rows each; their columns and
# occupancy come from the built library.
_DECODE_ROWS = 16
_DECODE_SHAPE: dict = {}
_TILE_COUNTERS: dict = {}


def _decode_shape(device) -> tuple:
    """(output columns per block, resident blocks per SM) of kernel B's
    decode kernel, as the built library reports them (once per library
    and device)."""
    lib = _cuda._load("matmul")
    key = (lib, torch.device(device))
    if key not in _DECODE_SHAPE:
        fn = lib.nf4_matmul_bf16_decode_shape
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        cols, blocks = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[1]):
            err = fn(ctypes.byref(cols), ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"kernel B's decode occupancy query failed (error {err}, {blocks.value} blocks)")
        _DECODE_SHAPE[key] = (cols.value, blocks.value)
    return _DECODE_SHAPE[key]


def _decode_tiles(b_pad: int, m_pad: int, device) -> int:
    """Output tiles of kernel B's decode kernel (the last may be ragged)."""
    return -(-m_pad // _decode_shape(device)[0]) * (b_pad // _DECODE_ROWS)


def _decode_ksplit(b_pad: int, m_pad: int, nkb: int, device) -> int:
    """K splits for kernel B's decode blocks: one wave of every SM's
    resident blocks (``_wave_ksplit``)."""
    return _wave_ksplit(_decode_tiles(b_pad, m_pad, device), nkb, device, _decode_shape(device)[1])


def _tile_counters(device, tiles: int) -> torch.Tensor:
    """The decode kernel's per-output-tile counters on ``device``: int32,
    zeroed once when allocated; every launch leaves them at zero again, so
    no launch needs a memset (and a CUDA graph may capture it).  Launches
    that use them must not run concurrently on two streams."""
    buf = _TILE_COUNTERS.get(device)
    if buf is None or buf.numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("kernel B's tile counters must be allocated before CUDA graph capture")
        buf = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _TILE_COUNTERS[device] = buf
    return buf


# Kernel B's prefill layouts, by the rows of a block: its columns (256
# rows: 4 consumer warpgroups; 128 rows: 2).
_PREFILL_COLS = {256: 128, 128: 256}


def _prefill_rows(b_pad: int, m_pad: int) -> int:
    """The rows of kernel B's prefill blocks: 128 x 256 up to 128 rows
    where m_pad allows, else 256 x 128.  On the H100 the 128-row blocks
    win only there (1.54x at 64 rows, 1.32x at 128; from 192 rows on the
    256-row blocks win, 1.24x at 1024: ``utils/kernel_variants.py --only
    layouts``)."""
    return 128 if b_pad <= 128 and m_pad % 256 == 0 else 256


def _wave_ksplit(tiles: int, nsteps: int, device, blocks_per_sm: int = 1) -> int:
    """K splits of ``nsteps`` steps for ``tiles`` output tiles, with
    ``blocks_per_sm`` blocks resident on each SM: as many as fit in one wave
    beside the tiles, so a short prompt still fills the card and a long one
    is not split into a second wave (which would leave most SMs idle); no
    empty split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _even_splits(nsteps, max(1, min(nsteps, sms * blocks_per_sm // tiles)))


def _prefill_ksplit(b_pad: int, m_pad: int, nkb: int, rows: int, device) -> int:
    """K splits for kernel B's (and D's) prefill blocks of ``rows`` rows."""
    return _wave_ksplit(-(-b_pad // rows) * (m_pad // _PREFILL_COLS[rows]), nkb, device)


# Kernel E's prefill blocks: 128 rows x 128 columns, K steps of 32 rows.
_EXACT_ROWS, _EXACT_KS = 128, 32


def _check_operands(label, x_pad, packed, scales, out_dtype) -> int:
    """The shape, layout and device checks kernels B and E share; returns
    the batch rows per block."""
    b_pad, n_pad = x_pad.shape
    khalf, m_pad = packed.shape
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"output dtype {out_dtype} not in {list(_OUT_KIND)}")
    bm = _pick_bm(b_pad)
    if n_pad != 2 * khalf or n_pad % NF4_BLOCK or m_pad % 128 or b_pad % bm:
        raise ValueError(f"bad shapes: x {tuple(x_pad.shape)}, packed {tuple(packed.shape)}")
    if scales.shape != (n_pad // NF4_BLOCK, m_pad):
        raise ValueError(f"bad scales shape {tuple(scales.shape)}")
    if not (x_pad.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{label} needs contiguous operands")
    if not (x_pad.device == packed.device == scales.device):
        raise ValueError("operands on different devices")
    return bm


def _launch(kernel, x_pad, packed, scales, out_dtype, bm, table_ptr, *mid, ksplit=None):
    """Allocate the output (and the K-split partials) and launch ``kernel``
    (C arguments: x, packed, scales, table, out, partials, b_pad, n_pad,
    m_pad, bm, *mid, ksplit, out kind).  ``ksplit`` defaults to the split
    for blocks of ``bm`` rows x 128 columns."""
    b_pad, n_pad = x_pad.shape
    m_pad = packed.shape[1]
    dev = x_pad.device
    if ksplit is None:
        ksplit = _pick_ksplit((m_pad // 128) * (b_pad // bm), n_pad // NF4_BLOCK, dev)
    out = torch.empty((b_pad, m_pad), dtype=out_dtype, device=dev)
    work = (
        torch.empty((ksplit, b_pad, m_pad), dtype=torch.float32, device=dev)
        if ksplit > 1 else None
    )
    kernel(x_pad.data_ptr(), packed.data_ptr(), scales.data_ptr(), table_ptr,
           out.data_ptr(), None if work is None else work.data_ptr(),
           b_pad, n_pad, m_pad, bm, *mid, ksplit, _OUT_KIND[out_dtype])
    return out


def _matmul_bf16_kernel(x_pad, packed, scales, out_dtype, quant_type="nf4", rows=None) -> torch.Tensor:
    """Launch kernel B on CUDA tensors; x_pad rows a multiple of
    :func:`_pick_bm` (16: the decode kernel, which sums its K splits
    itself; 64: the prefill kernel, which masks its ragged last row tile).
    ``rows`` forces a prefill layout (see ``_PREFILL_COLS``); by default
    :func:`_prefill_rows` picks it."""
    if x_pad.dtype != torch.bfloat16 or packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("kernel B takes bf16 x, uint8 packed and fp32 scales")
    bm = _check_operands("kernel B", x_pad, packed, scales, out_dtype)
    table = byte_word_table(quant_type, x_pad.device)
    (b_pad, n_pad), m_pad = x_pad.shape, packed.shape[1]
    if bm == _DECODE_ROWS:
        ksplit = _decode_ksplit(b_pad, m_pad, n_pad // NF4_BLOCK, x_pad.device)
        counters = _tile_counters(x_pad.device, _decode_tiles(b_pad, m_pad, x_pad.device)).data_ptr()
    else:
        bm = rows or _prefill_rows(b_pad, m_pad)
        ksplit = _prefill_ksplit(b_pad, m_pad, n_pad // NF4_BLOCK, bm, x_pad.device)
        counters = None
    return _launch(_KERNEL, x_pad, packed, scales, out_dtype, bm, table.data_ptr(), counters, ksplit=ksplit)


def _matmul_exact_kernel(x_pad, packed, scales, out_dtype, quant_type="nf4") -> torch.Tensor:
    """Launch kernel E on CUDA tensors: fp32 or fp16 x_pad, rows a multiple
    of :func:`_pick_bm` (16: the SIMT decode kernel; 64: the 3xTF32 prefill
    kernel, whose pre-pass splits x into the scratch allocated here)."""
    if x_pad.dtype not in _X_KIND or packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("kernel E takes fp32 or fp16 x, uint8 packed and fp32 scales")
    bm = _check_operands("kernel E", x_pad, packed, scales, out_dtype)
    if x_pad.data_ptr() % 16:  # the kernels read x in 16- (fp16: 8-) byte pieces
        x_pad = x_pad.clone()
    code = code_tensor(quant_type, x_pad.device)
    if bm == 16:
        return _launch(_EXACT_KERNEL, x_pad, packed, scales, out_dtype, bm, code.data_ptr(),
                       _X_KIND[x_pad.dtype], None)
    (b_pad, n_pad), m_pad = x_pad.shape, packed.shape[1]
    halves = 2 if x_pad.dtype == torch.float32 else 1  # x_hi and x_lo; fp16 x is exact in tf32
    xsplit = torch.empty((halves, b_pad, n_pad), dtype=torch.float32, device=x_pad.device)
    ksplit = _wave_ksplit(-(-b_pad // _EXACT_ROWS) * (m_pad // 128), n_pad // _EXACT_KS, x_pad.device)
    return _launch(_EXACT_KERNEL, x_pad, packed, scales, out_dtype, _EXACT_ROWS, code.data_ptr(),
                   _X_KIND[x_pad.dtype], xsplit.data_ptr(), ksplit=ksplit)


def _nf4_matmul_impl(x: torch.Tensor, pw: PackedNF4, out_dtype) -> torch.Tensor:
    """The single-shard forward: pad, flatten the batch, dispatch."""
    m, n = pw.shape
    m_pad, n_pad = pw.padded_shape
    *batch, xn = x.shape
    assert xn == n, f"x trailing dim {xn} != in_features {n}"
    B = 1
    for d in batch:
        B *= d
    x2 = x.reshape(B, n)
    b_pad = pad_to(max(B, 1), _pick_bm(B) if x2.is_cuda else 16)
    if b_pad != B or n_pad != n:
        x2 = torch.nn.functional.pad(x2, (0, n_pad - n, 0, b_pad - B))
    if x2.dtype == torch.bfloat16:
        fn = _matmul_bf16_kernel if x2.is_cuda else _matmul_bf16_plain
    else:
        fn = _matmul_exact_kernel if x2.is_cuda else _matmul_exact_plain
    y = fn(x2.contiguous(), pw.packed, pw.scales, out_dtype, pw.quant_type)
    return y[:B, :m].reshape(*batch, m)


class _NF4Matmul(torch.autograd.Function):
    """``x @ W^T`` differentiable in ``x`` only (the JAX package's
    ``_nf4_matmul_vjp``)."""

    @staticmethod
    def forward(ctx, x, pw, out_dtype):
        ctx.pw, ctx.x_dtype = pw, x.dtype  # the packed weight, no activations
        return _nf4_matmul_impl(x, pw, out_dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        wt = dequantize_t(ctx.pw, torch.float32)  # [n, m], kernel A on CUDA
        with _ieee_fp32():
            dx = g.float() @ wt.T
        return dx.to(ctx.x_dtype), None, None


def nf4_matmul(x: torch.Tensor, pw: PackedNF4, out_dtype=None) -> torch.Tensor:
    """``x @ W^T`` for packed ``W`` of logical shape [m, n]; ``x`` has any
    leading batch shape and trailing dim n.  ``shards > 1`` sums the
    per-chunk partial products (autograd sums their gradients).
    Differentiable with respect to ``x``; ``W`` is frozen."""
    m, n = pw.shape
    if pw.shards > 1:
        n_chunk = n // pw.shards
        parts = [
            nf4_matmul(x[..., s * n_chunk : (s + 1) * n_chunk], v, out_dtype=out_dtype)
            for s, v in enumerate(chunk_views(pw))
        ]
        return sum(parts[1:], parts[0])
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        return _NF4Matmul.apply(x, pw, out_dtype)
    return _nf4_matmul_impl(x, pw, out_dtype)
