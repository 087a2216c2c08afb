"""Fused 4-bit dequant-matmul ``y = x @ W^T`` with W kept packed (kernel B).

bf16 activations on a CUDA tensor run the hand-written kernel
``csrc/matmul.cu``: weight values ``bf16(bf16(code) * bf16(scale))``, a
bf16 product with fp32 accumulation, within the 2e-2 contract of the JAX
package's bf16 path.  On a CPU tensor the plain version
:func:`_matmul_bf16_plain` computes the same values.

fp32 and fp16 activations take the JAX package's exact path (fp32 weights,
fp32 product): on the CPU as plain PyTorch, on CUDA not yet, because their
kernel (the JAX package's ``_matmul_pallas_exact``) is not ported yet.  The
backward (``dx = g @ W``) waits for the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from ..nf4.format import PackedNF4, chunk_views, pad_to
from ..nf4.reference import NF4_BLOCK
from ._cuda import Kernel
from .dequant import _OUT_KIND, _bf16_weight_t, _dequant_t_plain
from .lut_eval import byte_word_table

__all__ = ["nf4_matmul"]

_KERNEL = Kernel(
    "matmul_bf16", "matmul", "nf4_matmul_bf16",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6,
)


def _matmul_bf16_plain(x_pad, packed, scales, out_dtype, quant_type="nf4") -> torch.Tensor:
    """The plain version of kernel B: x bf16 [B, n_pad] -> [B, m_pad]."""
    wt = _bf16_weight_t(packed, scales, quant_type)
    return (x_pad.float() @ wt.float()).to(out_dtype)


def _matmul_exact_plain(x_pad, packed, scales, out_dtype, quant_type="nf4") -> torch.Tensor:
    """fp32 weights (exact dequant), fp32 product: the JAX package's exact
    path, for fp32/fp16 activations."""
    wt = _dequant_t_plain(packed, scales, torch.float32, quant_type)
    return (x_pad.float() @ wt).to(out_dtype)


def _pick_bm(b: int) -> int:
    """Batch rows per block: 16 for decode-sized batches, else 64."""
    return 16 if b <= 16 else 64


def _pick_ksplit(tiles: int, nkb: int, device) -> int:
    """K splits so the (columns x rows) tiles times the splits give at least
    two blocks per SM; 1 when the tiles alone do."""
    want = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    if tiles >= want:
        return 1
    ksplit = min(nkb, -(-want // tiles))
    per = -(-nkb // ksplit)
    return -(-nkb // per)  # no empty split


def _matmul_bf16_kernel(x_pad, packed, scales, out_dtype, quant_type="nf4") -> torch.Tensor:
    """Launch kernel B on CUDA tensors; x_pad rows a multiple of the block
    rows (see :func:`_pick_bm`)."""
    b_pad, n_pad = x_pad.shape
    khalf, m_pad = packed.shape
    if x_pad.dtype != torch.bfloat16 or packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("kernel B takes bf16 x, uint8 packed and fp32 scales")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"output dtype {out_dtype} not in {list(_OUT_KIND)}")
    bm = _pick_bm(b_pad)
    if n_pad != 2 * khalf or n_pad % NF4_BLOCK or m_pad % 128 or b_pad % bm:
        raise ValueError(f"bad shapes: x {tuple(x_pad.shape)}, packed {tuple(packed.shape)}")
    if scales.shape != (n_pad // NF4_BLOCK, m_pad):
        raise ValueError(f"bad scales shape {tuple(scales.shape)}")
    if not (x_pad.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("kernel B needs contiguous operands")
    if not (x_pad.device == packed.device == scales.device):
        raise ValueError("operands on different devices")
    dev = x_pad.device
    ksplit = _pick_ksplit((m_pad // 128) * (b_pad // bm), n_pad // NF4_BLOCK, dev)
    out = torch.empty((b_pad, m_pad), dtype=out_dtype, device=dev)
    work = (
        torch.empty((ksplit, b_pad, m_pad), dtype=torch.float32, device=dev)
        if ksplit > 1 else None
    )
    table = byte_word_table(quant_type, dev)
    _KERNEL(x_pad.data_ptr(), packed.data_ptr(), scales.data_ptr(), table.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(),
            b_pad, n_pad, m_pad, bm, ksplit, _OUT_KIND[out_dtype])
    return out


def nf4_matmul(x: torch.Tensor, pw: PackedNF4, out_dtype=None) -> torch.Tensor:
    """``x @ W^T`` for packed ``W`` of logical shape [m, n]; ``x`` has any
    leading batch shape and trailing dim n.  ``shards > 1`` sums the
    per-chunk partial products."""
    m, n = pw.shape
    if pw.shards > 1:
        n_chunk = n // pw.shards
        parts = [
            nf4_matmul(x[..., s * n_chunk : (s + 1) * n_chunk], v, out_dtype=out_dtype)
            for s, v in enumerate(chunk_views(pw))
        ]
        return sum(parts[1:], parts[0])
    out_dtype = out_dtype if out_dtype is not None else x.dtype
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
    elif x2.is_cuda:
        raise NotImplementedError(
            "kernel not ported yet: the exact fp32/fp16-activation matmul (kernel E)"
        )
    else:
        fn = _matmul_exact_plain
    y = fn(x2.contiguous(), pw.packed, pw.scales, out_dtype, pw.quant_type)
    return y[:B, :m].reshape(*batch, m)
