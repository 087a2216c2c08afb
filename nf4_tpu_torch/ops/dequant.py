"""Exact 4-bit dequantization to ``W^T`` and ``W`` (kernel A).

``dequantize_t`` returns the logical ``[n, m]`` transpose, the layout's
native order; ``dequantize`` its transpose ``[m, n]``, the bitsandbytes
orientation.  All value math is fp32 with one cast at the end, so both
are bit-exact against the NumPy oracle for NF4 and FP4 and for bf16, fp16
and fp32 outputs.

On a CUDA tensor the hand-written kernel ``csrc/dequant.cu`` runs; on a CPU
tensor its plain PyTorch version, :func:`_dequant_t_plain`.  The fast bf16
byte-table dequant (``dequantize_fast``, the JAX package's kernel F) is not
ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from ..nf4.format import PackedNF4, chunk_views
from ..nf4.reference import NF4_BLOCK
from ._cuda import Kernel
from .lut_eval import code_tensor, nf4_lookup

__all__ = ["dequantize", "dequantize_t", "dequantize_fast", "dequantize_t_fast"]

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_KERNEL = Kernel(
    "dequant_t", "dequant", "nf4_dequant_t",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
)


def _dequant_t_plain(packed: torch.Tensor, scales: torch.Tensor, dtype, quant_type="nf4") -> torch.Tensor:
    """The plain version of kernel A: [n_pad/2, m_pad] bytes -> [n_pad, m_pad]."""
    b = packed.to(torch.int32)
    khalf, m_pad = b.shape
    idx_t = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=1).reshape(2 * khalf, m_pad)
    sexp = scales.repeat_interleave(NF4_BLOCK, dim=0)
    return (nf4_lookup(idx_t, quant_type) * sexp).to(dtype)


def _dequant_t_kernel(packed: torch.Tensor, scales: torch.Tensor, dtype, quant_type="nf4") -> torch.Tensor:
    """Launch kernel A on CUDA tensors (the wrapper's checks first)."""
    khalf, m_pad = packed.shape
    if dtype not in _OUT_KIND:
        raise TypeError(f"dequant output dtype {dtype} not in {list(_OUT_KIND)}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("packed must be uint8 and scales fp32")
    if scales.shape != (2 * khalf // NF4_BLOCK, m_pad) or khalf % (NF4_BLOCK // 2) or m_pad % 4:
        raise ValueError(f"bad packed/scales shapes {tuple(packed.shape)} / {tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()) or scales.device != packed.device:
        raise ValueError("packed and scales must be contiguous and on one device")
    out = torch.empty((2 * khalf, m_pad), dtype=dtype, device=packed.device)
    code = code_tensor(quant_type, packed.device)
    _KERNEL(packed.data_ptr(), scales.data_ptr(), code.data_ptr(), out.data_ptr(),
            khalf, m_pad, _OUT_KIND[dtype])
    return out


def _dequant_t_padded(pw: PackedNF4, dtype) -> torch.Tensor:
    if pw.packed.is_cuda:
        return _dequant_t_kernel(pw.packed, pw.scales, dtype, pw.quant_type)
    return _dequant_t_plain(pw.packed, pw.scales, dtype, pw.quant_type)


def dequantize_t(pw: PackedNF4, dtype=None) -> torch.Tensor:
    """Dequantize to ``W^T`` of logical shape [n, m]."""
    if pw.shards > 1:
        return torch.cat([dequantize_t(v, dtype=dtype) for v in chunk_views(pw)], dim=0)
    out = _dequant_t_padded(pw, dtype if dtype is not None else pw.dtype)
    m, n = pw.shape
    if (m, n) != tuple(pw.padded_shape):
        out = out[:n, :m]
    return out


def dequantize(pw: PackedNF4, dtype=None) -> torch.Tensor:
    """Dequantize to the logical [m, n] weight (a transposed view)."""
    return dequantize_t(pw, dtype=dtype).T


def dequantize_t_fast(pw: PackedNF4) -> torch.Tensor:
    """The fast bf16 dequant (the JAX package's kernel F): not ported yet."""
    raise NotImplementedError("kernel not ported yet: the fast bf16 dequant (kernel F)")


def dequantize_fast(pw: PackedNF4) -> torch.Tensor:
    raise NotImplementedError("kernel not ported yet: the fast bf16 dequant (kernel F)")
