"""4-bit dequantization to ``W^T`` and ``W``: exact (kernel A) and fast bf16
(kernel F).

``dequantize_t`` returns the logical ``[n, m]`` transpose, the layout's
native order; ``dequantize`` its transpose ``[m, n]``, the bitsandbytes
orientation.  All value math is fp32 with one cast at the end, so both
are bit-exact against the NumPy oracle for NF4 and FP4 and for bf16, fp16
and fp32 outputs.

On a CUDA tensor the hand-written kernel ``csrc/dequant.cu`` runs; on a CPU
tensor its plain PyTorch version, :func:`_dequant_t_plain`
(``NF4TPU_BACKEND``, ``utils/env.py``: ``jnp`` the plain versions on the
card too, ``pallas`` the kernels, raising on a CPU tensor).

``dequantize_fast`` / ``dequantize_t_fast`` decode through kernel B's byte
table into bf16 (``csrc/dequant.cu``'s second entry point): each value is
``bf16(bf16(code) * bf16(scale))``, not bit-exact against the oracle (two
roundings, relative error <= ~2^-8) but bit-exact against its plain version
:func:`_bf16_weight_t`.
"""

from __future__ import annotations

import ctypes

import torch

from ..nf4.format import PackedNF4, chunk_views
from ..nf4.reference import NF4_BLOCK
from ..utils import env
from ._cuda import Kernel
from .lut_eval import byte_word_table, code_tensor, nf4_lookup

__all__ = ["dequantize", "dequantize_t", "dequantize_fast", "dequantize_t_fast"]

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_KERNEL = Kernel(
    "dequant_t", "dequant", "nf4_dequant_t",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
)
_FAST_KERNEL = Kernel(
    "dequant_t_fast", "dequant", "nf4_dequant_t_fast",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2,
)


def _dequant_t_plain(packed: torch.Tensor, scales: torch.Tensor, dtype, quant_type="nf4") -> torch.Tensor:
    """The plain version of kernel A: [n_pad/2, m_pad] bytes -> [n_pad, m_pad]."""
    b = packed.to(torch.int32)
    khalf, m_pad = b.shape
    idx_t = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=1).reshape(2 * khalf, m_pad)
    sexp = scales.repeat_interleave(NF4_BLOCK, dim=0)
    return (nf4_lookup(idx_t, quant_type) * sexp).to(dtype)


def _bf16_weight_t(packed: torch.Tensor, scales: torch.Tensor, quant_type: str = "nf4") -> torch.Tensor:
    """W^T [n_pad, m_pad] through the byte table: bf16(code) * bf16(scale),
    rounded to bf16 (the product of two bf16 values is exact in fp32, so
    one rounding).  The plain version of kernel F and kernel B's weights."""
    b = packed.to(torch.int32)
    khalf, m_pad = b.shape
    idx_t = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=1).reshape(2 * khalf, m_pad)
    code = code_tensor(quant_type, packed.device).to(torch.bfloat16).float()
    sexp = scales.to(torch.bfloat16).float().repeat_interleave(NF4_BLOCK, dim=0)
    return (code[idx_t.long()] * sexp).to(torch.bfloat16)


def _check_packed(packed: torch.Tensor, scales: torch.Tensor) -> None:
    khalf, m_pad = packed.shape
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError("packed must be uint8 and scales fp32")
    if scales.shape != (2 * khalf // NF4_BLOCK, m_pad) or khalf % (NF4_BLOCK // 2) or m_pad % 4:
        raise ValueError(f"bad packed/scales shapes {tuple(packed.shape)} / {tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()) or scales.device != packed.device:
        raise ValueError("packed and scales must be contiguous and on one device")


def _dequant_t_fast_kernel(packed: torch.Tensor, scales: torch.Tensor, quant_type: str = "nf4") -> torch.Tensor:
    """Launch kernel F on CUDA tensors (the wrapper's checks first)."""
    _check_packed(packed, scales)
    khalf, m_pad = packed.shape
    out = torch.empty((2 * khalf, m_pad), dtype=torch.bfloat16, device=packed.device)
    table = byte_word_table(quant_type, packed.device)
    _FAST_KERNEL(packed.data_ptr(), scales.data_ptr(), table.data_ptr(), out.data_ptr(), khalf, m_pad)
    return out


def _dequant_t_kernel(packed: torch.Tensor, scales: torch.Tensor, dtype, quant_type="nf4") -> torch.Tensor:
    """Launch kernel A on CUDA tensors (the wrapper's checks first)."""
    if dtype not in _OUT_KIND:
        raise TypeError(f"dequant output dtype {dtype} not in {list(_OUT_KIND)}")
    _check_packed(packed, scales)
    khalf, m_pad = packed.shape
    out = torch.empty((2 * khalf, m_pad), dtype=dtype, device=packed.device)
    code = code_tensor(quant_type, packed.device)
    _KERNEL(packed.data_ptr(), scales.data_ptr(), code.data_ptr(), out.data_ptr(),
            khalf, m_pad, _OUT_KIND[dtype])
    return out


def _logical_t(pw: PackedNF4, padded_fn) -> torch.Tensor:
    """``W^T`` [n, m] from ``padded_fn(chunk)`` -> [n_pad, m_pad] per K chunk:
    the ``shards > 1`` concat and the padding slice."""
    if pw.shards > 1:
        return torch.cat([_logical_t(v, padded_fn) for v in chunk_views(pw)], dim=0)
    out = padded_fn(pw)
    m, n = pw.shape
    if (m, n) != tuple(pw.padded_shape):
        out = out[:n, :m]
    return out


def _exact_padded(pw: PackedNF4, dtype) -> torch.Tensor:
    fn = _dequant_t_kernel if env.use_kernel(pw.packed) else _dequant_t_plain
    return fn(pw.packed, pw.scales, dtype, pw.quant_type)


def _fast_padded(pw: PackedNF4) -> torch.Tensor:
    fn = _dequant_t_fast_kernel if env.use_kernel(pw.packed) else _bf16_weight_t
    return fn(pw.packed, pw.scales, pw.quant_type)


def dequantize_t(pw: PackedNF4, dtype=None) -> torch.Tensor:
    """Dequantize to ``W^T`` of logical shape [n, m]."""
    dtype = dtype if dtype is not None else pw.dtype
    return _logical_t(pw, lambda p: _exact_padded(p, dtype))


def dequantize(pw: PackedNF4, dtype=None) -> torch.Tensor:
    """Dequantize to the logical [m, n] weight (a transposed view)."""
    return dequantize_t(pw, dtype=dtype).T


def dequantize_t_fast(pw: PackedNF4) -> torch.Tensor:
    """Fast bf16 dequantize to ``W^T`` [n, m] through the byte table (see the
    module docstring for the accuracy contract).  Output is always bf16."""
    return _logical_t(pw, _fast_padded)


def dequantize_fast(pw: PackedNF4) -> torch.Tensor:
    """Fast bf16 dequantize to the logical [m, n] weight (a transposed view)."""
    return dequantize_t_fast(pw).T
