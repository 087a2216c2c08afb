"""The native (C++) host quantizer, bound with ``ctypes``.

The port's own copy of the JAX package's ``nf4/native.py`` and
``nf4quant.cpp``.  ``nf4quant.cpp`` runs the two hot loops of quantization
(block absmax and code assignment; the K-major pair pack of the packed
layout) as plain C++ with the same IEEE-754 single-precision operations as
the NumPy oracle (``nf4/reference.py``), so its bytes are the oracle's.
The statistics (the fp64 absmax mean, the dynamic 8-bit compression of the
small absmax stream) stay in Python, through the oracle's own functions.

Build: at first use, never at import, ``g++ -O3 -march=native -shared
-fPIC -std=c++17`` into ``nf4_tpu_torch/_build/`` (beside the CUDA
kernels), the library named after a hash of the source and the flags,
written to a temporary file and renamed, so concurrent processes never load
half a library.  Never ``-ffast-math``: bit-exactness needs correctly
rounded division and ordered compares.

``NF4TPU_NATIVE`` (read at every call): ``auto`` (the default) builds on
demand and reports the quantizer unavailable when the build fails; ``0``
disables it; ``1`` makes a failed build raise.  Any other value raises
``ValueError``.  ``quantize_for_tpu(method="native")`` raises whenever the
quantizer is unavailable; ``method="auto"`` then takes another method.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops._cuda import BUILD_DIR
from ..utils.device import resolve_device
from .format import PackedNF4, _host_fp32, pad_to
from .lut import code_midpoints, fp4_order_and_mids, get_code
from .reference import ABSMAX_BLOCK, NF4_BLOCK, QuantState, dequantize_absmax, quantize_blockwise_u8

__all__ = [
    "available",
    "quantize_codes",
    "pack_flat",
    "pack_kmajor",
    "quantize_nf4_native",
    "quantize_for_tpu_native",
]

SOURCE = Path(__file__).with_name("nf4quant.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
MODES = ("auto", "0", "1")

_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None  # why the build failed, once it has


def mode() -> str:
    """``NF4TPU_NATIVE``, validated: ``auto``, ``0`` or ``1``."""
    value = os.environ.get("NF4TPU_NATIVE", "auto").lower()
    if value not in MODES:
        raise ValueError(f"NF4TPU_NATIVE={value!r}; expected auto|0|1")
    return value


def lib_path() -> Path:
    """The library for this source and these flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnf4quant-{h.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    """Build the library unless it is there, and load it; raises
    ``RuntimeError`` when ``g++`` is missing or fails."""
    so = lib_path()
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so.tmp", delete=False) as tmp:
            tmp_path = Path(tmp.name)
        try:
            proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp_path)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed: {proc.stderr[:2000]}")
            os.replace(tmp_path, so)
        finally:
            tmp_path.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    u8, f32, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int64
    lib.nf4_quantize_codes.argtypes = [f32, i64, i64, f32, i64, u8, f32]
    lib.nf4_pack_flat.argtypes = [u8, i64, u8]
    lib.nf4_pack_kmajor.argtypes = [u8, i64, i64, i64, i64, i64, u8]
    for fn in (lib.nf4_quantize_codes, lib.nf4_pack_flat, lib.nf4_pack_kmajor):
        fn.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where ``NF4TPU_NATIVE=0`` or (``auto``)
    the build failed.  Raises ``ValueError`` for an invalid flag and
    ``RuntimeError`` where ``NF4TPU_NATIVE=1`` and the build failed.  One
    build is tried per process."""
    global _lib, _failed
    flag = mode()
    if flag == "0":
        return None
    if _lib is None and _failed is None:
        try:
            _lib = _build_and_load()
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _failed = str(e)
    if _lib is None and flag == "1":
        raise RuntimeError(f"NF4TPU_NATIVE=1 but the native quantizer failed to build: {_failed}")
    return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        why = "NF4TPU_NATIVE=0" if _failed is None else f"its build failed: {_failed}"
        raise RuntimeError(f"the native quantizer is unavailable ({why})")
    return lib


def available() -> bool:
    """True when the native quantizer is built (or builds now) and loads."""
    try:
        return _load() is not None
    except (ValueError, RuntimeError):
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def quantize_codes(w_flat: np.ndarray, blocksize: int, mids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Block absmax and ``#{mids < x / scale}`` codes of a flat fp32 stream
    (a zero block takes scale 1; a tie on a midpoint goes left)."""
    lib = _require()
    if blocksize < 1:
        raise ValueError(f"blocksize must be positive, got {blocksize}")
    w_flat = np.ascontiguousarray(w_flat, dtype=np.float32).ravel()
    mids = np.ascontiguousarray(mids, dtype=np.float32)
    n = w_flat.shape[0]
    codes = np.empty(n, dtype=np.uint8)
    absmax = np.empty(-(-n // blocksize), dtype=np.float32)
    lib.nf4_quantize_codes(_ptr(w_flat, ctypes.c_float), n, blocksize, _ptr(mids, ctypes.c_float),
                           mids.shape[0], _ptr(codes, ctypes.c_uint8), _ptr(absmax, ctypes.c_float))
    return codes, absmax


def pack_flat(codes: np.ndarray) -> np.ndarray:
    """bitsandbytes' flat nibble pack (element 2i in the HIGH nibble)."""
    lib = _require()
    codes = np.ascontiguousarray(codes, dtype=np.uint8).ravel()
    n = codes.shape[0]
    out = np.empty(-(-n // 2), dtype=np.uint8)
    lib.nf4_pack_flat(_ptr(codes, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8))
    return out


def pack_kmajor(codes: np.ndarray, m_pad: int, n_chunk_pad: int, shards: int) -> np.ndarray:
    """The K-major pair pack of a [m, n] code grid in ``shards`` K chunks,
    each padded to ``n_chunk_pad`` (``nf4/format.py``'s layout): uint8
    ``[shards * n_chunk_pad / 2, m_pad]``, zeros in the padding."""
    lib = _require()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    m, n = codes.shape
    if shards < 1 or n % shards or (n // shards) % 2:
        raise ValueError(f"in_features {n} must split into {shards} chunk(s) of even length")
    if m_pad < m or n_chunk_pad < n // shards:
        raise ValueError(f"padded shape ({m_pad}, {n_chunk_pad}) smaller than the codes' ({m}, {n // shards})")
    out = np.empty((shards * (n_chunk_pad // 2), m_pad), dtype=np.uint8)
    lib.nf4_pack_kmajor(_ptr(codes, ctypes.c_uint8), m, n, m_pad, n_chunk_pad, shards, _ptr(out, ctypes.c_uint8))
    return out


def _native_codes(w_flat: np.ndarray, quant_type: str):
    """Codes and block absmax for any 4-bit table: a monotone table (NF4)
    directly; FP4's sign-magnitude one through the walker on |x| against
    the sorted magnitudes' midpoints, mapped to table indices, plus the sign
    bit for x < 0 (the oracle's ``quantize_to_code``)."""
    code = get_code(quant_type)
    if np.all(np.diff(code) >= 0):
        return quantize_codes(w_flat, NF4_BLOCK, code_midpoints(code))
    order, mids = fp4_order_and_mids(code)
    pos, absmax = quantize_codes(np.abs(w_flat), NF4_BLOCK, mids)
    return order[pos] + np.where(w_flat < 0, 8, 0).astype(np.uint8), absmax


def _statistics(absmax: np.ndarray):
    """The oracle's offset and double quantization of the absmax stream."""
    offset = np.float32(absmax.mean(dtype=np.float64))
    absmax_u8, absmax32 = quantize_blockwise_u8(absmax - offset, ABSMAX_BLOCK)
    return offset, absmax_u8, absmax32.astype(np.float32)


def quantize_nf4_native(w, dtype=None, quant_type: str = "nf4") -> QuantState:
    """The oracle's ``quantize_nf4`` (flat bitsandbytes layout, double-
    quantized statistics), byte for byte, on the C++ loops."""
    w = np.asarray(w)
    if dtype is None:
        dtype = w.dtype if w.dtype == np.float16 else np.dtype(np.float32)
    codes, absmax = _native_codes(np.ascontiguousarray(w, dtype=np.float32).ravel(), quant_type)
    offset, absmax_u8, absmax32 = _statistics(absmax)
    return QuantState(packed=pack_flat(codes), absmax_u8=absmax_u8, absmax32=absmax32, offset=offset,
                      shape=tuple(w.shape), dtype=np.dtype(dtype), blocksize=NF4_BLOCK, blocksize2=ABSMAX_BLOCK,
                      quant_type=quant_type)


def quantize_for_tpu_native(w, dtype=torch.bfloat16, quant_type: str = "nf4", device=None):
    """A dense [m, n] weight (torch tensor or array) into
    :class:`~nf4_tpu_torch.nf4.format.PackedNF4` on ``device`` (default
    ``cuda``), quantized on the host by the C++ loops: the oracle's bytes
    (``quantize_for_tpu(method="oracle")``)."""
    from .format import PackedNF4, _host_fp32, pad_to

    dev = resolve_device(device)
    w = np.ascontiguousarray(_host_fp32(w))
    if w.ndim != 2:
        raise ValueError(f"expected a 2D weight, got shape {w.shape}")
    m, n = w.shape
    if n % NF4_BLOCK:
        raise ValueError(f"in_features must be a multiple of {NF4_BLOCK}, got {n}")
    codes, absmax = _native_codes(w.ravel(), quant_type)
    offset, absmax_u8, absmax32 = _statistics(absmax)
    state = QuantState(packed=np.zeros(0, np.uint8), absmax_u8=absmax_u8, absmax32=absmax32, offset=offset,
                       shape=(m, n), dtype=np.dtype(np.float16))
    m_pad, n_pad = pad_to(m, 128), pad_to(n, 1024)
    scales = np.zeros((n_pad // NF4_BLOCK, m_pad), np.float32)
    scales[: n // NF4_BLOCK, :m] = dequantize_absmax(state).reshape(m, n // NF4_BLOCK).T
    packed = pack_kmajor(codes.reshape(m, n), m_pad, n_pad, 1)
    return PackedNF4(packed=torch.from_numpy(packed).to(dev), scales=torch.from_numpy(scales).to(dev),
                     shape=(m, n), padded_shape=(m_pad, n_pad), dtype=dtype, quant_type=quant_type)
