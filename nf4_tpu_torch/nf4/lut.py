"""Code tables for NF4, FP4 and the bitsandbytes dynamic 8-bit absmax codebook.

The same fp32 literals as the JAX package's ``nf4_tpu/nf4/lut.py`` (a test
asserts equality), kept here so the port never imports that package.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["NF4_CODE", "FP4_CODE", "get_code", "dynamic_code", "code_midpoints", "fp4_order_and_mids"]

# The fixed NF4 codebook, index 0..15 -> fp32 value (bitsandbytes' constants).
NF4_CODE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

# The fixed FP4 codebook (bitsandbytes ``quant_type="fp4"``): a 4-bit e2m1
# float with the sign in bit 3, as bnb's exact decimal literals (0.00520833
# is bnb's literal, not fp32(1/192)).  Not monotone in the index.
FP4_CODE = np.array(
    [
        0.0,
        0.00520833,
        0.66666667,
        1.0,
        0.33333333,
        0.5,
        0.16666667,
        0.25,
        -0.0,
        -0.00520833,
        -0.66666667,
        -1.0,
        -0.33333333,
        -0.5,
        -0.16666667,
        -0.25,
    ],
    dtype=np.float32,
)

_CODES = {"nf4": NF4_CODE, "fp4": FP4_CODE}


def fp4_order_and_mids(code):
    """Sign-magnitude quantization constants for a 16-entry fp4-layout
    table: ``(order, mids)`` where ``order[p]`` is the table index of the
    p-th smallest non-negative magnitude and ``mids`` are the 7 decision
    midpoints between sorted magnitudes.  Quantize as
    ``order[#{mids < |x|}] + 8*(x < 0)``: the one definition the oracle
    and the device quantizer share, so their codes cannot drift apart."""
    code = np.asarray(code, dtype=np.float32)
    mags = code[:8]
    if not (np.array_equal(-mags, code[8:]) and (mags >= 0).all()):
        raise ValueError("non-monotone codebooks must be sign-magnitude (fp4 layout)")
    order = np.argsort(mags, kind="stable").astype(np.uint8)
    return order, code_midpoints(mags[order])


def code_midpoints(code: np.ndarray) -> np.ndarray:
    """Decision thresholds between adjacent codebook entries: ``x`` goes
    to index ``i`` iff ``mid[i-1] < x <= mid[i]`` (strictly greater at a
    threshold, the comparison direction of bitsandbytes' quantizer trees),
    each midpoint computed in float64 and rounded to fp32."""
    code = np.asarray(code, dtype=np.float32)
    return ((code[:-1].astype(np.float64) + code[1:].astype(np.float64)) / 2.0).astype(np.float32)


def get_code(quant_type: str) -> np.ndarray:
    """The 16-entry 4-bit codebook for ``quant_type`` ("nf4" | "fp4")."""
    try:
        return _CODES[quant_type]
    except KeyError:
        raise ValueError(
            f"quant_type={quant_type!r}; expected one of {sorted(_CODES)}"
        ) from None


@functools.lru_cache(maxsize=None)
def _dynamic_code_cached(signed: bool, max_exponent_bits: int, total_bits: int) -> bytes:
    """bitsandbytes' 'dynamic tree' codebook: an indicator-bit exponent
    followed by linear fraction bits; (signed, 7, 8) is the 256-entry fp32
    table bnb stores as ``quant_state.state2.code``."""
    data: list[float] = []
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        if signed:
            fraction_items = int(2 ** (i + non_sign_bits - max_exponent_bits) + 1)
        else:
            fraction_items = int(2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1)
        boundaries = np.linspace(0.1, 1.0, fraction_items)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        scale = 10 ** (-(max_exponent_bits - 1) + i)
        data += (scale * means).tolist()
        if signed:
            data += (-scale * means).tolist()

    if additional_items > 0:
        boundaries = np.linspace(0.1, 1.0, additional_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        scale = 10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1)
        data += (scale * means).tolist()
        if signed:
            data += (-scale * means).tolist()

    data.append(0.0)
    data.append(1.0)

    gap = 2**total_bits - len(data)
    assert gap >= 0, (len(data), total_bits)
    data += [0.0] * gap

    data.sort()
    return np.asarray(data, dtype=np.float32).tobytes()


def dynamic_code(
    signed: bool = True, max_exponent_bits: int = 7, total_bits: int = 8
) -> np.ndarray:
    """The 256-entry dynamic codebook used for absmax double quantization."""
    buf = _dynamic_code_cached(signed, max_exponent_bits, total_bits)
    return np.frombuffer(buf, dtype=np.float32).copy()
