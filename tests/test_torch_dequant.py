"""Exact dequant (the plain version of kernel A) against nf4_tpu: bit-exact.

Compared with ``nf4_tpu.dequantize_t`` on its jnp path and on its Pallas
kernel in interpret mode, and with the NumPy oracle, through uint16/uint32
views.  The kernel itself is held against this plain version on the card
(``chip_smoke.py``; ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import nf4_tpu
import nf4_tpu_torch
from nf4_tpu.nf4.reference import dequantize_nf4, quantize_nf4
from nf4_tpu_torch.ops.dequant import _dequant_t_plain

DTYPES = {
    "bf16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16),
    "fp16": (torch.float16, jnp.float16, np.float16),
    "fp32": (torch.float32, jnp.float32, np.float32),
}


def _tbits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.element_size() == 2:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.view(torch.int32).numpy().view(np.uint32)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("shape,shards", [((256, 1024), 1), ((100, 320), 1), ((100, 384), 2)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequant_bit_exact(rng, monkeypatch, shape, shards, dtype, quant_type):
    tdt, jdt, ndt = DTYPES[dtype]
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    state = quantize_nf4(w, quant_type=quant_type)
    pj = nf4_tpu.pack_for_tpu(state, dtype=jdt, shards=shards)
    pt = nf4_tpu_torch.pack_for_tpu(state, dtype=tdt, shards=shards, device="cpu")

    got_t = nf4_tpu_torch.dequantize_t(pt)
    got = nf4_tpu_torch.dequantize(pt)
    assert got_t.dtype == tdt and got_t.shape == (shape[1], shape[0])
    assert got.shape == shape

    oracle = dequantize_nf4(state, dtype=ndt)
    np.testing.assert_array_equal(_tbits(got), _bits(oracle))
    for backend in ("jnp", "pallas"):  # pallas runs in interpret mode on the CPU
        monkeypatch.setenv("NF4TPU_BACKEND", backend)
        np.testing.assert_array_equal(_tbits(got_t), _bits(nf4_tpu.dequantize_t(pj)))


def test_dtype_override_and_padding_region(rng):
    """An explicit dtype wins over the weight's; the padded region of the
    plain kernel output is exact zero (padding carries scale 0)."""
    w = rng.standard_normal((100, 320)).astype(np.float32)
    pt = nf4_tpu_torch.pack_for_tpu(quantize_nf4(w), dtype=torch.bfloat16, device="cpu")
    assert nf4_tpu_torch.dequantize_t(pt, dtype=torch.float32).dtype == torch.float32
    full = _dequant_t_plain(pt.packed, pt.scales, torch.float32, pt.quant_type)
    assert full.shape == (1024, 128)
    assert not full[320:].any() and not full[:, 100:].any()


def test_fast_dequant_not_ported_yet(rng):
    from nf4_tpu_torch.ops.dequant import dequantize_fast, dequantize_t_fast

    pt = nf4_tpu_torch.pack_for_tpu(quantize_nf4(rng.standard_normal((128, 256))), device="cpu")
    for fn in (dequantize_fast, dequantize_t_fast):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            fn(pt)
