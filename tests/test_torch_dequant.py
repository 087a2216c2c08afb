"""Dequant against nf4_tpu: exact (the plain version of kernel A), bit-exact;
fast bf16 (the plain version of kernel F), bit for bit its byte-table
values and within the JAX package's tolerance of its ``dequantize_fast``.

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


@pytest.mark.parametrize("shape,shards", [((256, 1024), 1), ((100, 320), 1), ((100, 384), 2)])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_fast_dequant_matches(rng, shape, shards, quant_type):
    """``dequantize_fast`` (the plain version of kernel F): bit for bit the
    byte-table values bf16(bf16(code) * bf16(scale)), computed here with
    numpy and ml_dtypes; against JAX ``dequantize_fast`` (its exact path on
    the CPU) within the JAX package's own rtol 1.1e-2 / atol 1e-6."""
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    state = quantize_nf4(w, quant_type=quant_type)
    pj = nf4_tpu.pack_for_tpu(state, dtype=jnp.bfloat16, shards=shards)
    pt = nf4_tpu_torch.pack_for_tpu(state, dtype=torch.float32, shards=shards, device="cpu")
    got_t = nf4_tpu_torch.dequantize_t_fast(pt)
    got = nf4_tpu_torch.dequantize_fast(pt)
    assert got_t.dtype == got.dtype == torch.bfloat16  # always bf16
    assert got_t.shape == (shape[1], shape[0]) and got.shape == shape

    code = nf4_tpu.get_code(quant_type).astype(ml_dtypes.bfloat16).astype(np.float32)
    idx = np.asarray(nf4_tpu.nf4.reference.unpack_nibbles(state.packed, w.size)).reshape(shape)
    scale = nf4_tpu.nf4.reference.dequantize_absmax(state).reshape(shape[0], -1)
    scale = np.repeat(scale.astype(ml_dtypes.bfloat16).astype(np.float32), 64, axis=1)
    want = (code[idx] * scale).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_tbits(got), _bits(want))

    jfast = np.asarray(nf4_tpu.dequantize_fast(pj), np.float32)
    np.testing.assert_allclose(got.float().numpy(), jfast, rtol=1.1e-2, atol=1e-6)


def test_fast_dequant_padded_plain_is_kernel_b_weights(rng):
    """On the padded layout the plain version of kernel F is kernel B's
    weight decode, padding included (exact zeros)."""
    from nf4_tpu_torch.ops.dequant import _bf16_weight_t
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_plain

    pt = nf4_tpu_torch.pack_for_tpu(quantize_nf4(rng.standard_normal((100, 320))), device="cpu")
    wt = _bf16_weight_t(pt.packed, pt.scales, pt.quant_type)
    assert wt.shape == (1024, 128) and not wt[320:].any() and not wt[:, 100:].any()
    np.testing.assert_array_equal(_tbits(wt[:320, :100]), _tbits(nf4_tpu_torch.dequantize_t_fast(pt)))
    eye = torch.eye(1024, dtype=torch.bfloat16)[:16]
    np.testing.assert_array_equal(  # values: a sum turns -0 into +0
        _matmul_bf16_plain(eye, pt.packed, pt.scales, torch.bfloat16).float().numpy(), wt[:16].float().numpy()
    )
