"""The port's packed format, codebooks and module adapter against nf4_tpu.

Byte-identical packing and bit-identical scales: the two packages share one
layout, so checkpoints and the NumPy oracle are shared too.
"""

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import nf4_tpu
import nf4_tpu_torch
from nf4_tpu.nf4 import lut as jax_lut
from nf4_tpu.nf4.format import chunk_views as jax_chunk_views
from nf4_tpu.nf4.reference import quantize_nf4
from nf4_tpu_torch.nf4 import lut
from nf4_tpu_torch.nf4.format import chunk_views


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    """The bit patterns of a torch float tensor as unsigned ints."""
    if t.element_size() == 2:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("name", ["NF4_CODE", "FP4_CODE"])
def test_codebooks_equal(name):
    np.testing.assert_array_equal(_bits(getattr(lut, name)), _bits(getattr(jax_lut, name)))


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_get_code_and_dynamic_code(quant_type):
    np.testing.assert_array_equal(
        _bits(lut.get_code(quant_type)), _bits(jax_lut.get_code(quant_type))
    )
    np.testing.assert_array_equal(_bits(lut.dynamic_code()), _bits(jax_lut.dynamic_code()))
    with pytest.raises(ValueError):
        lut.get_code("int4")


@pytest.mark.parametrize("shape,shards", [((256, 1024), 1), ((100, 320), 1), ((100, 384), 2)])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_pack_for_tpu_byte_identical(rng, shape, shards, quant_type):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    state = quantize_nf4(w, quant_type=quant_type)
    want = nf4_tpu.pack_for_tpu(state, dtype=jnp.bfloat16, shards=shards)
    got = nf4_tpu_torch.pack_for_tpu(state, dtype=torch.bfloat16, shards=shards, device="cpu")
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(_bits(got.scales.numpy()), _bits(np.asarray(want.scales)))
    assert got.shape == tuple(want.shape)
    assert got.padded_shape == tuple(want.padded_shape)
    assert (got.shards, got.quant_type) == (want.shards, want.quant_type)
    assert got.nbytes == want.nbytes
    # The CUDA kernels take row-major tensors.
    assert got.packed.is_contiguous() and got.scales.is_contiguous()


def test_chunk_views_agree(rng):
    w = rng.standard_normal((100, 384)).astype(np.float32)
    state = quantize_nf4(w)
    want = jax_chunk_views(nf4_tpu.pack_for_tpu(state, shards=2))
    got = chunk_views(nf4_tpu_torch.pack_for_tpu(state, shards=2, device="cpu"))
    assert len(got) == len(want) == 2
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.packed.numpy(), np.asarray(w_.packed))
        np.testing.assert_array_equal(g.scales.numpy(), np.asarray(w_.scales))
        assert (g.shape, g.padded_shape, g.shards) == (tuple(w_.shape), tuple(w_.padded_shape), 1)


def _bnb_module(state, dtype_name, as_torch):
    """A duck-typed bitsandbytes Linear4bit built from a flat QuantState."""
    conv = torch.from_numpy if as_torch else (lambda a: a)
    qs = types.SimpleNamespace(
        absmax=conv(state.absmax_u8.copy()),
        state2=types.SimpleNamespace(
            absmax=conv(state.absmax32.copy()),
            code=conv(jax_lut.dynamic_code()),
        ),
        offset=float(state.offset),
        dtype=dtype_name,
        quant_type=state.quant_type,
    )
    weight = types.SimpleNamespace(data=conv(state.packed.copy()), quant_state=qs)
    m, n = state.shape
    return types.SimpleNamespace(weight=weight, out_features=m, in_features=n)


@pytest.mark.parametrize("dtype_name", ["torch.float16", "torch.bfloat16"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequantize_nf4_module_matches(rng, dtype_name, quant_type):
    w = rng.standard_normal((100, 320)).astype(np.float32) * 0.05
    state = quantize_nf4(w, quant_type=quant_type)
    want = np.asarray(nf4_tpu.dequantize_nf4_module(_bnb_module(state, dtype_name, False)))
    got = nf4_tpu_torch.dequantize_nf4_module(_bnb_module(state, dtype_name, True), device="cpu")
    assert got.shape == (100, 320)
    assert want.dtype == (np.float16 if dtype_name == "torch.float16" else ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_tbits(got), _bits(want))


def test_entry_points_need_a_card_unless_cpu_is_asked(rng):
    """Without CUDA, an entry point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    state = quantize_nf4(rng.standard_normal((128, 256)).astype(np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nf4_tpu_torch.pack_for_tpu(state)
    nf4_tpu_torch.reset_dequantize_state()  # a documented no-op
