"""The port's 4-bit quantizer against the JAX package's NumPy oracle, byte
for byte, on the CPU: the oracle's pieces (``nf4_tpu_torch/nf4/reference.py``
is the same NumPy code), ``quantize_for_tpu`` with ``method="oracle"`` and
``method="device"`` (``nf4/fast_quant.py``, here on the CPU) against
``nf4_tpu``'s ``method="oracle"`` (packed bytes and scales; bf16, fp16 and
fp32 input; an unaligned weight; the midpoint stress tensor), and the
``QDense`` intermediate.  The same quantizer on the card is in
``tests/test_torch_cuda.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nf4_tpu.nf4 import format as jformat
from nf4_tpu.nf4 import lut as jlut
from nf4_tpu.nf4 import reference as jref
from nf4_tpu_torch.nf4 import format as tformat
from nf4_tpu_torch.nf4 import lut as tlut
from nf4_tpu_torch.nf4 import reference as tref
from nf4_tpu_torch.nf4.fast_quant import midpoint_stress

QUANT_TYPES = ["nf4", "fp4"]


def _weight(shape, seed=0, scale=0.05):
    """A seeded fp32 weight with a zero block, a block of one value and a
    block with its absmax negative."""
    w = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    flat = w.reshape(-1)
    flat[:64] = 0.0
    if flat.size >= 192:
        flat[64:128] = 0.01
        flat[128] = -1.0
    return w


def _states_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.packed), np.asarray(b.packed))
    np.testing.assert_array_equal(np.asarray(a.absmax_u8), np.asarray(b.absmax_u8))
    np.testing.assert_array_equal(np.asarray(a.absmax32).view(np.uint32), np.asarray(b.absmax32).view(np.uint32))
    assert np.float32(a.offset).tobytes() == np.float32(b.offset).tobytes()
    assert tuple(a.shape) == tuple(b.shape) and a.quant_type == b.quant_type


def _packed_equal(t, j):
    """A port PackedNF4 (CPU tensors) against a JAX one, bytes and bits."""
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scales.numpy().view(np.uint32), np.asarray(j.scales).view(np.uint32))
    assert t.shape == tuple(j.shape) and t.padded_shape == tuple(j.padded_shape) and t.quant_type == j.quant_type


def test_tables_and_midpoints_equal_the_jax_package():
    for qt in QUANT_TYPES:
        np.testing.assert_array_equal(tlut.code_midpoints(tlut.get_code(qt)), jlut.code_midpoints(jlut.get_code(qt)))
    order, mids = tlut.fp4_order_and_mids(tlut.FP4_CODE)
    jorder, jmids = jlut.fp4_order_and_mids(jlut.FP4_CODE)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(mids, jmids)
    with pytest.raises(ValueError, match="sign-magnitude"):
        tlut.fp4_order_and_mids(np.roll(tlut.FP4_CODE, 1))


@pytest.mark.parametrize("table", ["nf4", "fp4", "dynamic"])
def test_quantize_to_code(table):
    code = tlut.dynamic_code() if table == "dynamic" else tlut.get_code(table)
    mids = tlut.code_midpoints(np.sort(code))
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-1, 1, 4000), mids, -mids, np.nextafter(mids, 2), np.nextafter(mids, -2),
                        [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    got = tref.quantize_to_code(x, code)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jref.quantize_to_code(x, code))


def test_quantize_blockwise_u8_and_pack_nibbles():
    x = np.random.default_rng(2).standard_normal(1000).astype(np.float32)  # a ragged last block
    codes, absmax = tref.quantize_blockwise_u8(x)
    jcodes, jabsmax = jref.quantize_blockwise_u8(x)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(absmax.view(np.uint32), jabsmax.view(np.uint32))
    idx = np.random.default_rng(3).integers(0, 16, 77).astype(np.uint8)  # odd
    np.testing.assert_array_equal(tref.pack_nibbles(idx), jref.pack_nibbles(idx))
    np.testing.assert_array_equal(tref.unpack_nibbles(tref.pack_nibbles(idx), 77), idx)


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("shape", [(96, 192), (7, 99)])  # the second: an odd element count, blocks across rows
def test_quantize_nf4_and_dequantize(quant_type, compress, shape):
    w = _weight(shape, seed=4)
    got = tref.quantize_nf4(w, dtype=np.float16, compress_statistics=compress, quant_type=quant_type)
    want = jref.quantize_nf4(w, dtype=np.float16, compress_statistics=compress, quant_type=quant_type)
    _states_equal(got, want)
    for dt in (np.float32, np.float16):
        np.testing.assert_array_equal(tref.dequantize_nf4(got, dt).view(np.uint8),
                                      jref.dequantize_nf4(want, dt).view(np.uint8))


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
@pytest.mark.parametrize("method", ["oracle", "device"])
def test_quantize_for_tpu_matches_the_jax_oracle(quant_type, method):
    """Both methods of the port, on bf16, fp16 and fp32 input (the oracle
    sees the same values upcast to fp32) and an unaligned 100 x 320
    weight, give the JAX oracle's packed bytes and scales."""
    for shape in ((100, 320), (256, 1024)):
        w = _weight(shape, seed=5)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            wt = torch.from_numpy(w).to(dt)
            want = jformat.quantize_for_tpu(wt.float().numpy(), method="oracle", quant_type=quant_type)
            got = tformat.quantize_for_tpu(wt, method=method, quant_type=quant_type, device="cpu")
            _packed_equal(got, want)
            assert got.dtype == torch.bfloat16 and got.packed.device.type == "cpu"


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_midpoint_stress(quant_type):
    """Normalized values on every midpoint and one ulp either side: the
    device method's correctly rounded division gives the oracle's codes,
    and a reciprocal multiply would not (the tensor can tell them apart)."""
    from nf4_tpu_torch.nf4.fast_quant import _codes

    w = midpoint_stress(128, 1024, quant_type)
    want = jformat.quantize_for_tpu(w, method="oracle", quant_type=quant_type)
    _packed_equal(tformat.quantize_for_tpu(torch.from_numpy(w), method="device", quant_type=quant_type,
                                           device="cpu"), want)
    x = torch.from_numpy(w).reshape(-1, 64)
    s = x.abs().amax(1, keepdim=True)
    assert (_codes(x / s, quant_type) != _codes(x * (1 / s), quant_type)).any()


def test_qdense_and_pack_codes():
    w = _weight((100, 192), seed=6)
    for qt in QUANT_TYPES:
        st = tref.quantize_nf4(w, dtype=np.float16, quant_type=qt)
        jst = jref.quantize_nf4(w, dtype=np.float16, quant_type=qt)
        qd, jqd = tformat.qdense_from_state(st), jformat.qdense_from_state(jst)
        np.testing.assert_array_equal(qd.codes, jqd.codes)
        np.testing.assert_array_equal(qd.scales.view(np.uint32), jqd.scales.view(np.uint32))
        assert qd.shape == (100, 192) and qd.nbytes == jqd.nbytes and qd.quant_type == qt
        np.testing.assert_array_equal(qd.to_dense(), jqd.to_dense())
        np.testing.assert_array_equal(qd.rows(10, 40).codes, jqd.rows(10, 40).codes)
        np.testing.assert_array_equal(qd.to_dense(), jref.dequantize_nf4(jst, np.float32))
        _packed_equal(tformat.pack_codes_for_tpu(qd.codes, qd.scales, quant_type=qt, device="cpu"),
                      jformat.pack_codes_for_tpu(jqd.codes, jqd.scales, quant_type=qt))
        _packed_equal(tformat.pack_for_tpu(st, device="cpu"), jformat.pack_for_tpu(jst))
    with pytest.raises(ValueError, match="multiple of 64"):
        tformat.qdense_from_state(dataclasses.replace(st, shape=(96, 200)))


def test_quantize_for_tpu_refuses():
    w = _weight((128, 256))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tformat.quantize_for_tpu(w, method="native", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tformat.quantize_for_tpu(w, shards=2, device="cpu")
    with pytest.raises(ValueError, match="method="):
        tformat.quantize_for_tpu(w, method="fast", device="cpu")
    with pytest.raises(ValueError, match="quant_type"):
        tformat.quantize_for_tpu(w, quant_type="int4", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tformat.quantize_for_tpu(w)  # the card by default, never a quiet CPU run
    with pytest.raises(ValueError, match="multiple of 64"):
        tformat.quantize_for_tpu(_weight((8, 100)), device="cpu")
