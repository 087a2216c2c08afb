"""The int8 recode and ``int8_matmul`` (the plain version of kernel D)
against nf4_tpu's ``ops/int8_serve.py``.

* The recode is byte-identical (values) and bit-identical (scales).
* The plain version of kernel D against the JAX kernel in interpret mode:
  max relative error < 2e-2 (both round each weight to bf16 and take a bf16
  product with fp32 sums, in other orders).
* ``int8_matmul`` against JAX ``int8_matmul`` on the CPU, which takes its
  fp32 path: max relative error < 3e-2, the JAX package's own bound for
  bf16 activations (``tests/test_int8_serve.py``); fp32/fp16 activations
  take the same fp32 path in both, so rtol = atol = 1e-3.
* Kernel D's prefill decode, emulated on bit patterns: the byte trick that
  turns an int8 into fp32 is exact for all 256 bytes, and the decoded
  weight equals ``_int8_weight_t`` bit for bit.
* Kernel D's prefill dispatch (layout and K split) on a 132-SM card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf4_tpu
import nf4_tpu_torch
from nf4_tpu.nf4.reference import quantize_nf4
from nf4_tpu.ops import int8_serve as jint8
from nf4_tpu_torch.ops import int8_serve as tint8


def _pair(rng, shape, shards=1, quant_type="nf4"):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    state = quantize_nf4(w, quant_type=quant_type)
    pj = nf4_tpu.pack_for_tpu(state, dtype=jnp.bfloat16, shards=shards)
    pt = nf4_tpu_torch.pack_for_tpu(state, dtype=torch.bfloat16, shards=shards, device="cpu")
    return jint8.recode_int8_weight(pj), tint8.recode_int8_weight(pt)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


SHAPES = [((256, 1024), 1), ((100, 320), 1), ((100, 384), 2)]


@pytest.mark.parametrize("shape,shards", SHAPES)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_recode_identical(rng, shape, shards, quant_type):
    j8, t8 = _pair(rng, shape, shards, quant_type)
    assert t8.values.dtype == torch.int8 and t8.scales.dtype == torch.float32
    assert (t8.shape, t8.padded_shape, t8.shards) == (tuple(j8.shape), tuple(j8.padded_shape), j8.shards)
    np.testing.assert_array_equal(t8.values.numpy(), np.asarray(j8.values))
    np.testing.assert_array_equal(t8.scales.numpy().view(np.uint32), np.asarray(j8.scales).view(np.uint32))
    assert t8.nbytes == j8.nbytes


def test_recode_in_chunks_identical(rng, monkeypatch):
    """A weight above the chunk limit recodes in chunks of whole scale rows,
    with the same bytes as in one piece."""
    state = quantize_nf4(rng.standard_normal((256, 2048)).astype(np.float32) * 0.05)
    j8 = jint8.recode_int8_weight(nf4_tpu.pack_for_tpu(state, dtype=jnp.bfloat16))
    pt = nf4_tpu_torch.pack_for_tpu(state, dtype=torch.bfloat16, device="cpu")
    monkeypatch.setattr(tint8, "_RECODE_CHUNK_BYTES", 64 * 1024)
    assert pt.packed.numel() > 2 * 64 * 1024
    t8 = tint8.recode_int8_weight(pt)
    np.testing.assert_array_equal(t8.values.numpy(), np.asarray(j8.values))
    np.testing.assert_array_equal(t8.scales.numpy().view(np.uint32), np.asarray(j8.scales).view(np.uint32))


@pytest.mark.parametrize("b,out", [(16, "bf16"), (32, "fp32")])
def test_plain_matches_jax_kernel_interpret(rng, b, out):
    j8, t8 = _pair(rng, (256, 1024))
    x = rng.standard_normal((b, 1024)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    want = jint8._int8_matmul_pallas(jnp.asarray(x, jnp.bfloat16), j8.values, j8.scales, jdt, (16, 512, 128), True)
    got = tint8._int8_matmul_plain(torch.from_numpy(x).to(torch.bfloat16), t8.values, t8.scales, tdt)
    assert got.dtype == tdt
    assert _rel_err(got.float().numpy(), want) < 2e-2


@pytest.mark.parametrize(
    "bshape,shape,shards,out",
    [
        ((1,), (256, 1024), 1, "bf16"),  # decode GEMV
        ((4,), (256, 1024), 1, "bf16"),
        ((2, 3), (256, 1024), 1, "bf16"),  # leading batch dims
        ((37,), (100, 320), 1, "bf16"),  # padded shape
        ((5,), (100, 384), 2, "bf16"),  # K-chunked layout: per-chunk padding
        ((37,), (256, 1024), 1, "fp32"),
    ],
)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_int8_matmul_matches_jax(rng, bshape, shape, shards, out, quant_type):
    j8, t8 = _pair(rng, shape, shards, quant_type)
    x = rng.standard_normal((*bshape, shape[1])).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    want = jint8.int8_matmul(jnp.asarray(x, jnp.bfloat16), j8, out_dtype=jdt)
    got = tint8.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), t8, out_dtype=tdt)
    assert got.shape == (*bshape, shape[0]) and got.dtype == tdt
    assert _rel_err(got.float().numpy(), want) < 3e-2


@pytest.mark.parametrize("xdt", ["fp32", "fp16"])
@pytest.mark.parametrize("shape,shards", [((100, 320), 1), ((100, 384), 2)])
def test_fp32_fp16_activations_take_the_fp32_path(rng, xdt, shape, shards):
    j8, t8 = _pair(rng, shape, shards)
    x = rng.standard_normal((7, shape[1])).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if xdt == "fp32" else (jnp.float16, torch.float16)
    want = np.asarray(jint8.int8_matmul(jnp.asarray(x, jdt), j8), np.float32)
    got = tint8.int8_matmul(torch.from_numpy(x).to(tdt), t8)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-3, atol=1e-3)


def test_kernel_weight_values(rng):
    """The plain version's weights are bf16(int8 * bf16(scale)), rounded
    once: the TPU kernel's values, computed here with numpy and ml_dtypes."""
    import ml_dtypes

    _, t8 = _pair(rng, (100, 320))
    v = t8.values.numpy().astype(np.float32)
    s = t8.scales.numpy().astype(ml_dtypes.bfloat16).astype(np.float32)
    want = (v * np.repeat(s, 64, axis=0)).astype(ml_dtypes.bfloat16)
    got = tint8._int8_weight_t(t8.values, t8.scales)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))


def _byte_trick(b: torch.Tensor) -> torch.Tensor:
    """Kernel D's int8 -> fp32 conversion, on the bit patterns: the byte
    (two's complement) XOR 0x80 is x + 128, which becomes the low mantissa
    byte of the fp32 2^23 + x + 128; subtracting 2^23 + 128 leaves x."""
    u = (b.to(torch.int32) & 0xFF) ^ 0x80
    return (u | 0x4B000000).view(torch.float32) - 8388736.0


def test_kernel_d_byte_trick_exact():
    b = torch.arange(256, dtype=torch.int32)
    assert torch.equal(_byte_trick(b), b.to(torch.uint8).view(torch.int8).float())


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_kernel_d_decode_matches_weight_t(rng, quant_type):
    """bf16(x * bf16(scale)) in fp32 from the byte trick, on a weight
    quantized and recoded by nf4_tpu, is ``_int8_weight_t`` bit for bit."""
    w = rng.standard_normal((100, 320)).astype(np.float32) * 0.05
    j8 = jint8.recode_int8_weight(nf4_tpu.quantize_for_tpu(w, method="oracle", quant_type=quant_type))
    values = torch.from_numpy(np.array(j8.values))
    scales = torch.from_numpy(np.array(j8.scales))
    s = scales.to(torch.bfloat16).float().repeat_interleave(64, dim=0)
    got = (_byte_trick(values) * s).to(torch.bfloat16)
    want = tint8._int8_weight_t(values, scales)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


LLAMA3_8B = {"wqkv": (6144, 4096), "wo": (4096, 4096), "w_gateup": (28672, 4096), "w_down": (4096, 14336)}


@pytest.mark.parametrize(
    "b_pad,want",
    [
        # 128 x 256 blocks up to 128 rows; K split to fill one wave of 132 SMs.
        (64, {"wqkv": (128, 5), "wo": (128, 8), "w_gateup": (128, 1), "w_down": (128, 8)}),
        (320, {"wqkv": (256, 1), "wo": (256, 2), "w_gateup": (256, 1), "w_down": (256, 2)}),
        (1024, {"wqkv": (256, 1), "wo": (256, 1), "w_gateup": (256, 1), "w_down": (256, 1)}),
    ],
)
def test_prefill_dispatch(monkeypatch, b_pad, want):
    """Kernel D's wrapper passes the C entry the prefill layout (block rows)
    and K split for Llama-3-8B's four projections on a 132-SM card."""
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(multi_processor_count=132))
    launched = []
    monkeypatch.setattr(tint8, "_KERNEL", lambda *args: launched.append(args))
    for name, (m, n) in LLAMA3_8B.items():
        x = torch.empty((b_pad, n), dtype=torch.bfloat16)
        values = torch.empty((n, m), dtype=torch.int8)
        scales = torch.empty((n // 64, m), dtype=torch.float32)
        tint8._int8_matmul_kernel(x, values, scales, torch.bfloat16)
        *_, bm, ksplit, _ = launched[-1]
        per = -(-(n // 64) // ksplit)
        assert (bm, ksplit) == want[name] and (ksplit - 1) * per < n // 64, name
