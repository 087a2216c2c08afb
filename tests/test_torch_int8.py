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
* Kernel D's decode kernel emulated: every A register rebuilt from the
  int8 rows as the kernel pairs and decodes them, bit for bit against
  ``_int8_weight_t``; its products, warp sums, K splits and epilogue
  against nf4_tpu's ``int8_matmul`` (max relative error < 2e-2); its
  dispatch (block rows, K split, tile counters) on a 132-SM card.
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
from _torch_threads import _one_thread  # noqa: F401


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
        # 128 x 256 blocks up to 128 rows; the K split fills one wave of 132
        # SMs with a 1024-row prompt's tiles whatever the rows (ops/matmul.py
        # _prefill_ksplit): 1 at each of Llama-3-8B's projections.
        (64, {"wqkv": (128, 1), "wo": (128, 1), "w_gateup": (128, 1), "w_down": (128, 1)}),
        (320, {"wqkv": (256, 1), "wo": (256, 1), "w_gateup": (256, 1), "w_down": (256, 1)}),
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


# Kernel D's decode kernel (csrc/decode_mma.cuh with int8_matmul.cu's
# Int8Decode): 128 columns and 16 batch rows per block, 4 warps over the
# block's scale blocks.
_DK_WARPS = 4


def _decode_registers(values, scales):
    """The A registers of kernel D's decode kernel, as bf16, indexed [column
    tile, scale block kb, K step s, m-tile mt, lane group g, lane t, row
    pair p, column e, half], rebuilt as the kernel builds them: word mt // 2
    of the 16-byte pieces of int8 rows 64kb + 16t + 4s + 2p (half 0) and +1
    (half 1) at columns 128ct + 16g .. +15, XOR 0x80808080; byte 2(mt % 2) +
    e of each in the low mantissa byte of 2^23, minus 2^23 + 128 (exact
    fp32); the two fp32 words' high halves (the exact bf16 pair); times the
    column's bf16 scale, rounded once (``__hmul2``).  Also returns each
    register half's K row and column."""
    n_pad, m_pad = values.shape
    ct, kb, s, mt, g, t, p, e, half = torch.meshgrid(
        *(torch.arange(k) for k in (m_pad // 128, n_pad // 64, 4, 8, 8, 4, 2, 2, 2)), indexing="ij")
    row = 64 * kb + 16 * t + 4 * s + 2 * p + half
    c0 = 128 * ct + 16 * g + 4 * (mt // 2)  # the word's first column
    u8 = values.view(torch.uint8).long()
    word = sum(u8[row, c0 + j] << (8 * j) for j in range(4)) ^ 0x80808080
    byte = (word >> (8 * (2 * (mt % 2) + e))) & 0xFF
    f = (byte | 0x4B000000).to(torch.int32).view(torch.float32) - 8388736.0
    bits = f.view(torch.int32)
    assert not (bits & 0xFFFF).any()  # every value is exact in bf16
    pair = (bits >> 16).to(torch.int16).view(torch.bfloat16)
    col = 128 * ct + 16 * g + 2 * mt + e
    scale = scales.to(torch.bfloat16)[kb, col]
    # A product of two bf16 values is exact in fp32: one rounding to bf16.
    return (pair.float() * scale.float()).to(torch.bfloat16), row, col


def _emulate_decode(x_pad, values, scales, ksplit):
    """y [16, m_pad] as the decode kernel computes it: per column tile and
    K step the 16 x 16 A tiles times x's 16 x 16 B tile (K slot 8p + 2t +
    half = K row 64kb + 16t + 4s + 2p + half), summed per warp over its
    scale blocks, the warps in order, the splits in order; then the
    accumulator fragments through the epilogue's column mapping."""
    regs, _, _ = _decode_registers(values, scales)
    n_ct, nkb = regs.shape[:2]
    # [ct, kb, s, mt, g, t, p, e, half] -> A[ct, kb, s, mt][row g + 8e, slot 8p + 2t + half]
    a = regs.permute(0, 1, 2, 3, 7, 4, 6, 5, 8).reshape(n_ct, nkb, 4, 8, 16, 16).float()
    kb, s, p, t, half = torch.meshgrid(*(torch.arange(k) for k in (nkb, 4, 2, 4, 2)), indexing="ij")
    krow = (64 * kb + 16 * t + 4 * s + 2 * p + half).reshape(nkb, 4, 16)
    b = x_pad.float()[:, krow].permute(1, 2, 3, 0)  # [kb, s, slot, batch row]
    prod = (a @ b[None, :, :, None]).sum(dim=2)  # [ct, kb, mt, 16 A rows, 16 batch rows]
    per = -(-nkb // ksplit)
    c = None
    for z in range(ksplit):  # splits in order, each the sum of its warps in order
        lo, hi = z * per, min(nkb, (z + 1) * per)
        part = None
        for w in range(_DK_WARPS):
            kbs = list(range(lo + w, hi, _DK_WARPS))
            wsum = prod[:, kbs].sum(dim=1) if kbs else torch.zeros_like(prod[:, 0])
            part = wsum if part is None else part + wsum
        c = part if c is None else c + part
    # Fragments: acc[mt][nt][i] of lane (g, t) = C row g + 8(i // 2), batch row 8nt + 2t + i % 2.
    y = torch.full((16, n_ct * 128), float("nan"))
    for g in range(8):
        for t in range(4):
            acc = [[[c[:, mt, g + 8 * (i // 2), 8 * nt + 2 * t + i % 2] for i in range(4)]
                    for nt in range(2)] for mt in range(8)]
            for nt in range(2):
                for e in range(2):
                    for q in range(4):
                        vals = (acc[2 * q][nt][e], acc[2 * q][nt][2 + e],
                                acc[2 * q + 1][nt][e], acc[2 * q + 1][nt][2 + e])
                        for k, v in enumerate(vals):
                            y[8 * nt + 2 * t + e, torch.arange(n_ct) * 128 + 16 * g + 4 * q + k] = v
    return y


# (shape, shards, K splits): uneven splits and warp shares at (640, 1024) in
# 3 splits (6, 6, 4 scale blocks); padded columns at m = 100; the K-chunked
# layout (each chunk padded on its own) in 2 splits.
_DECODE_CASES = [((640, 1024), 1, 3), ((100, 320), 1, 1), ((100, 384), 2, 2)]


@pytest.mark.parametrize("shape,shards,ksplit", _DECODE_CASES)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_decode_registers_are_the_plain_weights(rng, shape, shards, ksplit, quant_type):
    """Every A register half of kernel D's decode kernel lands on a
    distinct (K row, column) of W^T, and together they are
    ``_int8_weight_t`` bit for bit."""
    _, t8 = _pair(rng, shape, shards, quant_type)
    regs, krow, col = _decode_registers(t8.values, t8.scales)
    want = tint8._int8_weight_t(t8.values, t8.scales)
    hits = torch.zeros(want.shape, dtype=torch.int32).index_put_((krow.ravel(), col.ravel()),
                                                                 torch.ones(krow.numel(), dtype=torch.int32),
                                                                 accumulate=True)
    assert (hits == 1).all()
    got = torch.zeros(want.shape, dtype=torch.bfloat16).index_put_((krow.ravel(), col.ravel()), regs.ravel())
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("shape,shards,ksplit", _DECODE_CASES)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_decode_emulation_matches(rng, b, shape, shards, ksplit, quant_type):
    """Kernel D's decode kernel, emulated, against nf4_tpu's int8_matmul on
    the same inputs."""
    j8, t8 = _pair(rng, shape, shards, quant_type)
    m, n = shape
    m_pad, n_pad = t8.padded_shape
    x = rng.standard_normal((b, n)).astype(np.float32)
    want = np.asarray(jint8.int8_matmul(jnp.asarray(x, jnp.bfloat16), j8, out_dtype=jnp.float32), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(b, shards, n // shards)  # each K chunk padded on its own
    x_pad = torch.nn.functional.pad(xt, (0, n_pad // shards - n // shards)).reshape(b, n_pad)
    y = _emulate_decode(torch.nn.functional.pad(x_pad, (0, 0, 0, 16 - b)), t8.values, t8.scales, ksplit)
    assert not y.isnan().any() and not y[b:].any() and not y[:, m:].any()
    assert _rel_err(y[:b, :m].numpy(), want) < 2e-2


@pytest.mark.parametrize("blocks_per_sm,want", [
    # wqkv 48 column tiles, wo 32, w_gateup 224 (fills the card alone), w_down 32.
    (2, {"wqkv": 5, "wo": 8, "w_gateup": 1, "w_down": 8}),
    (1, {"wqkv": 2, "wo": 4, "w_gateup": 1, "w_down": 4}),
])
def test_decode_dispatch(monkeypatch, blocks_per_sm, want):
    """Kernel D's wrapper sends decode rows (b_pad 16) to the decode kernel
    with the K split its own shape query allows (one wave of resident
    blocks on a 132-SM card) and the tile counters, for Llama-3-8B's four
    projections."""
    import types

    from nf4_tpu_torch.ops import matmul as tm

    queries = set()

    def shape(dev, query=tm._B_DECODE):
        queries.add(query)
        return 128, blocks_per_sm

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(tm, "_decode_shape", shape)
    monkeypatch.setattr(tint8, "_tile_counters", lambda dev, tiles: torch.zeros(tiles, dtype=torch.int32))
    launched = []
    monkeypatch.setattr(tint8, "_KERNEL", lambda *args: launched.append(args))
    for name, (m, n) in LLAMA3_8B.items():
        x = torch.empty((16, n), dtype=torch.bfloat16)
        values = torch.empty((n, m), dtype=torch.int8)
        scales = torch.empty((n // 64, m), dtype=torch.float32)
        tint8._int8_matmul_kernel(x, values, scales, torch.bfloat16)
        counters, *_, bm, ksplit, _ = launched[-1][5:]
        per = -(-(n // 64) // ksplit)
        assert (bm, ksplit) == (16, want[name]) and (ksplit - 1) * per < n // 64, name
        assert counters is not None
    assert queries == {tint8._D_DECODE}
