"""``nf4_matmul`` (the plain version of kernel B) against nf4_tpu.

On the CPU the JAX package takes its exact path (fp32 weights); the port's
bf16 path rounds each weight value to bf16 as the kernel does, so the two
agree within the bf16 contract: max relative error < 2e-2 (max abs
difference over max abs value).

Kernel E's prefill arithmetic, 3xTF32, is emulated here in torch on the
bit patterns and held to the fp32 contract (1e-5 of the largest output)
against ``nf4_tpu.nf4_matmul``.

Kernel B's decode kernel is emulated the same way: its mma.sync A
registers rebuilt from the bytes its mapping names (one byte-table word
times a bf16 scale per register), held bit for bit to the plain weights,
and its products, warp and K-split sums and epilogue held to
``nf4_tpu.nf4_matmul`` within 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf4_tpu
import nf4_tpu_torch
from nf4_tpu.nf4.reference import quantize_nf4

REL_TOL = 2e-2


def _pair(rng, shape, shards=1, quant_type="nf4"):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    state = quantize_nf4(w, quant_type=quant_type)
    return (
        nf4_tpu.pack_for_tpu(state, dtype=jnp.bfloat16, shards=shards),
        nf4_tpu_torch.pack_for_tpu(state, dtype=torch.bfloat16, shards=shards, device="cpu"),
    )


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize(
    "bshape,shape,shards,out",
    [
        ((1,), (256, 1024), 1, "bf16"),  # decode GEMV
        ((37,), (256, 1024), 1, "bf16"),
        ((2, 3), (256, 1024), 1, "bf16"),  # leading batch dims
        ((37,), (100, 320), 1, "bf16"),  # padded shape
        ((5,), (100, 384), 2, "bf16"),  # K-chunked (row-parallel) layout
        ((37,), (256, 1024), 1, "fp32"),
        ((300,), (256, 1024), 1, "bf16"),  # the serving run's ragged prompt rows
        ((700,), (256, 1024), 1, "fp32"),
    ],
)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_bf16_matmul_matches(rng, bshape, shape, shards, out, quant_type):
    pj, pt = _pair(rng, shape, shards, quant_type)
    x = rng.standard_normal((*bshape, shape[1])).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out == "bf16" else (jnp.float32, torch.float32)
    want = nf4_tpu.nf4_matmul(jnp.asarray(x, jnp.bfloat16), pj, out_dtype=jdt)
    got = nf4_tpu_torch.nf4_matmul(torch.from_numpy(x).to(torch.bfloat16), pt, out_dtype=tdt)
    assert got.shape == (*bshape, shape[0]) and got.dtype == tdt
    assert _rel_err(got.float().numpy(), want) < REL_TOL


@pytest.mark.parametrize("xdt", ["fp32", "fp16"])
def test_exact_path_for_fp32_fp16_activations(rng, xdt):
    """fp32/fp16 activations take the exact path (kernel E's plain version
    on the CPU)."""
    pj, pt = _pair(rng, (100, 320))
    x = rng.standard_normal((7, 320)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if xdt == "fp32" else (jnp.float16, torch.float16)
    want = np.asarray(nf4_tpu.nf4_matmul(jnp.asarray(x, jdt), pj), np.float32)
    got = nf4_tpu_torch.nf4_matmul(torch.from_numpy(x).to(tdt), pt)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-3, atol=1e-3)


def test_byte_table_matches_jax(rng):
    """The 256-entry byte -> bf16-pair table kernel B receives is the JAX
    package's table, bit for bit."""
    from nf4_tpu.ops.matmul import _byte_word_tables

    from nf4_tpu_torch.ops.lut_eval import byte_word_table

    for qt in ("nf4", "fp4"):
        lo, hi = _byte_word_tables(qt)
        want = np.concatenate([lo.ravel(), hi.ravel()])
        np.testing.assert_array_equal(byte_word_table(qt, "cpu").numpy(), want)


@pytest.mark.parametrize(
    "m_pad,nkb,want",
    [
        (28672, 64, 1),  # w_gateup: 4 x 224 tiles of 256 x 128 (one 1024-row prompt) fill the card
        (4096, 224, 1),  # w_down: 4 x 32 = 128 tiles, one wave without a split
        (6144, 64, 1),  # wqkv: 4 x 48 tiles, one wave (a 64-row prompt took 5 splits before)
        (1024, 16, 4),  # the card tests' small model's wqkv: 4 x 8 tiles x 4 splits of 4 K steps
        (640, 48, 6),  # m_pad not a multiple of 256: 4 x 5 tiles x 6 splits of 8 K steps
    ],
)
def test_prefill_ksplit(monkeypatch, m_pad, nkb, want):
    """Kernel B's (and D's) prefill kernel splits K as far as one wave of a
    1024-row prompt's 256 x 128 tiles allows on a 132-SM card, with no
    empty split, whatever rows the call has and whatever layout
    ``_prefill_rows`` picks for them: the split is a function of the
    weight, so a row is summed in the same order whatever shares its call."""
    import types

    from nf4_tpu_torch.ops import matmul as tm

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(multi_processor_count=132))
    ksplit = tm._prefill_ksplit(m_pad, nkb, "cuda")
    per = -(-nkb // ksplit)
    assert ksplit == want and (ksplit - 1) * per < nkb
    # Prompt rows take the prefill kernel at every count; other calls of
    # at most 16 rows the decode kernel.
    assert [tm._pick_bm(b, prefill=True) for b in (1, 16, 17)] == [64, 64, 64]
    assert [tm._pick_bm(b) for b in (1, 16, 17)] == [16, 16, 64]


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 to nearest, ties away from zero (``cvt.rna.tf32.f32``),
    on the int32 view of the bits: add half the unit of the 13 dropped bits
    to the magnitude, then clear them (the sign bit is untouched)."""
    u = t.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(t: torch.Tensor):
    hi = _tf32_rna(t)
    return hi, _tf32_rna(t - hi)


@pytest.mark.parametrize("b,shape", [(37, (100, 320)), (64, (64, 1024)), (100, (256, 1024))])
def test_exact_3xtf32_meets_fp32_contract(rng, b, shape):
    """Kernel E's prefill products, emulated: x and W^T split into tf32
    halves, x_lo.w_hi + x_hi.w_lo + x_hi.w_hi, against nf4_tpu's fp32 path
    within 1e-5 of the largest output."""
    from nf4_tpu_torch.ops.dequant import _dequant_t_plain

    pj, pt = _pair(rng, shape)
    m, n = shape
    n_pad = pt.padded_shape[1]
    x = rng.standard_normal((b, n)).astype(np.float32)
    want = np.asarray(nf4_tpu.nf4_matmul(jnp.asarray(x), pj), np.float32)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, n_pad - n))
    wt = _dequant_t_plain(pt.packed, pt.scales, torch.float32)
    (xh, xl), (wh, wl) = _tf32_split(xp), _tf32_split(wt)
    for h in (xh, xl, wh, wl):  # tf32 values: the 13 low bits are 0
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert ((xh + xl - xp).abs() <= xp.abs() * 2.0**-22).all()
    y = (xl @ wh + xh @ wl + xh @ wh)[:, :m].numpy()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


def test_exact_3xtf32_fp16_x_has_no_low_half(rng):
    """fp16 x is exact in tf32, so x_lo = 0 and kernel E skips x_lo.w_hi."""
    x = torch.from_numpy((rng.standard_normal((64, 1024)) * 30).astype(np.float16)).float()
    hi, lo = _tf32_split(x)
    assert torch.equal(hi, x) and not lo.any()


# Kernel B's decode kernel (csrc/matmul.cu, namespace dk): 128 columns and
# 16 batch rows per block, WARPS warps over the block's scale blocks.
_DK_WARPS = 4


def _decode_registers(packed, scales, quant_type):
    """The A registers of kernel B's decode kernel, as bf16 bits, indexed
    [column tile, scale block kb, K step s, m-tile mt, lane group g, lane t,
    piece p, column e, half]: the byte at packed row 32kb + 8t + 2s + p,
    column 128ct + 16g + 2mt + e, through the byte table (half 0 = low
    nibble = K row 2j), times the column's bf16 scale.  Also returns each
    register half's K row and column."""
    from nf4_tpu_torch.ops.lut_eval import byte_word_table

    khalf, m_pad = packed.shape
    ct, kb, s, mt, g, t, p, e, half = torch.meshgrid(
        *(torch.arange(k) for k in (m_pad // 128, khalf // 32, 4, 8, 8, 4, 2, 2, 2)), indexing="ij")
    row = 32 * kb + 8 * t + 2 * s + p
    col = 128 * ct + 16 * g + 2 * mt + e
    word = byte_word_table(quant_type, "cpu").long()[packed[row, col].long()] & 0xFFFFFFFF
    bits = ((word >> (16 * half)) & 0xFFFF).to(torch.int32).to(torch.int16)  # two's-complement view
    code = bits.view(torch.bfloat16).float()
    scale = scales.to(torch.bfloat16).float()[kb, col]
    return (code * scale).to(torch.bfloat16), 2 * row + half, col


def _emulate_decode(x_pad, packed, scales, quant_type, ksplit):
    """y [16, m_pad] as the decode kernel computes it: per column tile and
    K step the 16 x 16 A tiles times x's 16 x 16 B tile (K slot 2t + 8p +
    half = K row 64kb + 16t + 4s + 2p + half), summed per warp over its
    scale blocks, the warps in order, the splits in order; then the
    accumulator fragments through the epilogue's column mapping."""
    regs, _, _ = _decode_registers(packed, scales, quant_type)
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


_DECODE_CASES = [((640, 1024), 3), ((100, 320), 1), ((256, 3072), 5)]


@pytest.mark.parametrize("shape,ksplit", _DECODE_CASES)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_decode_registers_are_the_plain_weights(rng, shape, ksplit, quant_type):
    """Every A register half of the decode kernel lands on a distinct (K
    row, column) of W^T, and together they are ``_bf16_weight_t`` bit for
    bit."""
    from nf4_tpu_torch.ops.dequant import _bf16_weight_t

    _, pt = _pair(rng, shape, quant_type=quant_type)
    regs, krow, col = _decode_registers(pt.packed, pt.scales, quant_type)
    want = _bf16_weight_t(pt.packed, pt.scales, quant_type)
    hits = torch.zeros(want.shape, dtype=torch.int32).index_put_((krow.ravel(), col.ravel()),
                                                                 torch.ones(krow.numel(), dtype=torch.int32),
                                                                 accumulate=True)
    assert (hits == 1).all()
    got = torch.zeros(want.shape, dtype=torch.bfloat16).index_put_((krow.ravel(), col.ravel()), regs.ravel())
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("shape,ksplit", _DECODE_CASES)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_decode_emulation_matches(rng, b, shape, ksplit, quant_type):
    """The decode kernel's products, sums and epilogue, emulated, against
    nf4_tpu's matmul on the same inputs (uneven K splits and warp shares
    at (640, 1024) in 3 splits: 6, 6, 4 scale blocks; padded columns at m
    = 100)."""
    pj, pt = _pair(rng, shape, quant_type=quant_type)
    m, n = shape
    m_pad, n_pad = pt.padded_shape
    x = rng.standard_normal((b, n)).astype(np.float32)
    want = np.asarray(nf4_tpu.nf4_matmul(jnp.asarray(x, jnp.bfloat16), pj, out_dtype=jnp.float32), np.float32)
    x_pad = torch.nn.functional.pad(torch.from_numpy(x).to(torch.bfloat16), (0, n_pad - n, 0, 16 - b))
    y = _emulate_decode(x_pad, pt.packed, pt.scales, quant_type, ksplit)
    assert not y.isnan().any() and not y[b:].any() and not y[:, m:].any()
    assert _rel_err(y[:b, :m].numpy(), want) < REL_TOL


@pytest.mark.parametrize(
    "blocks_per_sm,m_pad,nkb,want",
    [
        (2, 6144, 64, 5),  # wqkv: 48 tiles x 5 splits of 13, 12 scale blocks = 240 of 264 slots
        (2, 4096, 64, 8),  # wo: 32 tiles x 8 splits of 8
        (2, 28672, 64, 1),  # w_gateup: 224 tiles fill the card alone
        (2, 4096, 224, 8),  # w_down: 32 x 8 splits of 28
        (1, 6144, 64, 2),  # one block per SM: 48 x 2 splits of 32
        (1, 4096, 224, 4),
        (2, 1536, 64, 22),  # 12 tiles x 22 splits of 3, the last 1: uneven
    ],
)
def test_decode_ksplit(monkeypatch, blocks_per_sm, m_pad, nkb, want):
    """Kernel B's decode kernel splits K as far as one wave of resident
    blocks on a 132-SM card allows beside the Llama-3-8B projections'
    column tiles at b_pad 16, with no empty split."""
    import types

    from nf4_tpu_torch.ops import matmul as tm

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(tm, "_decode_shape", lambda dev, query=None: (128, blocks_per_sm))
    ksplit = tm._decode_ksplit(16, m_pad, nkb, "cuda")
    per = -(-nkb // ksplit)
    assert ksplit == want and (ksplit - 1) * per < nkb


# Kernel E's decode kernel (csrc/matmul_exact.cu, namespace ed): kernel B's
# column mapping and warps, 3xTF32 on mma.sync m16n8k8, K step s of a scale
# block = packed row 8t + s of lane t.
def _exact_decode_registers(packed, scales, quant_type):
    """The A registers of kernel E's decode kernel as tf32 halves (fp32
    words), indexed [column tile, scale block kb, word w, half e, K step s,
    lane group g, lane t, register i], rebuilt as the kernel builds them:
    word w of the 16-byte piece of packed row 32kb + 8t + s at columns
    128ct + 16g .. +15 (m-tiles 2w + e); register i takes the nibble at bit
    16e + (0, 8, 4, 12)[i] through the fp32 code table, times the scale of
    its column (byte 2e for a0/a2, 2e + 1 for a1/a3) in fp32, split into
    hi = v with its 13 low bits cleared and lo = v - hi.  Also returns each
    register's K row and column."""
    from nf4_tpu_torch.ops.lut_eval import code_tensor

    khalf, m_pad = packed.shape
    ct, kb, w, e, s, g, t, i = torch.meshgrid(
        *(torch.arange(k) for k in (m_pad // 128, khalf // 32, 4, 2, 8, 8, 4, 4)), indexing="ij")
    row = 32 * kb + 8 * t + s
    c0 = 128 * ct + 16 * g + 4 * w  # the word's first column
    word = sum(packed[row, c0 + j].long() << (8 * j) for j in range(4))
    sh = 16 * e + torch.tensor([0, 8, 4, 12])[i]
    nib = (word >> sh) & 0xF
    col = c0 + 2 * e + i % 2
    v = code_tensor(quant_type, "cpu")[nib] * scales[kb, col]
    hi = _tf32_trunc(v)
    return hi, v - hi, 2 * row + i // 2, col


def _tf32_trunc(t: torch.Tensor) -> torch.Tensor:
    """t as the tensor cores read it in tf32: its 13 low bits cleared."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _emulate_exact_decode(x_pad, packed, scales, quant_type, ksplit):
    """y [16, m_pad] as kernel E's decode kernel computes it: per column
    tile, scale block and m-tile the products of its 8 K steps (A [16 rows x
    8 slots]: rows g, g + 8 from registers i % 2, slots t, t + 4 from i //
    2, w_lo as the tensor cores read it; x's B [8 slots x 16 batch rows]:
    slot t + 4h = K row 64kb + 16t + 2s + h, x split by rna), x_lo.w_hi +
    x_hi.w_lo + x_hi.w_hi (fp16 x: no x_lo), summed from
    0 per half scale block (steps 0-3, 4-7); those sums added per warp over
    its scale blocks, the warps in order, the splits in order; then the
    epilogue's column mapping."""
    hi, lo, _, _ = _exact_decode_registers(packed, scales, quant_type)
    n_ct, nkb = hi.shape[:2]

    def a_tiles(r):  # [ct, kb, w, e, s, g, t, i] -> [ct, kb, mt, s, A row (i % 2) g, slot (i // 2) t]
        r = r.reshape(n_ct, nkb, 4, 2, 8, 8, 4, 2, 2)  # i = 2 (i // 2) + i % 2
        return r.permute(0, 1, 2, 3, 4, 8, 5, 7, 6).reshape(n_ct, nkb, 8, 8, 16, 8)

    ah, al = a_tiles(hi), a_tiles(_tf32_trunc(lo))
    xf = x_pad.float()
    xh, xl = _tf32_split(xf)  # x by cvt.rna
    kb, s, h, t = torch.meshgrid(*(torch.arange(k) for k in (nkb, 8, 2, 4)), indexing="ij")
    krow = (64 * kb + 16 * t + 2 * s + h).reshape(nkb, 8, 8)  # [kb, s, slot t + 4h]
    bh = xh[:, krow].permute(1, 2, 3, 0)[None, :, None]  # [1, kb, 1, s, slot, batch row]
    bl = xl[:, krow].permute(1, 2, 3, 0)[None, :, None]
    steps = ah @ bl + al @ bh + ah @ bh if x_pad.dtype == torch.float32 else al @ bh + ah @ bh
    # [ct, kb, mt, half, 16 A rows, 16 batch rows]: each half block (4 K steps) from 0
    prod = steps.reshape(n_ct, nkb, 8, 2, 4, 16, 16).sum(dim=4)
    per = -(-nkb // ksplit)
    c = None
    for z in range(ksplit):
        lo_kb, hi_kb = z * per, min(nkb, (z + 1) * per)
        part = None
        for wp in range(_DK_WARPS):
            wsum = torch.zeros_like(prod[:, 0, :, 0])
            for k in range(lo_kb + wp, hi_kb, _DK_WARPS):
                wsum = wsum + prod[:, k, :, 0] + prod[:, k, :, 1]
            part = wsum if part is None else part + wsum
        c = part if c is None else c + part
    y = torch.full((16, n_ct * 128), float("nan"))
    for g in range(8):
        for t in range(4):
            for mt in range(8):
                for nt in range(2):
                    for i in range(4):  # C row g + 8(i // 2) = column 16g + 2mt + i // 2; batch row 8nt + 2t + i % 2
                        y[8 * nt + 2 * t + i % 2, torch.arange(n_ct) * 128 + 16 * g + 2 * mt + i // 2] = \
                            c[:, mt, g + 8 * (i // 2), 8 * nt + 2 * t + i % 2]
    return y


@pytest.mark.parametrize("shape,ksplit", _DECODE_CASES)
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_exact_decode_registers_are_the_plain_weights(rng, shape, ksplit, quant_type):
    """Every A register of kernel E's decode kernel lands on a distinct (K
    row, column) of W^T, and its hi + lo is ``_dequant_t_plain``'s fp32
    value (bit for bit but the sign of a zero), with the 13 low bits of hi
    zero; hi and lo as the
    tensor cores read them (lo's 13 low bits dropped) are within 2^-21 of
    the value."""
    from nf4_tpu_torch.ops.dequant import _dequant_t_plain

    _, pt = _pair(rng, shape, quant_type=quant_type)
    hi, lo, krow, col = _exact_decode_registers(pt.packed, pt.scales, quant_type)
    want = _dequant_t_plain(pt.packed, pt.scales, torch.float32, quant_type)
    hits = torch.zeros(want.shape, dtype=torch.int32).index_put_((krow.ravel(), col.ravel()),
                                                                 torch.ones(krow.numel(), dtype=torch.int32),
                                                                 accumulate=True)
    assert (hits == 1).all()
    got_hi = torch.zeros_like(want).index_put_((krow.ravel(), col.ravel()), hi.ravel())
    got_lo = torch.zeros_like(want).index_put_((krow.ravel(), col.ravel()), lo.ravel())
    assert torch.equal(got_hi + got_lo, want)  # bit for bit but the sign of zero
    assert not (got_hi.view(torch.int32) & 0x1FFF).any()
    assert ((got_hi + _tf32_trunc(got_lo) - want).abs() <= want.abs() * 2.0**-21).all()


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("xdt", ["fp32", "fp16"])
@pytest.mark.parametrize("shape,ksplit", _DECODE_CASES)
def test_exact_decode_emulation_matches(rng, b, xdt, shape, ksplit):
    """Kernel E's decode kernel, emulated, against nf4_tpu's fp32 matmul on
    the same inputs within 1e-5 of the largest output (uneven K splits and
    warp shares at (640, 1024) in 3 splits; padded columns at m = 100)."""
    pj, pt = _pair(rng, shape)
    m, n = shape
    n_pad = pt.padded_shape[1]
    jdt, tdt = (jnp.float32, torch.float32) if xdt == "fp32" else (jnp.float16, torch.float16)
    x = rng.standard_normal((b, n)).astype(np.float32)
    want = np.asarray(nf4_tpu.nf4_matmul(jnp.asarray(x, jdt), pj, out_dtype=jnp.float32), np.float32)
    x_pad = torch.nn.functional.pad(torch.from_numpy(x).to(tdt), (0, n_pad - n, 0, 16 - b))
    y = _emulate_exact_decode(x_pad, pt.packed, pt.scales, "nf4", ksplit)
    assert not y.isnan().any() and not y[b:].any() and not y[:, m:].any()
    assert np.abs(y[:b, :m].numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("xdt", [torch.float32, torch.float16])
def test_exact_decode_dispatch(monkeypatch, xdt):
    """Kernel E's wrapper sends decode rows (b_pad 16) to its decode kernel
    with the K split its own shape query allows (one wave of 2 resident
    blocks per SM on a 132-SM card) and the tile counters, for Llama-3-8B's
    four projections; prefill rows get no counters."""
    import types

    from nf4_tpu_torch.ops import matmul as tm

    queries = set()

    def shape(dev, query=tm._B_DECODE):
        queries.add(query)
        return 128, 2

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(tm, "_decode_shape", shape)
    monkeypatch.setattr(tm, "_tile_counters", lambda dev, tiles: torch.zeros(tiles, dtype=torch.int32))
    launched = []
    monkeypatch.setattr(tm, "_EXACT_KERNEL", lambda *args: launched.append(args))
    want = {"wqkv": (6144, 4096, 5), "wo": (4096, 4096, 8), "w_gateup": (28672, 4096, 1), "w_down": (4096, 14336, 8)}
    for name, (m, n, splits) in want.items():
        packed = torch.empty((n // 2, m), dtype=torch.uint8)
        scales = torch.empty((n // 64, m), dtype=torch.float32)
        tm._matmul_exact_kernel(torch.empty((16, n), dtype=xdt), packed, scales, torch.float32)
        *_, bm, x_kind, xsplit, counters, ksplit, _ = launched[-1]
        per = -(-(n // 64) // ksplit)
        assert (bm, x_kind, xsplit, ksplit) == (16, tm._X_KIND[xdt], None, splits), name
        assert counters is not None and (ksplit - 1) * per < n // 64, name
    assert queries == {tm._E_DECODE}
    tm._matmul_exact_kernel(torch.empty((64, 4096), dtype=xdt), packed[:2048, :4096].contiguous(),
                            scales[:64, :4096].contiguous(), torch.float32)
    *_, bm, _, xsplit, counters, _, _ = launched[-1]
    assert (bm, counters) == (128, None) and xsplit is not None
