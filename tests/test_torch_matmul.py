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
    "b_pad,m_pad,nkb,want",
    [
        (1024, 28672, 64, 1),  # w_gateup at B=1024: 4 x 224 tiles of 256 x 128 fill the card
        (1024, 4096, 224, 1),  # w_down: 4 x 32 = 128 tiles, one wave without a split
        (64, 6144, 64, 5),  # wqkv of a 64-row prompt: 24 tiles of 128 x 256 x 5 splits of 13 K steps
        (320, 6144, 64, 1),  # wqkv of a 320-row prompt: 2 x 48 tiles of 256 x 128, one wave
        (320, 640, 48, 12),  # 256 x 128 where m_pad is not a multiple of 256: 10 tiles x 12 splits
    ],
)
def test_prefill_ksplit(monkeypatch, b_pad, m_pad, nkb, want):
    """Kernel B's prefill kernel splits K only as far as one wave of the
    layout's tiles (see ``_prefill_rows``) allows on a 132-SM card, with no
    empty split."""
    import types

    from nf4_tpu_torch.ops import matmul as tm

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(multi_processor_count=132))
    ksplit = tm._prefill_ksplit(b_pad, m_pad, nkb, tm._prefill_rows(b_pad, m_pad), "cuda")
    per = -(-nkb // ksplit)
    assert ksplit == want and (ksplit - 1) * per < nkb


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
    monkeypatch.setattr(tm, "_decode_shape", lambda dev: (128, blocks_per_sm))
    ksplit = tm._decode_ksplit(16, m_pad, nkb, "cuda")
    per = -(-nkb // ksplit)
    assert ksplit == want and (ksplit - 1) * per < nkb
