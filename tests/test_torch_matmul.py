"""``nf4_matmul`` (the plain version of kernel B) against nf4_tpu.

On the CPU the JAX package takes its exact path (fp32 weights); the port's
bf16 path rounds each weight value to bf16 as the kernel does, so the two
agree within the bf16 contract: max relative error < 2e-2 (max abs
difference over max abs value).

Kernel E's prefill arithmetic, 3xTF32, is emulated here in torch on the
bit patterns and held to the fp32 contract (1e-5 of the largest output)
against ``nf4_tpu.nf4_matmul``.
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
