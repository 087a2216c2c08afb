"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  Run them on
a machine with an H100 (sm_90a) and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Kernels A and F must be bit-exact (and so must kernel D's prefill weight
values); kernels B, C (bf16 and int8 KV) and D within 2e-2 (bf16 products summed in another order than the plain
version's); kernel E (fp32 products) within 1e-5 of the largest value for
fp32 out, within one rounding for fp16 (2e-3) and bf16 (8e-3) out, its
decode kernel's weights w_hi + w_lo bit for bit; the
``nf4_matmul`` backward within 1e-5 of the largest value, under every
``torch.set_float32_matmul_precision`` setting.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _packed(gen, m, n, dev, quant_type="nf4"):
    from nf4_tpu_torch.nf4.format import PackedNF4, pad_to

    m_pad, n_pad = pad_to(m, 128), pad_to(n, 1024)
    return PackedNF4(
        packed=torch.randint(0, 256, (n_pad // 2, m_pad), generator=gen, device=dev, dtype=torch.uint8),
        scales=torch.rand((n_pad // 64, m_pad), generator=gen, device=dev) * 0.02,
        shape=(m, n), padded_shape=(m_pad, n_pad), dtype=torch.bfloat16, quant_type=quant_type,
    )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequant_kernel_bit_exact(dev, dtype, quant_type):
    from nf4_tpu_torch.ops.dequant import _dequant_t_kernel, _dequant_t_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    pw = _packed(gen, 384, 2048, dev)
    got = _dequant_t_kernel(pw.packed, pw.scales, dtype, quant_type)
    want = _dequant_t_plain(pw.packed, pw.scales, dtype, quant_type)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("b", [1, 4, 8, 16, 37, 200])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("shape", [(640, 3072), (1536, 4096)])
def test_matmul_kernel_close(dev, b, out_dtype, shape):
    """Kernel B at decode (b <= 16) and prefill rows; at decode (1536, 4096)
    splits K unevenly (12 column tiles: the last split is shorter)."""
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_kernel, _matmul_bf16_plain, _pick_bm

    m, n = shape
    gen = torch.Generator(device=dev).manual_seed(1)
    pw = _packed(gen, m, n, dev)
    b_pad = -(-b // _pick_bm(b)) * _pick_bm(b)
    x = torch.zeros((b_pad, n), device=dev, dtype=torch.bfloat16)
    x[:b] = torch.randn((b, n), generator=gen, device=dev).to(torch.bfloat16)
    got = _matmul_bf16_kernel(x, pw.packed, pw.scales, out_dtype)
    want = _matmul_bf16_plain(x, pw.packed, pw.scales, out_dtype).float()
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (b_pad, pw.padded_shape[0])
    assert ((got.float() - want).abs().max() / want.abs().max()).item() < 2e-2


def _decode_case(gen, dev, m, n, b=4):
    pw = _packed(gen, m, n, dev)
    x = torch.zeros((16, pw.padded_shape[1]), device=dev, dtype=torch.bfloat16)
    x[:b, :n] = torch.randn((b, n), generator=gen, device=dev).to(torch.bfloat16)
    return x, pw


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_matmul_decode_weight_values(dev, quant_type):
    """One-hot rows of x read single K rows of W^T through kernel B's decode
    kernel: fp32 out equals the plain weights bit for bit, at every K row
    of a 64-row scale block."""
    from nf4_tpu_torch.ops.dequant import _bf16_weight_t
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_kernel

    gen = torch.Generator(device=dev).manual_seed(11)
    pw = _packed(gen, 640, 3072, dev, quant_type)
    wt = _bf16_weight_t(pw.packed, pw.scales, quant_type).float()
    for k0 in range(0, 64, 16):
        rows = torch.arange(16, device=dev) + k0 + 64 * 5
        x = torch.zeros((16, 3072), device=dev, dtype=torch.bfloat16)
        x[torch.arange(16, device=dev), rows] = 1.0
        got = _matmul_bf16_kernel(x, pw.packed, pw.scales, torch.float32, quant_type)
        torch.cuda.synchronize()
        assert torch.equal(got, wt[rows])


def test_matmul_decode_deterministic(dev):
    """Two launches of kernel B's decode kernel, K split across blocks, give
    the same bits (the splits are summed in split order)."""
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_kernel

    gen = torch.Generator(device=dev).manual_seed(12)
    x, pw = _decode_case(gen, dev, 1536, 14336)
    a = _matmul_bf16_kernel(x, pw.packed, pw.scales, torch.float32)
    b = _matmul_bf16_kernel(x, pw.packed, pw.scales, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_matmul_decode_split_needs_counters(dev):
    """The decode kernel sums its K splits itself: a split launch without
    the tile counters is refused, and so counted as no launch."""
    from nf4_tpu_torch.ops.lut_eval import byte_word_table
    from nf4_tpu_torch.ops.matmul import _KERNEL, _launch

    gen = torch.Generator(device=dev).manual_seed(14)
    x, pw = _decode_case(gen, dev, 1536, 4096)
    table = byte_word_table("nf4", dev)
    before = _KERNEL.launches
    with pytest.raises(RuntimeError, match=r"error 1$"):
        _launch(_KERNEL, x, pw.packed, pw.scales, torch.float32, 16, table.data_ptr(), None, ksplit=4)
    assert _KERNEL.launches == before


def test_matmul_decode_in_cuda_graph(dev):
    """Three decode launches (two with K split across blocks) captured in one
    CUDA graph and replayed twice equal the eager launches: every launch
    leaves the tile counters at zero."""
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_kernel

    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(_decode_case(gen, dev, m, n), od) for m, n, od in
             ((1536, 4096, torch.bfloat16), (28672, 4096, torch.float32), (4096, 14336, torch.float16))]
    calls = [lambda x=x, pw=pw, od=od: _matmul_bf16_kernel(x, pw.packed, pw.scales, od) for (x, pw), od in cases]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, want in zip(outs, eager):
            assert torch.equal(o, want)


@pytest.mark.parametrize("b", [65, 300, 700, 1024])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("m", [640, 1024])
def test_matmul_prefill_kernel_close(dev, b, out_dtype, quant_type, m):
    """Kernel B's prefill kernel (wgmma) in the layout ``_prefill_rows``
    picks: 128 x 256 blocks (m 1024 at b_pad 128) or 256 x 128 (m 640;
    b_pad 320 and 704 with a ragged last tile; 1024), K split or not."""
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_kernel, _matmul_bf16_plain, _pick_bm

    gen = torch.Generator(device=dev).manual_seed(8)
    pw = _packed(gen, m, 3072, dev, quant_type)
    b_pad = -(-b // _pick_bm(b)) * _pick_bm(b)
    x = torch.zeros((b_pad, 3072), device=dev, dtype=torch.bfloat16)
    x[:b] = torch.randn((b, 3072), generator=gen, device=dev).to(torch.bfloat16)
    got = _matmul_bf16_kernel(x, pw.packed, pw.scales, out_dtype, quant_type)
    want = _matmul_bf16_plain(x, pw.packed, pw.scales, out_dtype, quant_type).float()
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (b_pad, pw.padded_shape[0])
    assert ((got.float() - want).abs().max() / want.abs().max()).item() < 2e-2


@pytest.mark.parametrize("b", [64, 300, 700, 1024])
@pytest.mark.parametrize("rows", [128, 256])
def test_matmul_prefill_layouts_close(dev, b, rows):
    """Both prefill layouts, forced, at every serving row count, whichever
    ``_prefill_rows`` would pick."""
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_kernel, _matmul_bf16_plain

    gen = torch.Generator(device=dev).manual_seed(9)
    pw = _packed(gen, 1024, 3072, dev)
    b_pad = -(-b // 64) * 64
    x = torch.zeros((b_pad, 3072), device=dev, dtype=torch.bfloat16)
    x[:b] = torch.randn((b, 3072), generator=gen, device=dev).to(torch.bfloat16)
    got = _matmul_bf16_kernel(x, pw.packed, pw.scales, torch.bfloat16, rows=rows).float()
    want = _matmul_bf16_plain(x, pw.packed, pw.scales, torch.bfloat16).float()
    torch.cuda.synchronize()
    assert ((got - want).abs().max() / want.abs().max()).item() < 2e-2


def _flash_inputs(gen, dev, b, g, kv, s, t, d, int8):
    q = torch.randn((b, kv * g, s, d), generator=gen, device=dev).to(torch.bfloat16)
    if not int8:
        k = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
        return q, k, v, ()
    k = torch.randint(-127, 128, (b, kv, t, d), generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (b, kv, t, d), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((b, kv, t), generator=gen, device=dev) * 3 + 0.5
    vs = torch.rand((b, kv, t), generator=gen, device=dev) * 3 + 0.5
    return q, k, v, (ks, vs)


@pytest.mark.parametrize("window,pos0", [(None, 0), (None, 37), (100, 37)])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_flash_kernel_ragged_close(dev, window, pos0, g, d, int8):
    """Kernel C at S = 700 (not a multiple of a query or key tile), at and
    off position 0, with a window whose edge falls inside a key tile."""
    from nf4_tpu_torch.ops.attention import _flash_kernel, _flash_plain

    gen = torch.Generator(device=dev).manual_seed(9)
    b, kv, s, t = 2, 2, 700, 1024
    q, k, v, sc = _flash_inputs(gen, dev, b, g, kv, s, t, d, int8)
    pos = torch.full((b,), pos0, device=dev, dtype=torch.int32)
    lens = torch.tensor([pos0 + s, pos0 + s - 50], device=dev, dtype=torch.int32)
    got = _flash_kernel(q, k, v, pos, lens, d**-0.5, window, *sc).float()
    want = _flash_plain(q, k, v, pos, lens, d**-0.5, window, *sc).float()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[1, :, : s - 50].cpu().numpy(), want[1, :, : s - 50].cpu().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("window,pos0,g", [(None, 0, 4), (96, 300, 4), (None, 17, 1), (None, 0, 8)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_close(dev, window, pos0, g, d):
    from nf4_tpu_torch.ops.attention import _flash_kernel, _flash_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    b, kv, s, t = 2, 2, 300, 700
    q = torch.randn((b, kv * g, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.full((b,), pos0, device=dev, dtype=torch.int32)
    lens = torch.tensor([pos0 + s, pos0 + s - 50], device=dev, dtype=torch.int32)
    got = _flash_kernel(q, k, v, pos, lens, d**-0.5, window).float()
    want = _flash_plain(q, k, v, pos, lens, d**-0.5, window).float()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[1, :, : s - 50].cpu().numpy(), want[1, :, : s - 50].cpu().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_fast_dequant_kernel_bit_exact(dev, quant_type):
    from nf4_tpu_torch.ops.dequant import _bf16_weight_t, _dequant_t_fast_kernel

    gen = torch.Generator(device=dev).manual_seed(3)
    pw = _packed(gen, 384, 2048, dev)
    got = _dequant_t_fast_kernel(pw.packed, pw.scales, quant_type)
    want = _bf16_weight_t(pw.packed, pw.scales, quant_type)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16), want.view(torch.int16))


# (rows, layout): every row count in the layout ``_prefill_rows`` picks (the
# decode kernel up to 16 rows), then each prefill layout forced.
_INT8_CASES = [(b, None) for b in (1, 4, 37, 64, 200, 320, 704)] + [
    (b, rows) for b in (64, 320, 704) for rows in (128, 256)
]


@pytest.mark.parametrize("b,rows", _INT8_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_int8_matmul_kernel_close(dev, b, rows, out_dtype):
    """Kernel D's decode kernel (b_pad 16) and its prefill kernel (b_pad 64,
    256, 320, 704: 128 x 256 blocks, 256 x 128 with a ragged last tile) in
    the layout ``_prefill_rows`` picks (``rows`` None) and in each layout
    forced; m 1024 allows both."""
    from nf4_tpu_torch.ops.int8_serve import _int8_matmul_kernel, _int8_matmul_plain, recode_int8_weight
    from nf4_tpu_torch.ops.matmul import _pick_bm

    gen = torch.Generator(device=dev).manual_seed(4)
    p8 = recode_int8_weight(_packed(gen, 1024 if rows else 640, 3072, dev))
    b_pad = -(-b // _pick_bm(b)) * _pick_bm(b)
    x = torch.zeros((b_pad, 3072), device=dev, dtype=torch.bfloat16)
    x[:b] = torch.randn((b, 3072), generator=gen, device=dev).to(torch.bfloat16)
    got = _int8_matmul_kernel(x, p8.values, p8.scales, out_dtype, rows=rows)
    want = _int8_matmul_plain(x, p8.values, p8.scales, out_dtype).float()
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (b_pad, p8.padded_shape[0])
    assert ((got.float() - want).abs().max() / want.abs().max()).item() < 2e-2


def test_int8_matmul_prefill_weight_values(dev):
    """Kernel D's prefill decode gives _int8_weight_t's values bit for bit:
    x = one-hot rows picks single K rows of W^T, so each output is one
    weight value times 1 (exact in the fp32 sum), for every int8 value."""
    from nf4_tpu_torch.ops.int8_serve import _int8_matmul_kernel, _int8_weight_t

    gen = torch.Generator(device=dev).manual_seed(10)
    values = torch.arange(-128, 128, device=dev, dtype=torch.int32).repeat(256 * 128 // 256).reshape(256, 128)
    values = values[torch.randperm(256, generator=gen, device=dev)].to(torch.int8).contiguous()
    scales = torch.rand((4, 128), generator=gen, device=dev) * 0.02
    x = torch.eye(256, device=dev, dtype=torch.bfloat16)
    got = _int8_matmul_kernel(x, values, scales, torch.float32)
    want = _int8_weight_t(values, scales).float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _int8_decode_case(gen, dev, m, n, b=4):
    from nf4_tpu_torch.ops.int8_serve import recode_int8_weight

    x, pw = _decode_case(gen, dev, m, n, b)
    return x, recode_int8_weight(pw)


def test_int8_matmul_decode_weight_values(dev):
    """One-hot rows of x read single K rows of W^T through kernel D's decode
    kernel: fp32 out equals the plain weights bit for bit, at every K row
    of a 64-row scale block, for every int8 value."""
    from nf4_tpu_torch.ops.int8_serve import _int8_matmul_kernel, _int8_weight_t

    gen = torch.Generator(device=dev).manual_seed(15)
    values = torch.randint(-128, 128, (3072, 640), generator=gen, device=dev, dtype=torch.int8)
    scales = torch.rand((48, 640), generator=gen, device=dev) * 0.02
    wt = _int8_weight_t(values, scales).float()
    for k0 in range(0, 64, 16):
        rows = torch.arange(16, device=dev) + k0 + 64 * 5
        x = torch.zeros((16, 3072), device=dev, dtype=torch.bfloat16)
        x[torch.arange(16, device=dev), rows] = 1.0
        got = _int8_matmul_kernel(x, values, scales, torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, wt[rows])


def test_int8_matmul_decode_deterministic(dev):
    """Two launches of kernel D's decode kernel, K split across blocks, give
    the same bits (the splits are summed in split order)."""
    from nf4_tpu_torch.ops.int8_serve import _int8_matmul_kernel

    gen = torch.Generator(device=dev).manual_seed(16)
    x, p8 = _int8_decode_case(gen, dev, 1536, 14336)
    a = _int8_matmul_kernel(x, p8.values, p8.scales, torch.float32)
    b = _int8_matmul_kernel(x, p8.values, p8.scales, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_int8_matmul_decode_split_needs_counters(dev):
    """Kernel D's decode kernel sums its K splits itself: a split launch
    without the tile counters is refused, and so counted as no launch."""
    from nf4_tpu_torch.ops.int8_serve import _KERNEL, _launch_d

    gen = torch.Generator(device=dev).manual_seed(17)
    x, p8 = _int8_decode_case(gen, dev, 1536, 4096)
    before = _KERNEL.launches
    with pytest.raises(RuntimeError, match=r"error 1$"):
        _launch_d(x, p8.values, p8.scales, torch.float32, 16, None, 4)
    assert _KERNEL.launches == before


def test_int8_matmul_decode_in_cuda_graph(dev):
    """Three decode launches of kernel D (two with K split across blocks)
    captured in one CUDA graph and replayed twice equal the eager launches:
    every launch leaves the tile counters at zero."""
    from nf4_tpu_torch.ops.int8_serve import _int8_matmul_kernel

    gen = torch.Generator(device=dev).manual_seed(18)
    cases = [(_int8_decode_case(gen, dev, m, n), od) for m, n, od in
             ((1536, 4096, torch.bfloat16), (28672, 4096, torch.float32), (4096, 14336, torch.float16))]
    calls = [lambda x=x, p8=p8, od=od: _int8_matmul_kernel(x, p8.values, p8.scales, od) for (x, p8), od in cases]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, want in zip(outs, eager):
            assert torch.equal(o, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kv_on_card_bit_identical(dev, dtype):
    """The int8 KV cache's quantizer gives the CPU's values and scales on
    the card, zero rows included (its division's dividend is a CPU scalar)."""
    from nf4_tpu_torch.models.llama import _quantize_kv

    gen = torch.Generator().manual_seed(12)
    t = (torch.randn((2, 1, 8, 300, 128), generator=gen) * torch.logspace(-20, 2, 300)[:, None]).to(dtype)
    t[0, 0, 0, :7] = 0
    want8, want_s = _quantize_kv(t)
    got8, got_s = _quantize_kv(t.to(dev))
    assert torch.equal(got8.cpu(), want8) and torch.equal(got_s.cpu().view(torch.int32), want_s.view(torch.int32))


@pytest.mark.parametrize("window,pos0,g", [(None, 0, 4), (96, 300, 4), (None, 17, 1)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_int8_kv_close(dev, window, pos0, g, d):
    from nf4_tpu_torch.ops.attention import _flash_kernel, _flash_plain

    gen = torch.Generator(device=dev).manual_seed(5)
    b, kv, s, t = 2, 2, 300, 700
    q = torch.randn((b, kv * g, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randint(-127, 128, (b, kv, t, d), generator=gen, device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (b, kv, t, d), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((b, kv, t), generator=gen, device=dev) * 3 + 0.5
    vs = torch.rand((b, kv, t), generator=gen, device=dev) * 3 + 0.5
    pos = torch.full((b,), pos0, device=dev, dtype=torch.int32)
    lens = torch.tensor([pos0 + s, pos0 + s - 50], device=dev, dtype=torch.int32)
    got = _flash_kernel(q, k, v, pos, lens, d**-0.5, window, ks, vs).float()
    want = _flash_plain(q, k, v, pos, lens, d**-0.5, window, ks, vs).float()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[1, :, : s - 50].cpu().numpy(), want[1, :, : s - 50].cpu().numpy(), rtol=2e-2, atol=2e-2)


# Kernel C's shapes beyond D in (64, 128) with 64 % G == 0: GQA groups with
# idle query rows (G = 3, 5, 7), more than one head group per position (G =
# 96), D = 256 (32-slot key tiles) and D = 384, 512 (the wide kernel).
_FLASH_SHAPES = [(3, 128), (7, 128), (5, 64), (96, 64), (1, 256), (2, 256), (7, 256), (1, 384), (3, 512)]


@pytest.mark.parametrize("window,pos0", [(None, 0), (None, 37), (100, 37)])
@pytest.mark.parametrize("g,d", _FLASH_SHAPES)
@pytest.mark.parametrize("int8", [False, True])
def test_flash_kernel_shapes_close(dev, window, pos0, g, d, int8):
    """As test_flash_kernel_ragged_close at every shape the TPU kernel
    takes: S = 700, at and off position 0, a window edge inside a key tile,
    a shorter second sequence."""
    from nf4_tpu_torch.ops.attention import _flash_kernel, _flash_plain

    gen = torch.Generator(device=dev).manual_seed(11)
    b, kv, s, t = 2, 2, 700, 1024
    q, k, v, sc = _flash_inputs(gen, dev, b, g, kv, s, t, d, int8)
    pos = torch.full((b,), pos0, device=dev, dtype=torch.int32)
    lens = torch.tensor([pos0 + s, pos0 + s - 50], device=dev, dtype=torch.int32)
    got = _flash_kernel(q, k, v, pos, lens, d**-0.5, window, *sc).float()
    want = _flash_plain(q, k, v, pos, lens, d**-0.5, window, *sc).float()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[1, :, : s - 50].cpu().numpy(), want[1, :, : s - 50].cpu().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("h,kv,d", [(28, 4, 128), (16, 16, 256), (96, 1, 64), (8, 8, 384)])
def test_flash_dispatch_takes_every_shape(dev, h, kv, d):
    """``attention`` sends a large prefill to kernel C at any G and at D = 64
    or a multiple of 128: one launch, the plain version's result."""
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.ops.attention import _flash_plain, attention

    gen = torch.Generator(device=dev).manual_seed(12)
    s, t = 512, (1 << 27) // (h * 512) + 64
    q, k, v, _ = _flash_inputs(gen, dev, 1, h // kv, kv, s, t, d, False)
    positions = torch.arange(s, device=dev, dtype=torch.int32)[None]
    lens = torch.full((1,), s, device=dev, dtype=torch.int32)
    _cuda.reset_launch_counts()
    got = attention(q, k, v, positions, lens, scale=d**-0.5).float()
    assert _cuda.launch_counts()["flash_attention"] == 1
    want = _flash_plain(q, k, v, positions[:, 0], lens, d**-0.5).float()
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-2, atol=2e-2)


_EXACT_LIMIT = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 8e-3}


@pytest.mark.parametrize("b", [1, 4, 8, 9, 16, 37, 64, 200, 320, 704])
@pytest.mark.parametrize(
    "xdt,out_dtype",
    [(torch.float32, torch.float32), (torch.float32, torch.bfloat16), (torch.float16, torch.float16),
     (torch.float16, torch.float32)],
)
def test_exact_matmul_kernel_close(dev, b, xdt, out_dtype):
    """Kernel E's decode kernel (b_pad 16: rows 8-15 zero up to b = 8) and
    its 3xTF32 prefill kernel (b_pad 64, 256, 320, 704: 128-row blocks, a
    ragged last tile at 320 and 704), fp32 and fp16 x."""
    from nf4_tpu_torch.ops.matmul import _matmul_exact_kernel, _matmul_exact_plain, _pick_bm

    gen = torch.Generator(device=dev).manual_seed(6)
    pw = _packed(gen, 640, 3072, dev)
    b_pad = -(-b // _pick_bm(b)) * _pick_bm(b)
    x = torch.zeros((b_pad, 3072), device=dev, dtype=xdt)
    x[:b] = torch.randn((b, 3072), generator=gen, device=dev).to(xdt)
    got = _matmul_exact_kernel(x, pw.packed, pw.scales, out_dtype)
    want = _matmul_exact_plain(x, pw.packed, pw.scales, out_dtype).float()
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (b_pad, pw.padded_shape[0])
    err = (got.float() - want).abs().max().item()
    assert err <= _EXACT_LIMIT[out_dtype] * want.abs().max().item()


def test_exact_matmul_prefill_weight_values(dev):
    """Kernel E's prefill decode and split: x = one-hot fp16 rows (exact in
    tf32, so two products) picks single K rows of W^T, and w_hi + w_lo
    recovers each fp32 weight value to within 2^-21 of it."""
    from nf4_tpu_torch.ops.dequant import _dequant_t_plain
    from nf4_tpu_torch.ops.matmul import _matmul_exact_kernel

    gen = torch.Generator(device=dev).manual_seed(11)
    pw = _packed(gen, 256, 1024, dev)
    x = torch.eye(1024, device=dev, dtype=torch.float16)
    got = _matmul_exact_kernel(x, pw.packed, pw.scales, torch.float32)
    want = _dequant_t_plain(pw.packed, pw.scales, torch.float32)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= want.abs() * 2.0**-21).all()


def _tf32_sum(w):
    """w_hi + w_lo of fp32 values as kernel E's decode kernel splits its
    weights and the tensor cores read them: hi = w with its 13 low bits
    cleared, lo = w - hi with its 13 low bits dropped."""
    hi = (w.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi + ((w - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("xdt", [torch.float16, torch.float32])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_exact_matmul_decode_weight_values(dev, xdt, quant_type):
    """One-hot rows of x read single K rows of W^T through kernel E's decode
    kernel, at every K row of a 64-row scale block: fp32 out is w_hi + w_lo
    of ``_dequant_t_plain``'s values as the tensor cores read them, bit for
    bit (within 2^-21 of the values)."""
    from nf4_tpu_torch.ops.dequant import _dequant_t_plain
    from nf4_tpu_torch.ops.matmul import _matmul_exact_kernel

    gen = torch.Generator(device=dev).manual_seed(19)
    pw = _packed(gen, 640, 3072, dev, quant_type)
    wt = _dequant_t_plain(pw.packed, pw.scales, torch.float32, quant_type)
    want = _tf32_sum(wt)
    assert ((want - wt).abs() <= wt.abs() * 2.0**-21).all()
    for k0 in range(0, 64, 16):
        rows = torch.arange(16, device=dev) + k0 + 64 * 5
        x = torch.zeros((16, 3072), device=dev, dtype=xdt)
        x[torch.arange(16, device=dev), rows] = 1.0
        got = _matmul_exact_kernel(x, pw.packed, pw.scales, torch.float32, quant_type)
        torch.cuda.synchronize()
        assert torch.equal(got, want[rows])


def _exact_decode_case(gen, dev, m, n, b=4, xdt=torch.float32):
    pw = _packed(gen, m, n, dev)
    x = torch.zeros((16, pw.padded_shape[1]), device=dev, dtype=xdt)
    x[:b, :n] = torch.randn((b, n), generator=gen, device=dev).to(xdt)
    return x, pw


def test_exact_matmul_decode_deterministic(dev):
    """Two launches of kernel E's decode kernel, K split across blocks, give
    the same bits (the splits are summed in split order)."""
    from nf4_tpu_torch.ops.matmul import _matmul_exact_kernel

    gen = torch.Generator(device=dev).manual_seed(20)
    x, pw = _exact_decode_case(gen, dev, 1536, 14336)
    a = _matmul_exact_kernel(x, pw.packed, pw.scales, torch.float32)
    b = _matmul_exact_kernel(x, pw.packed, pw.scales, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_exact_matmul_decode_split_needs_counters(dev):
    """Kernel E's decode kernel sums its K splits itself: a split launch
    without the tile counters is refused, and so counted as no launch."""
    from nf4_tpu_torch.ops.lut_eval import code_tensor
    from nf4_tpu_torch.ops.matmul import _EXACT_KERNEL, _X_KIND, _launch

    gen = torch.Generator(device=dev).manual_seed(21)
    x, pw = _exact_decode_case(gen, dev, 1536, 4096)
    code = code_tensor("nf4", dev)
    before = _EXACT_KERNEL.launches
    with pytest.raises(RuntimeError, match=r"error 1$"):
        _launch(_EXACT_KERNEL, x, pw.packed, pw.scales, torch.float32, 16, code.data_ptr(), _X_KIND[x.dtype],
                None, None, ksplit=4)
    assert _EXACT_KERNEL.launches == before


def test_exact_matmul_decode_in_cuda_graph(dev):
    """Three launches of kernel E's decode kernel (two with K split across
    blocks; fp32 and fp16 x) captured in one CUDA graph and replayed twice
    equal the eager launches: every launch leaves the tile counters at
    zero."""
    from nf4_tpu_torch.ops.matmul import _matmul_exact_kernel

    gen = torch.Generator(device=dev).manual_seed(22)
    cases = [(_exact_decode_case(gen, dev, m, n, xdt=xdt), od) for m, n, xdt, od in
             ((1536, 4096, torch.float32, torch.bfloat16), (28672, 4096, torch.float16, torch.float32),
              (4096, 14336, torch.float32, torch.float16))]
    calls = [lambda x=x, pw=pw, od=od: _matmul_exact_kernel(x, pw.packed, pw.scales, od) for (x, pw), od in cases]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, want in zip(outs, eager):
            assert torch.equal(o, want)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_matmul_backward_on_card(dev, precision, xdt):
    """``dx = g @ W`` through kernel A and a true fp32 product, even under
    "high" (TF32); the forward of fp32 x launches kernel E, of bf16 x B."""
    import nf4_tpu_torch
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.ops.dequant import _dequant_t_plain

    gen = torch.Generator(device=dev).manual_seed(7)
    pw = _packed(gen, 640, 3072, dev)
    x = torch.randn((37, 3072), generator=gen, device=dev).to(xdt).requires_grad_()
    g = torch.randn((37, 640), generator=gen, device=dev)
    want = (g @ _dequant_t_plain(pw.packed, pw.scales, torch.float32).T).to(xdt).float()
    prev = torch.get_float32_matmul_precision()
    _cuda.reset_launch_counts()
    torch.set_float32_matmul_precision(precision)
    try:
        y = nf4_tpu_torch.nf4_matmul(x, pw)
        (dx,) = torch.autograd.grad(y, x, g.to(y.dtype))
    finally:
        torch.set_float32_matmul_precision(prev)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    fwd = "matmul_exact" if xdt == torch.float32 else "matmul_bf16"
    assert counts[fwd] == 1 and counts["dequant_t"] == 1, counts
    assert dx.dtype == xdt
    limit = (1e-5 if xdt == torch.float32 else 8e-3) * want.abs().max().item()
    assert (dx.float() - want).abs().max().item() <= limit


# -- the Engine's decode chunks on CUDA graphs --------------------------------

def _small_model(dev, int8, **fields):
    """A 2-layer model at narrow widths (synthetic packed weights), in the
    4-bit mode or the int8/kv8 mode, with further config ``fields``."""
    from nf4_tpu_torch.models.llama import LlamaConfig, recode_params_int8
    from nf4_tpu_torch.models.synthetic import synthetic_params

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=128, max_seq_len=256, kv_quant=int8, **fields)
    params = synthetic_params(cfg, seed=3, device=dev)
    return cfg, recode_params_int8(params) if int8 else params


def _decode_state(eng, cfg, seed=4):
    """A cache with 4 prompts prefilled, and the host inputs of the chunk
    that follows: tokens, positions, active (slot 3 idle)."""
    from nf4_tpu_torch.models.llama import init_kv_cache

    rng = np.random.default_rng(seed)
    lens = np.asarray([37, 90, 5, 64], np.int32)
    toks = np.zeros((4, 128), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    cache = init_kv_cache(cfg, 4)
    logits = eng.prefill_group(cache, toks, lens, np.arange(4))
    first = logits.argmax(-1).to(torch.int32).cpu().numpy()
    return cache, first, lens.astype(np.int64), np.asarray([True, True, True, False])


def _clone_cache(cache):
    from nf4_tpu_torch.models.llama import KVCache

    return KVCache(**{name: t.clone() for name, t in cache.planes().items()})


@pytest.mark.parametrize("int8", [False, True])
def test_graphed_chunk_bit_identical_to_eager(dev, int8):
    """A decode chunk captured as a CUDA graph and replayed gives the eager
    chunk's logits, tokens, advanced inputs and cache writes bit for bit at
    the same kv bucket; the next chunk, launched from the device outputs,
    too (the Decoder's own graph)."""
    _check_graphed_chunk(dev, *_small_model(dev, int8))


# Every field of the Llama-family variants on, two RoPE scalings: none
# reads the host, so the decode chunk captures.
_VARIANT_FIELDS = {
    "longrope": dict(attn_bias=True, qk_norm=True, activation="gelu_tanh", rmsnorm_one_plus=True,
                     scale_embeddings=True, rope_scaling=("longrope", (1.0,) * 64, (2.0,) * 64, 64)),
    "llama3": dict(attn_bias=True, qk_norm=True, activation="gelu", sliding_window=48,
                   rope_scaling=("llama3", 8.0, 1.0, 4.0, 64)),
}


@pytest.mark.parametrize("variant", list(_VARIANT_FIELDS))
def test_graphed_chunk_with_variant_fields(dev, variant):
    _check_graphed_chunk(dev, *_small_model(dev, False, **_VARIANT_FIELDS[variant]))


# Gemma-2 (softcaps, output norms, a window on every other layer), Gemma-3
# (local RoPE, q/k norms, windows) and MoE (4 experts, top-2; int8 too):
# each layer's window, softcap and tables are host values baked into the
# graph, and no route reads the host.
_GEMMA_MOE_FIELDS = {
    "gemma2": (False, dict(activation="gelu_tanh", rmsnorm_one_plus=True, scale_embeddings=True,
                           attn_logit_softcapping=50.0, final_logit_softcapping=30.0, query_pre_attn_scalar=128.0,
                           sliding_window=48, sliding_window_pattern=2)),
    "gemma3": (False, dict(activation="gelu_tanh", rmsnorm_one_plus=True, qk_norm=True, rope_theta=1e6,
                           rope_local_theta=1e4, rope_scaling=("linear", 8.0), sliding_window=48,
                           sliding_window_pattern=2)),
    "moe": (False, dict(num_experts=4, experts_per_token=2)),
    "moe int8": (True, dict(num_experts=4, experts_per_token=2, moe_norm_topk=False)),
}


@pytest.mark.parametrize("variant", list(_GEMMA_MOE_FIELDS))
def test_graphed_chunk_gemma_and_moe(dev, variant):
    int8, fields = _GEMMA_MOE_FIELDS[variant]
    _check_graphed_chunk(dev, *_small_model(dev, int8, **fields))


@pytest.mark.parametrize("int8", [False, True])
def test_moe_launch_counts(dev, int8):
    """An MoE forward launches one projection kernel for wqkv, one for wo
    and two per expert in every layer (2 + 2 E), at decode (16-row decode
    kernel) and at prefill (200 rows: the prefill kernel), eagerly and in a
    graph replay; the experts' weights are views of one stacked tensor."""
    from nf4_tpu_torch.models.llama import _experts, decode_step, init_kv_cache, prefill
    from nf4_tpu_torch.ops import _cuda

    cfg, params = _small_model(dev, int8, num_experts=4, experts_per_token=2)
    name, other = ("int8_matmul", "matmul_bf16") if int8 else ("matmul_bf16", "int8_matmul")
    per_forward = cfg.num_layers * (2 + 2 * cfg.num_experts)
    w = params.layers[0].w_gateup
    stacked = w.values if int8 else w.packed
    views = [e.values if int8 else e.packed for e in _experts(w)]
    assert all(v.data_ptr() == stacked[i].data_ptr() for i, v in enumerate(views))
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 200)), dtype=torch.int32,
                           device=dev)
    _cuda.reset_launch_counts()
    _, cache = prefill(params, cfg, toks, init_kv_cache(cfg, 1))
    torch.cuda.synchronize()
    assert _cuda.launch_counts()[name] == per_forward and _cuda.launch_counts()[other] == 0
    tok, pos = toks[:, -1].clone(), torch.full((1,), 200, dtype=torch.int32, device=dev)
    decode_step(params, cfg, tok, cache, pos, kv_len=cfg.max_seq_len)
    g = _cuda.CountedGraph()
    with g.capture():
        decode_step(params, cfg, tok, cache, pos, kv_len=cfg.max_seq_len)
    _cuda.reset_launch_counts()
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    assert _cuda.launch_counts()[name] == 2 * per_forward


def _check_graphed_chunk(dev, cfg, params):
    from nf4_tpu_torch.ops._cuda import CountedGraph
    from nf4_tpu_torch.serve.engine import Decoder, Engine, kv_bucket

    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8)
    plain = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, cuda_graphs=False)
    cache, tok, pos, act = _decode_state(eng, cfg)
    graphed, eager = Decoder(eng, cache), Decoder(plain, _clone_cache(cache))
    steps = np.zeros(4, np.int32)
    host = torch.from_numpy(np.stack([tok, pos.astype(np.int32), act.astype(np.int32), steps])).to(dev)
    kv = kv_bucket(int(pos[act].max()) + 8, eng.KV_BUCKET, cfg.max_seq_len)
    eager.inputs.copy_(host)
    want = eager.run_eager(8, kv)
    graph = CountedGraph()
    with graph.capture(pool=graphed.pool, stream=eng.graph_stream):
        logits = graphed.run_eager(8, kv)
    graphed.inputs.copy_(host)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(logits, want)
    assert torch.equal(graphed.toks, eager.toks) and torch.equal(graphed.inputs, eager.inputs)
    for name, t in graphed.cache.planes().items():
        assert torch.equal(t, eager.cache.planes()[name]), name
    kv = kv_bucket(int(pos[act].max()) + 16, eng.KV_BUCKET, cfg.max_seq_len)
    a, b = graphed.read(graphed.launch(8, kv)), eager.read(eager.launch(8, kv))
    assert np.array_equal(a, b) and list(graphed.graphs) == [(kv, 8, None)] and not eager.graphs
    assert eng.graph_stats["captured"] == 1 and eng.graph_stats["replayed"] == 1


# The per-request chunk bodies: top logprobs, the emitted-token state and
# the bias rows in each combination the Engine captures.
_SAMPLED_KINDS = {"plain": (0, None, False), "counts_bias_top5": (5, "counts", True), "bool_top3": (3, "bool", False)}


@pytest.mark.parametrize("kind", list(_SAMPLED_KINDS))
def test_graphed_sampled_chunk_bit_identical_to_eager(dev, kind):
    """A per-request chunk (greedy, unseeded and seeded stochastic rows,
    penalties, bias rows, an idle slot) captured as a CUDA graph and
    replayed gives the eager chunk's tokens, logprobs, top logprobs,
    emitted-token state, advanced inputs and cache writes bit for bit; so
    does the next chunk, launched from the device outputs."""
    from nf4_tpu_torch.serve.engine import ChunkKind, Decoder, Engine, kv_bucket
    from nf4_tpu_torch.serve.sampling import SamplingParams

    kind = ChunkKind(*_SAMPLED_KINDS[kind])
    cfg, params = _small_model(dev, False)
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8)
    plain = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, cuda_graphs=False)
    cache, tok, pos, act = _decode_state(eng, cfg)
    graphed, eager = Decoder(eng, cache), Decoder(plain, _clone_cache(cache))
    sps = [SamplingParams(),
           SamplingParams(temperature=0.9, top_k=40, top_p=0.9, repetition_penalty=1.3, presence_penalty=0.4),
           SamplingParams(temperature=1.1, min_p=0.05, frequency_penalty=0.3, seed=11),
           SamplingParams(temperature=0.7)]
    rng = np.random.default_rng(8)
    rows = (rng.standard_normal((4, cfg.vocab_size)) * 2).astype(np.float32)
    first = torch.as_tensor(tok, device=dev)
    for dec in (graphed, eager):
        dec.prepare(kind)
        dec.set_sampling(sps)
        if kind.mask is not None:
            dec.reset_mask(kind.mask, np.arange(4), first)
        if kind.bias:
            dec.set_bias(np.arange(4), rows)
    steps = np.asarray([1, 7, 3, 0])
    kv = kv_bucket(int(pos[act].max()) + 8, eng.KV_BUCKET, cfg.max_seq_len)
    outs = []
    for dec in (graphed, eager):
        h = dec.launch(8, kv, tok, pos, act, steps=steps, kind=kind)
        outs.append(dec.read_all(h))
    kv = kv_bucket(int(pos[act].max()) + 16, eng.KV_BUCKET, cfg.max_seq_len)
    for dec in (graphed, eager):
        outs.append(dec.read_all(dec.launch(8, kv, kind=kind)))
    torch.cuda.synchronize()
    for a, b in ((outs[0], outs[1]), (outs[2], outs[3])):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert (a[2] is None) == (b[2] is None) and (a[2] is None or all(map(np.array_equal, a[2], b[2])))
    assert torch.equal(graphed.inputs, eager.inputs) and torch.equal(eng.keys.counter, plain.keys.counter)
    for name in graphed.masks:
        assert torch.equal(graphed.masks[name], eager.masks[name]), name
    for name, t in graphed.cache.planes().items():
        assert torch.equal(t, eager.cache.planes()[name]), name
    assert list(graphed.graphs) == [(kv, 8, kind)] and eng.graph_stats["replayed"] == 2 and not eager.graphs
    assert not (outs[0][0][:, 3] != tok[3]).any()  # the idle slot keeps its token


def test_second_generate_captures_nothing(dev):
    """A second generate of the same sampled requests on one Engine captures
    no graph and replays every chunk; graphed and pipelined, both calls
    give the tokens, logprobs and top logprobs of an eager Engine's (greedy,
    seeded and unseeded rows alike: the key streams advance alike)."""
    from nf4_tpu_torch.serve.engine import Engine
    from nf4_tpu_torch.serve.sampling import SamplingParams

    cfg, params = _small_model(dev, False)
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in (30, 70, 9, 50, 12)]
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_p=0.9, seed=5, top_logprobs=2),
           SamplingParams(temperature=1.0, top_k=20, presence_penalty=0.5), SamplingParams(repetition_penalty=1.3),
           SamplingParams(temperature=0.6, logit_bias=((7, -100.0),))]
    common = dict(batch_size=4, eos_token=-1, decode_chunk=8)
    eng = Engine(params, cfg, **common)
    plain = Engine(params, cfg, cuda_graphs=False, **common)
    kw = dict(max_new_tokens=40, sampling=sps, return_logprobs=True)
    first = eng.generate(prompts, **kw)
    captured, replayed = eng.graph_stats["captured"], eng.graph_stats["replayed"]
    second = eng.generate(prompts, **kw)
    assert captured > 0 and eng.graph_stats["captured"] == captured and eng.graph_stats["replayed"] > replayed
    for got in (first, second):
        want = plain.generate(prompts, **kw)
        for g, w in zip(got, want):
            assert g.tokens == w.tokens and g.logprobs == w.logprobs and g.top_logprobs == w.top_logprobs
    assert second[1].tokens == first[1].tokens and second[3].tokens == first[3].tokens  # seeded, greedy


@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_independent_of_kv_len(dev, int8):
    """Decode attention at Llama-3-8B's head shapes (B 4, H 32, KV 8, D 128,
    T 2048): each row's output is the same bits at every kv_len past its
    position (512 to 2048, one key block to four), and within 2e-2 of the
    plain naive attention over the whole cache."""
    from nf4_tpu_torch.ops.attention import decode_attention, naive_attention

    gen = torch.Generator(device=dev).manual_seed(21)
    b, h, kv, t, d = 4, 32, 8, 2048, 128
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (b, kv, t, d), generator=gen, device=dev, dtype=torch.int8) for _ in "kv")
        scales = dict(k_scale=torch.rand((b, kv, t), generator=gen, device=dev) * 0.05,
                      v_scale=torch.rand((b, kv, t), generator=gen, device=dev) * 0.05)
    else:
        k, v = (torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16) for _ in "kv")
        scales = {}
    pos = torch.tensor([[100], [500], [900], [1500]], device=dev, dtype=torch.int32)
    lens = pos[:, 0] + 1
    outs = {n: decode_attention(q, k, v, pos, lens, scale=d**-0.5, kv_len=n, **scales).float().cpu()
            for n in (512, 1024, 1536, 2048)}
    for r, p in enumerate((100, 500, 900, 1500)):
        for n, out in outs.items():
            if n > p:
                assert torch.equal(out[r], outs[2048][r]), (r, n)
    want = naive_attention(q, k, v, pos, lens, scale=d**-0.5, **scales).float().cpu()
    np.testing.assert_allclose(outs[2048].numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("mate_len, kv", [(1100, 1536), (1600, 2048)])
def test_seeded_request_independent_of_batchmates(dev, monkeypatch, mate_len, kv):
    """A seeded request decoding from position 900 reads kv_len 1024 alone;
    a batchmate with a longer prompt raises every chunk's kv_len to 1536
    or 2048, where a softmax over the whole row takes another reduction
    (plain naive attention's row at 900 changes its bits there).  The
    seeded request's tokens and logprobs stay the same bits as alone,
    graphed at decode_chunk 8 pipelined and 4 not."""
    from nf4_tpu_torch.serve.engine import Decoder, Engine
    from nf4_tpu_torch.serve.sampling import SamplingParams

    from nf4_tpu_torch.models.llama import LlamaConfig
    from nf4_tpu_torch.models.synthetic import synthetic_params

    # Llama-3-8B's heads (32 query, 8 KV, D 128) on a narrow 2-layer model.
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=32,
                      num_kv_heads=8, head_dim=128, max_seq_len=2048)
    params = synthetic_params(cfg, seed=3, device=dev)
    seen = []
    launch = Decoder.launch

    def spy(self, n, kv_len, *a, **kw):
        seen.append(kv_len)
        return launch(self, n, kv_len, *a, **kw)

    monkeypatch.setattr(Decoder, "launch", spy)
    rng = np.random.default_rng(11)
    mine = [int(t) for t in rng.integers(0, cfg.vocab_size, 900)]
    mate = [int(t) for t in rng.integers(0, cfg.vocab_size, mate_len)]
    seeded = SamplingParams(temperature=1.2, top_p=0.95, seed=123)

    def run(prompts, chunk, pipelined):
        seen.clear()
        eng = Engine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=chunk, pipeline_decode=pipelined)
        sps = [seeded, SamplingParams(temperature=0.7)][: len(prompts)]
        res = eng.generate(prompts, max_new_tokens=24, sampling=sps, return_logprobs=True)[0]
        assert eng.graph_stats["replayed"] > 0
        return res, max(seen)

    alone, kv_alone = run([mine], 8, True)
    assert kv_alone == 1024
    for chunk, pipelined in ((8, True), (4, False)):
        beside, kv_beside = run([mine, mate], chunk, pipelined)
        assert kv_beside == kv
        assert beside.tokens == alone.tokens and beside.logprobs == alone.logprobs


def test_prefill_group_first_logits(dev):
    """A prompt's first logits against its prefill group's size (1, 2 or 4
    prompts of one bucket): the same bits at buckets 16, 64, 512 and 1024,
    on the 4-bit weights and in the int8 mode.  Kernels B's and D's
    prefill K split is a function of the weight (``ops/matmul.py``
    ``_prefill_ksplit``) and a prompt's rows take the prefill kernel at
    every count, so a row is summed in one order whatever shares its
    call."""
    import dataclasses

    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.serve.engine import Engine

    for int8 in (False, True):
        cfg, params = _small_model(dev, int8)
        cfg = dataclasses.replace(cfg, max_seq_len=1024)
        eng = Engine(params, cfg, batch_size=4, eos_token=-1, cuda_graphs=False)
        rng = np.random.default_rng(0)
        for bucket in (16, 64, 512, 1024):
            toks = rng.integers(0, cfg.vocab_size, (4, bucket)).astype(np.int32)
            lens = np.full(4, bucket - 3, np.int32)
            first = {}
            for g in (1, 2, 4):
                cache = init_kv_cache(cfg, 4)
                first[g] = eng.prefill_group(cache, toks[:g], lens[:g], np.arange(g))[0].float().cpu()
            for g in (2, 4):
                assert torch.equal(first[g], first[1]), (int8, bucket, g)


# The model's computations, by the name the forward calls them through.
_WATCHED = ("rms_norm", "_matmul", "apply_rope", "_quantize_kv", "attention", "_gated", "lm_head")


def _first_group_difference(eng, toks, lens):
    """Prefill row 0 of ``toks`` alone and in a group of 2, recording row 0
    of the output of every ``_WATCHED`` call and kernel B's prefill K
    splits.  Returns the first recorded op whose bits differ between the
    two runs (index, name, max abs diff) or None, and the K splits of each
    run."""
    from nf4_tpu_torch.models import llama
    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.ops import matmul

    saved, saved_split = {name: getattr(llama, name) for name in _WATCHED}, matmul._prefill_ksplit
    runs = []
    for g in (1, 2):
        log, splits = [], []

        def wrap(name, fn):
            def inner(*a, **k):
                out = fn(*a, **k)
                first = out[0] if isinstance(out, tuple) else out
                log.append((f"{name} {list(first[0].shape)}", first[0].clone()))
                return out
            return inner

        def split(*a):
            splits.append(saved_split(*a))
            return splits[-1]

        for name, fn in saved.items():
            setattr(llama, name, wrap(name, fn))
        matmul._prefill_ksplit = split
        try:
            eng.prefill_group(init_kv_cache(eng.cfg, 2, device=eng.device), toks[:g], lens[:g], np.arange(g))
        finally:
            for name, fn in saved.items():
                setattr(llama, name, fn)
            matmul._prefill_ksplit = saved_split
        runs.append((log, splits))
    (one, s1), (two, s2) = runs
    assert [n for n, _ in one] == [n for n, _ in two]
    first = next(((i, n, (a.float() - b.float()).abs().max().item())
                  for i, ((n, a), (_, b)) in enumerate(zip(one, two)) if not torch.equal(a, b)), None)
    return first, s1, s2


@pytest.mark.parametrize("model", ["small", "llama3-8b-width"])
def test_prefill_group_difference_starts_at_kernel_b_ksplit(dev, model):
    """At bucket 512, no op of the forward differs in its bits between a
    group of 1 and a group of 2, and kernel B's prefill K splits are the
    same in both (``ops/matmul.py`` ``_prefill_ksplit`` depends on the
    weight only; it was sized from the group's row tiles, and the first
    difference was a projection).  Models: the test above's (its
    bucket-512 prompts) and Llama-3-8B at full width and 2 of its 32
    layers (synthetic weights)."""
    import dataclasses

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.serve.engine import Engine

    if model == "small":
        cfg, params = _small_model(dev, False)
        cfg = dataclasses.replace(cfg, max_seq_len=1024)
        rng = np.random.default_rng(0)
        toks = [rng.integers(0, cfg.vocab_size, (4, b)).astype(np.int32) for b in (16, 64, 512)][-1][:2]
    else:
        cfg = dataclasses.replace(configs.LLAMA3_8B, num_layers=2, max_seq_len=1024)
        params = synthetic_params(cfg, seed=0, device=dev)
        toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 512)).astype(np.int32)
    eng = Engine(params, cfg, batch_size=2, eos_token=-1, cuda_graphs=False)
    lens = np.full(2, 509, np.int32)
    first, s1, s2 = _first_group_difference(eng, toks, lens)
    print(f"{model}, bucket 512: first differing op {first}; kernel B prefill K splits, group of 1 {s1}, "
          f"group of 2 {s2}")
    assert first is None and s1 == s2 and s1, (first, s1, s2)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("case", ["wo", "w_down", "midpoints"])
def test_card_quantizer_equals_the_oracle(dev, quant_type, case):
    """The card quantizer (``quantize_for_tpu``'s default, ``nf4/fast_quant.py``)
    against the NumPy oracle on the host: the same packed bytes and scale
    bits, at Llama-3-8B's wo (4096 x 4096) and w_down (4096 x 14336) from
    bf16, and on the 4096 x 4096 midpoint stress tensor (normalized values
    on every decision midpoint and one ulp either side) from fp32."""
    from nf4_tpu_torch.nf4.fast_quant import midpoint_stress
    from nf4_tpu_torch.nf4.format import quantize_for_tpu

    if case == "midpoints":
        w = torch.from_numpy(midpoint_stress(4096, 4096, quant_type, seed=1))
    else:
        shape = (4096, 4096) if case == "wo" else (4096, 14336)
        w = torch.from_numpy((np.random.default_rng(2).standard_normal(shape) * 0.02).astype(np.float32))
        w = w.to(torch.bfloat16)
    got = quantize_for_tpu(w, quant_type=quant_type)
    want = quantize_for_tpu(w, method="oracle", quant_type=quant_type, device="cpu")
    assert got.packed.is_cuda and got.padded_shape == want.padded_shape
    assert torch.equal(got.packed.cpu(), want.packed)
    assert torch.equal(got.scales.cpu().view(torch.int32), want.scales.view(torch.int32))


def test_graph_replays_count_their_launches(dev):
    """``launch_counts()`` after a capture and k replays equals the counts
    of k eager chunks: the capture counts nothing, each replay counts what
    it captured."""
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import Decoder, Engine, kv_bucket

    cfg, params = _small_model(dev, False)
    counts = []
    for graphs in (False, True):
        eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, cuda_graphs=graphs)
        cache, tok, pos, act = _decode_state(eng, cfg)
        dec = Decoder(eng, cache)
        kv = kv_bucket(int(pos[act].max()) + 24, eng.KV_BUCKET, cfg.max_seq_len)
        _cuda.reset_launch_counts()
        handles = [dec.launch(8, kv, tok, pos, act)] + [dec.launch(8, kv) for _ in range(2)]
        [dec.read(h) for h in handles]
        counts.append(_cuda.launch_counts())
    assert counts[0] == counts[1], counts
    assert counts[1]["matmul_bf16"] == 3 * 8 * 4 * cfg.num_layers and eng.graph_stats["replayed"] == 3


def test_discarded_chunk_leaves_tokens_identical(dev):
    """A stop token inside a chunk drops the chunk launched ahead of it;
    graphed and pipelined, the tokens equal eager unpipelined decode's."""
    from nf4_tpu_torch.serve.engine import Engine

    cfg, params = _small_model(dev, False)
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in (30, 70)]
    common = dict(batch_size=2, eos_token=-1, decode_chunk=8)
    plain = Engine(params, cfg, pipeline_decode=False, cuda_graphs=False, **common)
    ref = plain.generate(prompts[:1], max_new_tokens=40)[0].tokens
    i = next(i for i in range(9, 30) if i % 8 and ref[i] not in ref[:i])
    pipe = Engine(params, cfg, **common)
    got = pipe.generate(prompts, max_new_tokens=40, stop_tokens=[ref[i]])
    want = plain.generate(prompts, max_new_tokens=40, stop_tokens=[ref[i]])
    assert [r.tokens for r in got] == [r.tokens for r in want] and got[0].tokens == ref[:i]
    assert pipe.pipeline_stats["discarded"] >= 1 and pipe.graph_stats["replayed"] > 0


# -- speculative chunks on CUDA graphs ------------------------------------------

# (drafted by a draft model, greedy accept rule) of each body the Engine captures.
_SPEC_KINDS = {"ngram-greedy": (False, True), "ngram-sampled": (False, False), "draft-greedy": (True, True),
               "draft-sampled": (True, False)}


def _spec_state(eng, cfg, dcfg):
    """Caches (the draft's too, when ``dcfg``) with 4 prompts prefilled, the
    prompts' contexts with their first tokens, and the next chunk's host
    inputs: tokens, positions (the idle slot 3 at 0), active."""
    from nf4_tpu_torch.models.llama import init_kv_cache

    rng = np.random.default_rng(4)
    lens = np.asarray([37, 90, 5, 64], np.int32)
    toks = np.zeros((4, 128), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 8, n)  # few distinct tokens: prompt lookup finds matches
    cache = init_kv_cache(cfg, 4)
    first = eng.prefill_group(cache, toks, lens, np.arange(4)).argmax(-1).to(torch.int32).cpu().numpy()
    dcache = None
    if dcfg is not None:
        dcache = init_kv_cache(dcfg, 4)
        eng.prefill_draft(dcache, toks, lens, np.arange(4))
    ctx = [list(toks[i, :n]) + [int(first[i])] for i, n in enumerate(lens)]
    act = np.asarray([True, True, True, False])
    return cache, dcache, ctx, first, np.where(act, lens, 0), act


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind", list(_SPEC_KINDS))
def test_graphed_spec_chunk_bit_identical_to_eager(dev, kind, int8):
    """A speculative chunk of 4 rounds of 3 drafts (prompt lookup, or a
    1-layer draft model made of the target's first layer; the greedy rule,
    or rejection sampling with greedy and stochastic rows; an idle slot)
    captured as a CUDA graph and replayed gives the eager chunk's targets,
    accept counts, logprobs, advanced inputs, key counter and writes to the
    cache, the history and the draft cache bit for bit; so does the next
    chunk, launched from the device outputs."""
    from nf4_tpu_torch.serve.engine import Decoder, Engine, SpecKind, kv_bucket
    from nf4_tpu_torch.serve.sampling import SamplingParams

    draft, greedy = _SPEC_KINDS[kind]
    cfg, params = _small_model(dev, int8)
    dcfg = dataclasses.replace(cfg, num_layers=1) if draft else None
    kw = dict(batch_size=4, eos_token=-1, decode_chunk=4, spec_k=3,
              draft=(dataclasses.replace(params, layers=params.layers[:1]), dcfg) if draft else None)
    eng, plain = Engine(params, cfg, **kw), Engine(params, cfg, cuda_graphs=False, **kw)
    cache, dcache, ctx, first, pos, act = _spec_state(eng, cfg, dcfg)
    graphed = Decoder(eng, cache, dcache)
    eager = Decoder(plain, _clone_cache(cache), None if dcache is None else _clone_cache(dcache))
    sps = [SamplingParams(), SamplingParams(temperature=0.9, top_k=40, top_p=0.9),
           SamplingParams(temperature=1.1, min_p=0.05), SamplingParams(temperature=0.7)]
    for dec in (graphed, eager):
        dec.set_sampling(sps if not greedy else [SamplingParams()] * 4)
        for s, c in enumerate(ctx):
            dec.write_history(s, 0, c)
    spec = SpecKind(3, draft, greedy)
    kv = kv_bucket(int(pos[act].max()) + 16, eng.KV_BUCKET, cfg.max_seq_len)
    outs = [dec.read_spec(dec.launch_spec(4, kv, spec, first, pos, act)) for dec in (graphed, eager)]
    kv2 = kv_bucket(int(pos[act].max()) + 32, eng.KV_BUCKET, cfg.max_seq_len)
    outs += [dec.read_spec(dec.launch_spec(4, kv2, spec)) for dec in (graphed, eager)]
    torch.cuda.synchronize()
    for a, b in ((outs[0], outs[1]), (outs[2], outs[3])):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert torch.equal(graphed.inputs, eager.inputs) and torch.equal(eng.keys.counter, plain.keys.counter)
    assert int(eng.keys.counter) == (0 if greedy else 8)
    assert torch.equal(graphed.hist, eager.hist)
    for mine, theirs in ((graphed.cache, eager.cache), (graphed.dcache, eager.dcache)):
        for name, t in (mine.planes().items() if mine is not None else ()):
            assert torch.equal(t, theirs.planes()[name]), name
    assert set(graphed.graphs) == {(kv, 4, spec), (kv2, 4, spec)} and not eager.graphs
    assert eng.graph_stats["replayed"] == 2


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("spec_k", [3, 7])
def test_verify_row_independent_of_batchmates(dev, spec_k, int8):
    """The verify forward of spec_k + 1 positions per row at batch 4 (16
    rows: the decode kernel of B or D; 32: its prefill kernel): row 0's
    logits from position 100 are the same bits whether its batchmates
    verify near it (kv_len 512) or past position 1400 (kv_len 1536), with
    other tokens."""
    from nf4_tpu_torch.models.llama import forward, init_kv_cache
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import kv_bucket

    cfg, params = _small_model(dev, int8)
    cfg = dataclasses.replace(cfg, max_seq_len=2048)
    gen = torch.Generator(device=dev).manual_seed(31)
    base = init_kv_cache(cfg, 4)
    for name, t in base.planes().items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev, dtype=torch.int8))
        elif t.dtype == torch.float32:
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.05)
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    s = spec_k + 1
    row0 = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=dev, dtype=torch.int32)
    logits = []
    for mates in ((120, 200, 300), (1400, 900, 1200)):
        toks = torch.cat([row0, torch.randint(0, cfg.vocab_size, (3, s), generator=gen, device=dev,
                                              dtype=torch.int32)])
        pos0 = torch.tensor((100,) + mates, dtype=torch.int32, device=dev)
        positions = pos0[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        cache = _clone_cache(base)
        _cuda.reset_launch_counts()
        out, _ = forward(params, cfg, toks, cache, positions, pos0 + s,
                         kv_len=kv_bucket(max(mates) + s, 512, cfg.max_seq_len), decode=True)
        torch.cuda.synchronize()
        name = "int8_matmul" if int8 else "matmul_bf16"
        assert _cuda.launch_counts()[name] == 4 * cfg.num_layers
        logits.append(out[0])
    assert torch.equal(logits[0], logits[1])


def test_capture_with_a_host_sync_raises(dev, monkeypatch):
    """A host sync inside the chunk body makes the capture raise, and the
    Decoder keeps no graph and runs nothing eagerly in its place.  (Last in
    the file: a failed capture may leave its stream's allocations routed
    to the graph's pool.)"""
    from nf4_tpu_torch.serve import engine as engine_mod
    from nf4_tpu_torch.serve.engine import Decoder, Engine

    cfg, params = _small_model(dev, False)
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8)
    cache, tok, pos, act = _decode_state(eng, cfg)
    dec = Decoder(eng, cache)
    sample = engine_mod.sample

    def syncing_sample(logits, sp):
        float(logits.max())  # a read-back to the host
        return sample(logits, sp)

    monkeypatch.setattr(engine_mod, "sample", syncing_sample)
    with pytest.raises(RuntimeError):
        dec.launch(8, 256, tok, pos, act)
    assert not dec.graphs and eng.graph_stats["captured"] == 0 and eng.graph_stats["replayed"] == 0


@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_prefix_cache_graphed_equals_eager(dev, int8, spec_k):
    """With the shared-prefix cache, graphed and pipelined decode gives the
    eager, unpipelined Engine's tokens and logprobs bit for bit (the prefix
    changes no graph's shapes), through refills and a second call that
    reuses the saved prefix."""
    from nf4_tpu_torch.serve.engine import Engine

    cfg, params = _small_model(dev, int8)
    rng = np.random.default_rng(7)
    prefix = list(map(int, rng.integers(0, cfg.vocab_size, 40)))
    prompts = [prefix + list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in (3, 30, 9, 70, 1, 12)]
    kw = dict(batch_size=4, eos_token=-1, decode_chunk=4, prefix_cache=True, spec_k=spec_k)
    graphed = Engine(params, cfg, **kw)
    eager = Engine(params, cfg, cuda_graphs=False, pipeline_decode=False, **kw)
    for eng in (graphed, eager):
        eng.spec_min_accept = 0.0
    for call in range(2):
        got = graphed.generate(prompts, max_new_tokens=12, return_logprobs=True)
        want = eager.generate(prompts, max_new_tokens=12, return_logprobs=True)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert [r.logprobs for r in got] == [r.logprobs for r in want]
        assert graphed.prefix_stats == eager.prefix_stats == {"prefix_len": 40, "tokens_saved": 200,
                                                              "reused": call == 1}
    assert graphed.graph_stats["replayed"] > 0 and eager.graph_stats["replayed"] == 0


@pytest.mark.parametrize("int8", [False, True])
def test_scoring_through_kernel_c_close_to_plain(dev, int8, monkeypatch):
    """``token_logprobs`` with the attention threshold moved down so each
    batch (bucket 256) takes kernel C, against the same call on the plain
    attention path on the card, within 0.05 nats; kernel C launched once
    per layer and batch."""
    from nf4_tpu_torch.eval.ppl import token_logprobs
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.ops import attention as tattn

    cfg, params = _small_model(dev, int8)
    rng = np.random.default_rng(8)
    seqs = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in (200, 256, 140, 300)]
    monkeypatch.setattr(tattn, "_CHUNKED_MIN_SCORE_ELEMS", 1)
    _cuda.reset_launch_counts()
    got = token_logprobs(params, cfg, seqs, batch_size=2)
    counts = _cuda.launch_counts()
    name = "flash_attention_int8" if int8 else "flash_attention"
    assert counts[name] == 2 * cfg.num_layers
    monkeypatch.setattr(tattn, "_flash_eligible", lambda *a: False)
    want = token_logprobs(params, cfg, seqs, batch_size=2)
    assert [len(g) for g in got] == [min(len(s), cfg.max_seq_len) - 1 for s in seqs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=0.05, rtol=0)


def test_half_logits_gradients_in_x_and_w(dev):
    """The bf16 dense product's backward (``_HalfLogits``: a trained dense
    projection or lm_head on the card) gives x and w their gradients: the
    fp32 products of the bf16-rounded upstream gradient, rounded once to
    bf16."""
    from nf4_tpu_torch.models.llama import _dense_logits

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((37, 256), generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
    w = (torch.randn((384, 256), generator=gen, device=dev) * 0.05).to(torch.bfloat16).requires_grad_()
    g = torch.randn((37, 384), generator=gen, device=dev)
    y = _dense_logits(x, w)
    assert y.dtype == torch.float32
    (y * g).sum().backward()
    gb = g.to(torch.bfloat16).float()
    for got, want in ((x.grad, gb @ w.float()), (w.grad, gb.t() @ x.float())):
        assert got is not None and got.dtype == torch.bfloat16
        # One bf16 rounding of fp32 sums taken in another order.
        torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-3 * want.abs().max().item())


# -- multi-LoRA serving on CUDA graphs --------------------------------------------

def _small_bank(cfg, dev, ranks=(4, 8, 2)):
    """Seeded adapters on all four targets, B large enough to move tokens."""
    from nf4_tpu_torch.train import LoraConfig, init_lora

    gen = torch.Generator(device=dev).manual_seed(11)
    out = []
    for j, r in enumerate(ranks):
        lora = init_lora(cfg, LoraConfig(rank=r, alpha=2.0 * r), seed=j, device=dev)
        with torch.no_grad():
            for ll in lora.layers:
                for ab in (ll.qkv, ll.o, ll.gateup, ll.down):
                    ab.b.normal_(0.0, 0.05, generator=gen)
        out.append(lora)
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_graphed_bank_chunk_bit_identical_to_eager(dev, int8):
    """A decode chunk over a multi-LoRA bank (active slots on adapters 2, 0
    and none) captured as a CUDA graph and replayed gives the eager chunk's
    logits, tokens, inputs and cache writes bit for bit; the slot without
    an adapter gives the bank-free chunk's logits bit for bit."""
    from nf4_tpu_torch.ops._cuda import CountedGraph
    from nf4_tpu_torch.serve.engine import Decoder, Engine, kv_bucket

    cfg, params = _small_model(dev, int8)
    bank = _small_bank(cfg, dev)
    common = dict(batch_size=4, eos_token=-1, decode_chunk=8)
    eng = Engine(params, cfg, lora_bank=bank, **common)
    plain = Engine(params, cfg, lora_bank=bank, cuda_graphs=False, **common)
    base = Engine(params, cfg, cuda_graphs=False, **common)
    cache, tok, pos, act = _decode_state(base, cfg)
    ids = np.asarray([2, 0, -1, 1], np.int32)
    graphed, eager, bare = (Decoder(e, c) for e, c in ((eng, cache), (plain, _clone_cache(cache)),
                                                       (base, _clone_cache(cache))))
    graphed.set_adapters(ids)
    eager.set_adapters(ids)
    host = torch.from_numpy(np.stack([tok, pos.astype(np.int32), act.astype(np.int32), np.zeros(4, np.int32)]))
    host = host.to(dev)
    kv = kv_bucket(int(pos[act].max()) + 8, eng.KV_BUCKET, cfg.max_seq_len)
    eager.inputs.copy_(host)
    want = eager.run_eager(8, kv)
    bare.inputs.copy_(host)
    ref = bare.run_eager(8, kv)
    graph = CountedGraph()
    with graph.capture(pool=graphed.pool, stream=eng.graph_stream):
        logits = graphed.run_eager(8, kv)
    graphed.inputs.copy_(host)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(logits, want) and torch.equal(graphed.toks, eager.toks)
    assert torch.equal(graphed.inputs, eager.inputs)
    for name, t in graphed.cache.planes().items():
        assert torch.equal(t, eager.cache.planes()[name]), name
    assert torch.equal(want[2], ref[2]) and torch.equal(eager.toks[:, 2], bare.toks[:, 2])
    assert not torch.equal(want[0], ref[0]) and not torch.equal(want[1], ref[1])


def test_bank_captures_once_for_every_adapter_mix(dev):
    """Two mixes of adapters on one Engine: the second captures no graph;
    both give an eager Engine's tokens, and the requests without an
    adapter the base Engine's, bit for bit."""
    from nf4_tpu_torch.serve.engine import Engine

    cfg, params = _small_model(dev, False)
    bank = _small_bank(cfg, dev)
    rng = np.random.default_rng(12)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in (30, 70, 9, 50, 12)]
    common = dict(batch_size=4, eos_token=-1, decode_chunk=8)
    eng = Engine(params, cfg, lora_bank=bank, **common)
    plain = Engine(params, cfg, lora_bank=bank, cuda_graphs=False, **common)
    base = Engine(params, cfg, **common).generate(prompts, max_new_tokens=24)
    captured = None
    for mix in ([None, 0, 1, 2, 0], [2, None, 0, 1, None]):
        got = eng.generate(prompts, max_new_tokens=24, adapter=mix)
        if captured is None:
            captured = eng.graph_stats["captured"]
        assert eng.graph_stats["captured"] == captured > 0
        want = plain.generate(prompts, max_new_tokens=24, adapter=mix)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert all(r.tokens == b.tokens for r, b, a in zip(got, base, mix) if a is None)
        assert sum(r.tokens != b.tokens for r, b, a in zip(got, base, mix) if a is not None) >= 2


def test_bank_row_independent_of_batchmates_adapters(dev):
    """A request's tokens do not follow its batchmates' adapters: equal
    across two mixes, or the first difference at a near-tie of the
    request's own logits (2e-2 x max |logit|)."""
    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.serve.engine import Engine

    cfg, params = _small_model(dev, False)
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, lora_bank=_small_bank(cfg, dev))
    rng = np.random.default_rng(13)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in (40, 20, 60, 33)]
    a = eng.generate(prompts, max_new_tokens=24, adapter=[1, 0, 2, None])[0]
    b = eng.generate(prompts, max_new_tokens=24, adapter=[1, None, 0, 2])[0]
    if a.tokens != b.tokens:
        at = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
        seq = prompts[0] + a.tokens[:at]
        toks = np.zeros((1, 128), np.int32)
        toks[0, : len(seq)] = seq
        logits = eng.prefill_group(init_kv_cache(cfg, 1), toks, np.asarray([len(seq)], np.int32), np.asarray([0]),
                                   adapter_ids=np.asarray([1], np.int32))[0].float()
        top = logits.topk(2).values
        assert (top[0] - top[1]).item() <= 2e-2 * logits.abs().max().item(), at


def test_diagnostics_kernel_sections(dev, capsys):
    """``python -m nf4_tpu_torch.diagnostics``' kernel sections on the
    card: the build, kernel A's launches, kernels A and F bit for bit
    against their plain versions and the oracle, and the routes."""
    from nf4_tpu_torch import diagnostics

    diagnostics.failures.clear()
    diagnostics.env_report()
    diagnostics.kernel_build_smoke()
    diagnostics.dequant_check()
    diagnostics.backend_check()
    out = capsys.readouterr().out
    assert diagnostics.failures == [] and "[FAIL]" not in out, out
    assert "kernel A bit-exact vs the NumPy oracle" in out and "the card quantizer gives the CPU route's bytes" in out


@pytest.mark.parametrize("b", [4, 1024])
def test_matmul_kernel_llama3_70b_w_gateup(dev, b):
    """Kernel B at Llama-3-70B's largest projection, w_gateup (57344 x
    8192), at decode and prefill rows, within 2e-2 of its plain version."""
    from nf4_tpu_torch.ops.matmul import _matmul_bf16_kernel, _matmul_bf16_plain, _pick_bm

    gen = torch.Generator(device=dev).manual_seed(70)
    pw = _packed(gen, 57344, 8192, dev)
    b_pad = -(-b // _pick_bm(b)) * _pick_bm(b)
    x = torch.zeros((b_pad, 8192), device=dev, dtype=torch.bfloat16)
    x[:b] = torch.randn((b, 8192), generator=gen, device=dev).to(torch.bfloat16)
    got = _matmul_bf16_kernel(x, pw.packed, pw.scales, torch.bfloat16)
    want = _matmul_bf16_plain(x, pw.packed, pw.scales, torch.bfloat16).float()
    torch.cuda.synchronize()
    assert got.shape == (b_pad, 57344)
    assert ((got.float() - want).abs().max() / want.abs().max()).item() < 2e-2
