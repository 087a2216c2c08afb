"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  Run them on
a machine with an H100 (sm_90a) and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Kernels A and F must be bit-exact (and so must kernel D's prefill weight
values); kernels B, C (bf16 and int8 KV) and D within 2e-2 (bf16 products summed in another order than the plain
version's); kernel E (fp32 products) within 1e-5 of the largest value for
fp32 out, within one rounding for fp16 (2e-3) and bf16 (8e-3) out; the
``nf4_matmul`` backward within 1e-5 of the largest value, under every
``torch.set_float32_matmul_precision`` setting.
"""

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


_EXACT_LIMIT = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 8e-3}


@pytest.mark.parametrize("b", [1, 4, 37, 64, 200, 320, 704])
@pytest.mark.parametrize(
    "xdt,out_dtype",
    [(torch.float32, torch.float32), (torch.float32, torch.bfloat16), (torch.float16, torch.float16),
     (torch.float16, torch.float32)],
)
def test_exact_matmul_kernel_close(dev, b, xdt, out_dtype):
    """Kernel E's decode kernel (b_pad 16) and its 3xTF32 prefill kernel
    (b_pad 64, 256, 320, 704: 128-row blocks, a ragged last tile at 320 and
    704), fp32 and fp16 x."""
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
