"""Attention against nf4_tpu: naive, chunked and flash (the plain version of
kernel C; the JAX flash kernel runs in interpret mode), over a bf16 KV
cache and over an int8 one with absmax scales, and the training paths:
self-attention over packed rows with segment ids.

Tolerance rtol = atol = 2e-2 on the rows each sequence can see (rows past
a sequence's length are padding by contract), as the JAX package's own
flash test states it: bf16 inputs and outputs, sums taken in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.ops import attention as jattn
from nf4_tpu_torch.ops import attention as tattn

B, H, KV, S, T, D = 2, 4, 2, 256, 512, 128
TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(rng, pos0=0):
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    positions = np.broadcast_to(pos0 + np.arange(S, dtype=np.int32), (B, S)).copy()
    seq_lens = np.asarray([pos0 + S, pos0 + S - 100], np.int32)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(positions), jnp.asarray(seq_lens)]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)] + [
        torch.from_numpy(positions), torch.from_numpy(seq_lens)
    ]
    return jx, tx


def _check_visible(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(g[0], w[0], **TOL)
    np.testing.assert_allclose(g[1, :, : S - 100], w[1, :, : S - 100], **TOL)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("pos0", [0, 200])
def test_flash_plain_matches_jax_flash(rng, window, pos0):
    jx, tx = _inputs(rng, pos0)
    want = jattn.flash_attention(*jx, scale=D**-0.5, sliding_window=window, sc=128, c=128, interpret=True)
    got = tattn.flash_attention(*tx, scale=D**-0.5, sliding_window=window)
    assert got.shape == (B, H, S, D) and got.dtype == torch.bfloat16
    _check_visible(got, want)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_plain_ragged_matches_jax_flash(rng, int8, window):
    """A ragged prefill: S = 700 queries (not a multiple of kernel C's
    64-row or 64-slot tiles) from position 37, a window edge inside a key
    tile; bf16 and int8 KV.  Tolerance 2e-2, as above."""
    b, s, t, pos0 = 1, 700, 1024, 37
    q = rng.standard_normal((b, H, s, D)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (b, KV, t, D)).astype(np.int8)
        v = rng.integers(-127, 128, (b, KV, t, D)).astype(np.int8)
        ks, vs = (rng.uniform(0.5, 4.0, (b, KV, t)).astype(np.float32) for _ in range(2))
        jkv, tkv = [jnp.asarray(k), jnp.asarray(v)], [torch.from_numpy(k), torch.from_numpy(v)]
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        k, v = (rng.standard_normal((b, KV, t, D)).astype(np.float32) for _ in range(2))
        jkv = [jnp.asarray(a, jnp.bfloat16) for a in (k, v)]
        tkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)]
        jsc, tsc = {}, {}
    positions = (pos0 + np.arange(s, dtype=np.int32))[None]
    seq_lens = np.asarray([pos0 + s], np.int32)
    want = jattn.flash_attention(jnp.asarray(q, jnp.bfloat16), *jkv, jnp.asarray(positions), jnp.asarray(seq_lens),
                                 scale=D**-0.5, sliding_window=window, sc=128, c=128, interpret=True, **jsc)
    got = tattn.flash_attention(torch.from_numpy(q).to(torch.bfloat16), *tkv, torch.from_numpy(positions),
                                torch.from_numpy(seq_lens), scale=D**-0.5, sliding_window=window, **tsc)
    assert got.shape == (b, H, s, D) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("window", [None, 64])
def test_naive_matches(rng, window):
    jx, tx = _inputs(rng)
    want = jattn.naive_attention(*jx, scale=D**-0.5, sliding_window=window)
    got = tattn.naive_attention(*tx, scale=D**-0.5, sliding_window=window)
    _check_visible(got, want)


@pytest.mark.parametrize("window", [None, 64])
def test_chunked_matches(rng, window):
    jx, tx = _inputs(rng, pos0=100)
    want = jattn.chunked_attention(*jx, scale=D**-0.5, sliding_window=window, q_chunk=128, kv_chunk=128)
    got = tattn.chunked_attention(*tx, scale=D**-0.5, sliding_window=window, q_chunk=128, kv_chunk=128)
    _check_visible(got, want)


def test_dispatcher_and_live_prefix(rng):
    """The dispatcher on the CPU: naive below the score threshold, and
    ``kv_len`` (the live prefix) changes nothing for queries that cannot
    see past it."""
    _, tx = _inputs(rng)
    q, k, v, pos, lens = tx
    full = tattn.attention(q, k, v, pos, lens, scale=D**-0.5)
    live = tattn.attention(q, k, v, pos, lens, scale=D**-0.5, kv_len=S)
    np.testing.assert_array_equal(full.float().numpy(), live.float().numpy())
    naive = tattn.naive_attention(q, k, v, pos, lens, scale=D**-0.5)
    np.testing.assert_array_equal(full.float().numpy(), naive.float().numpy())


def _int8_inputs(rng, pos0=0):
    """The same queries with an int8 K/V cache and fp32 absmax scales."""
    jx, tx = _inputs(rng, pos0)
    k8 = rng.integers(-127, 128, (B, KV, T, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, KV, T, D)).astype(np.int8)
    ks = rng.uniform(0.5, 4.0, (B, KV, T)).astype(np.float32)
    vs = rng.uniform(0.5, 4.0, (B, KV, T)).astype(np.float32)
    jx = [jx[0], jnp.asarray(k8), jnp.asarray(v8), jx[3], jx[4]]
    tx = [tx[0], torch.from_numpy(k8), torch.from_numpy(v8), tx[3], tx[4]]
    return (jx, dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)),
            tx, dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("pos0", [0, 200])
def test_int8_kv_flash_plain_matches_jax_flash(rng, window, pos0):
    jx, jsc, tx, tsc = _int8_inputs(rng, pos0)
    want = jattn.flash_attention(*jx, scale=D**-0.5, sliding_window=window, sc=128, c=128, interpret=True, **jsc)
    got = tattn.flash_attention(*tx, scale=D**-0.5, sliding_window=window, **tsc)
    assert got.shape == (B, H, S, D) and got.dtype == torch.bfloat16
    _check_visible(got, want)


@pytest.mark.parametrize("window", [None, 64])
def test_int8_kv_naive_matches(rng, window):
    jx, jsc, tx, tsc = _int8_inputs(rng)
    want = jattn.naive_attention(*jx, scale=D**-0.5, sliding_window=window, **jsc)
    got = tattn.naive_attention(*tx, scale=D**-0.5, sliding_window=window, **tsc)
    _check_visible(got, want)


@pytest.mark.parametrize("window", [None, 64])
def test_int8_kv_chunked_matches(rng, window):
    jx, jsc, tx, tsc = _int8_inputs(rng, pos0=100)
    want = jattn.chunked_attention(*jx, scale=D**-0.5, sliding_window=window, q_chunk=128, kv_chunk=128, **jsc)
    got = tattn.chunked_attention(*tx, scale=D**-0.5, sliding_window=window, q_chunk=128, kv_chunk=128, **tsc)
    _check_visible(got, want)


def test_int8_kv_dispatcher_and_live_prefix(rng):
    """The dispatcher slices the scale planes to the live prefix with K/V."""
    _, _, tx, tsc = _int8_inputs(rng)
    q, k, v, pos, lens = tx
    full = tattn.attention(q, k, v, pos, lens, scale=D**-0.5, **tsc)
    live = tattn.attention(q, k, v, pos, lens, scale=D**-0.5, kv_len=S, **tsc)
    np.testing.assert_array_equal(full.float().numpy(), live.float().numpy())
    naive = tattn.naive_attention(q, k, v, pos, lens, scale=D**-0.5, **tsc)
    np.testing.assert_array_equal(full.float().numpy(), naive.float().numpy())
    with pytest.raises(ValueError, match="both"):
        tattn.flash_attention(q, k, v, pos, lens, scale=D**-0.5, k_scale=tsc["k_scale"])


def _segment_inputs(rng, dtype=torch.bfloat16):
    """Self-attention over packed rows (S == T, slot positions): three
    segments and padding (-1) in row 0, one segment and padding in row 1."""
    s = T // 2
    q = rng.standard_normal((B, H, s, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, s, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, s, D)).astype(np.float32)
    seg = np.full((B, s), -1, np.int32)
    seg[0, :100], seg[0, 100:180], seg[0, 180:230] = 0, 1, 2
    seg[1, :200] = 0
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    seq_lens = np.full(B, s, np.int32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(positions), jnp.asarray(seq_lens)]
    tx = [torch.from_numpy(a).to(dtype) for a in (q, k, v)] + [torch.from_numpy(positions), torch.from_numpy(seq_lens)]
    return jx, jnp.asarray(seg), tx, torch.from_numpy(seg)


@pytest.mark.parametrize("path", ["naive", "chunked"])
def test_segment_ids_match(rng, path):
    """Block-diagonal attention: every row, padding rows included (they
    see the padding slots, in both packages)."""
    jx, jseg, tx, tseg = _segment_inputs(rng)
    kw = dict(q_chunk=64, kv_chunk=64) if path == "chunked" else {}
    want = getattr(jattn, f"{path}_attention")(*jx, scale=D**-0.5, segment_ids=jseg, **kw)
    got = getattr(tattn, f"{path}_attention")(*tx, scale=D**-0.5, segment_ids=tseg, **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)
    # A segment changes what a query sees: without the ids row 0's second
    # segment would attend to the first.
    plain = tattn.naive_attention(*tx, scale=D**-0.5)
    assert not torch.allclose(plain[0, :, 100:180].float(), got[0, :, 100:180].float(), atol=0.1)
    with pytest.raises(ValueError, match="self-attention"):
        getattr(tattn, f"{path}_attention")(tx[0], tx[1][:, :, :64], tx[2][:, :, :64], *tx[3:],
                                            scale=D**-0.5, segment_ids=tseg)


def test_differentiable_dispatch_and_gradients(rng):
    """``differentiable=True`` keeps to the plain paths (never kernel C) and
    gradients flow to q, k and v; fp32 gives the naive path's values."""
    _, _, tx, tseg = _segment_inputs(rng, torch.float32)
    q, k, v, pos, lens = tx
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = tattn.attention(q, k, v, pos, lens, scale=D**-0.5, differentiable=True, segment_ids=tseg)
    torch.testing.assert_close(out, tattn.naive_attention(q, k, v, pos, lens, scale=D**-0.5, segment_ids=tseg))
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def _decode_inputs(rng, int8):
    """One query per row at positions 40 and 1300 over a cache of three
    512-slot key blocks, bf16 or int8 K/V."""
    t = 3 * tattn.DECODE_KV_BLOCK
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    if int8:
        k, v = (rng.integers(-127, 128, (B, KV, t, D)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.5, 4.0, (B, KV, t)).astype(np.float32) for _ in range(2))
        jkv, tkv = [jnp.asarray(k), jnp.asarray(v)], [torch.from_numpy(k), torch.from_numpy(v)]
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        k, v = (rng.standard_normal((B, KV, t, D)).astype(np.float32) for _ in range(2))
        jkv = [jnp.asarray(a, jnp.bfloat16) for a in (k, v)]
        tkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)]
        jsc, tsc = {}, {}
    positions = np.asarray([[40], [1300]], np.int32)
    lens = positions[:, 0] + 1
    jx = [jnp.asarray(q, jnp.bfloat16), *jkv, jnp.asarray(positions), jnp.asarray(lens)]
    tx = [torch.from_numpy(q).to(torch.bfloat16), *tkv, torch.from_numpy(positions), torch.from_numpy(lens)]
    return jx, jsc, tx, tsc


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 1000])
def test_decode_attention_matches_jax(rng, int8, window):
    """Decode over three key blocks (a window edge inside the second, the
    second row's position in the third) against the JAX package's naive
    attention, directly and through the dispatcher: TOL."""
    jx, jsc, tx, tsc = _decode_inputs(rng, int8)
    want = np.asarray(jattn.naive_attention(*jx, scale=D**-0.5, sliding_window=window, **jsc), np.float32)
    got = tattn.decode_attention(*tx, scale=D**-0.5, sliding_window=window, **tsc)
    assert got.shape == (B, H, 1, D) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    routed = tattn.attention(*tx, scale=D**-0.5, sliding_window=window, kv_len=1400, **tsc)
    np.testing.assert_allclose(routed.float().numpy(), want, **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_independent_of_kv_len(rng, int8):
    """A row's decode output is the same bits whatever ``kv_len`` reads
    past its position (whole blocks, a partial last block, the full
    cache): the property that keeps a request's logits independent of its
    batchmates' positions and the decode chunk."""
    _, _, tx, tsc = _decode_inputs(rng, int8)
    outs = [tattn.decode_attention(*tx, scale=D**-0.5, kv_len=n, **tsc).float().numpy()
            for n in (1400, 1536, None)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    # Row 0 (position 40) sees only the first block.
    first = tattn.decode_attention(*tx, scale=D**-0.5, kv_len=512, **tsc).float().numpy()
    np.testing.assert_array_equal(first[0], outs[0][0])
    # More queries per row than a verify window may hold are refused.
    with pytest.raises(ValueError, match="queries per row"):
        tattn.decode_attention(tx[0].expand(B, H, tattn.DECODE_MAX_QUERIES + 1, D), *tx[1:], scale=D**-0.5)
