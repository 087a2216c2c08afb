"""Attention against nf4_tpu: naive, chunked and flash (the plain version of
kernel C; the JAX flash kernel runs in interpret mode), over a bf16 KV
cache and over an int8 one with absmax scales.

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
