"""Kernel C's shape contract on the CPU: its plain version ``_flash_plain``
against the JAX flash kernel in interpret mode (as
``test_torch_attention.py`` runs it) at the shapes the contract adds to D
in (64, 128) with 64 % G == 0: GQA groups of 7 and 3 (Qwen2-7B; idle rows in
the kernel's 64-row query tiles), D = 256 (Gemma; 32-slot key tiles) and
D = 384 (the wide kernel), bf16 and int8 KV, with and without a window,
ragged (S = 300 from position 37, a second sequence 60 shorter).

Tolerance rtol = atol = 2e-2 on the rows each sequence can see, as
``test_torch_attention.py`` states it: bf16 inputs and outputs, sums taken
in other orders.  The kernel itself is held to ``_flash_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.ops import attention as jattn
from nf4_tpu_torch.ops import attention as tattn

TOL = dict(rtol=2e-2, atol=2e-2)
S, T, POS0 = 300, 512, 37
# (H, KV, D)
SHAPES = [(14, 2, 128), (6, 2, 128), (4, 2, 256), (2, 2, 384)]


def _inputs(rng, h, kv, d, int8):
    b = 2
    q = rng.standard_normal((b, h, S, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (b, kv, T, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, kv, T, d)).astype(np.int8)
        ks, vs = (rng.uniform(0.5, 4.0, (b, kv, T)).astype(np.float32) for _ in range(2))
        jkv, tkv = [jnp.asarray(k), jnp.asarray(v)], [torch.from_numpy(k), torch.from_numpy(v)]
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    else:
        k, v = (rng.standard_normal((b, kv, T, d)).astype(np.float32) for _ in range(2))
        jkv = [jnp.asarray(a, jnp.bfloat16) for a in (k, v)]
        tkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)]
        jsc, tsc = {}, {}
    positions = np.broadcast_to(POS0 + np.arange(S, dtype=np.int32), (b, S)).copy()
    lens = np.asarray([POS0 + S, POS0 + S - 60], np.int32)
    jx = [jnp.asarray(q, jnp.bfloat16), *jkv, jnp.asarray(positions), jnp.asarray(lens)]
    tx = [torch.from_numpy(q).to(torch.bfloat16), *tkv, torch.from_numpy(positions), torch.from_numpy(lens)]
    return jx, jsc, tx, tsc


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,kv,d", SHAPES)
def test_flash_plain_matches_jax_flash_at_new_shapes(rng, h, kv, d, int8, window):
    jx, jsc, tx, tsc = _inputs(rng, h, kv, d, int8)
    want = jattn.flash_attention(*jx, scale=d**-0.5, sliding_window=window, sc=128, c=128, interpret=True, **jsc)
    got = tattn.flash_attention(*tx, scale=d**-0.5, sliding_window=window, **tsc)
    assert got.shape == (2, h, S, d) and got.dtype == torch.bfloat16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(g[0], w[0], **TOL)
    np.testing.assert_allclose(g[1, :, : S - 60], w[1, :, : S - 60], **TOL)


@pytest.mark.parametrize("g,sc", [(1, 64), (3, 21), (7, 9), (8, 8), (64, 1), (96, 1)])
def test_query_tile_packing(g, sc):
    """sc = floor(64 / G) positions per 64-row query tile, at least one:
    the rows that hold queries fit in the tile, and for G <= 64 fewer than
    G of its rows are idle."""
    assert tattn._flash_sc(g) == sc
    heads = min(g, 64 // sc)
    assert heads * sc <= 64 and (g > 64 or 64 - g * sc < g)


@pytest.mark.parametrize("d,ok,tile", [(64, True, 64), (128, True, 64), (256, True, 32), (384, True, 64),
                                       (512, True, 64), (96, False, None), (192, False, None), (32, False, None)])
def test_head_sizes_of_the_contract(d, ok, tile):
    """D = 64 or any multiple of 128 (the TPU kernel's condition); the key
    tile the plain version mirrors; any other D raises before a launch."""
    assert tattn._flash_head_dim(d) == ok
    q = torch.zeros((1, 7, 256, d), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 512, d), dtype=torch.bfloat16)
    pos, lens = torch.zeros(1, dtype=torch.int32), torch.full((1,), 256, dtype=torch.int32)
    if ok:
        assert tattn._flash_tile(d) == tile
        assert tattn._flash_plain(q, k, k, pos, lens, 1.0).shape == q.shape
    else:
        with pytest.raises(ValueError, match="D = 64 or a multiple of 128"):
            tattn._flash_kernel(q, k, k, pos, lens, 1.0)


def test_kernel_rejects_a_group_that_does_not_divide():
    q = torch.zeros((1, 7, 256, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 512, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="KV \\| H"):
        tattn._flash_kernel(q, k, k, torch.zeros(1, dtype=torch.int32), torch.full((1,), 256, dtype=torch.int32), 1.0)


@pytest.mark.parametrize("h,kv,d", SHAPES)
def test_flash_plain_matches_naive_at_new_shapes(rng, h, kv, d):
    """The plain version's key tiles (32 slots at D = 256) against the
    one-pass softmax, windowed and ragged: the online softmax is the same
    function up to bf16 rounding."""
    _, _, tx, _ = _inputs(rng, h, kv, d, False)
    got = tattn.flash_attention(*tx, scale=d**-0.5, sliding_window=100).float().numpy()
    want = tattn.naive_attention(*tx, scale=d**-0.5, sliding_window=100).float().numpy()
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1, :, : S - 60], want[1, :, : S - 60], **TOL)
