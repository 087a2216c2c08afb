"""Sequence-parallel ring prefill (``parallel/sp.py``) on 4 gloo ranks on
the CPU, against the JAX package's ``sp_prefill`` on a 4-device ``("sp",)``
mesh: every case of ``tests/test_sp.py``, on the same weights and prompts.

* Layer 0's K and V (and the int8 scales) bit-identical to the port's own
  one-process prefill: they see the same inputs and no cross-rank math
  (the JAX test's gate); and, where the JAX package's bf16 K/V are the
  same bits, to the JAX ring's too.
* The cache within 5e-2 (Gemma-2 3e-1, ``tests/test_sp.py``'s reasons)
  and the logits within 2e-2 of their largest value (Gemma-2 5e-2) of the
  JAX ring's, the next token equal; every rank holds the same bits.  (The
  port's ring keeps its probabilities fp32 through the product with V,
  where the JAX ring rounds them to bf16: inside those tolerances.)
* Decode from the ring-built cache agrees with decode from the port's
  one-process cache under the near-tie rule; right-padded rows take their logits from the rank holding their
  last token, whatever the padding; a length that does not divide raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import _torch_dist as td
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.parallel.sp import sp_prefill as jsp_prefill
from nf4_tpu_torch.models import configs, llama
from nf4_tpu_torch.parallel.launch import Ranks
from nf4_tpu_torch.parallel.mesh import Mesh
from nf4_tpu_torch.parallel.sp import Ring, ring_of, sp_prefill
from _torch_threads import _one_thread  # noqa: F401

N_SP = 4
B, S = 2, 32
NEAR_TIE = 2e-2

CASES = {
    "plain": (configs.TINY_TEST, jconfigs.TINY_TEST, 2e-2, 5e-2),
    "kv_quant": (dataclasses.replace(configs.TINY_TEST, kv_quant=True),
                 dataclasses.replace(jconfigs.TINY_TEST, kv_quant=True), 2e-2, 5e-2),
    "sliding_window": (dataclasses.replace(configs.TINY_TEST, sliding_window=8),
                       dataclasses.replace(jconfigs.TINY_TEST, sliding_window=8), 2e-2, 5e-2),
    "gemma2": (configs.TINY_GEMMA2, jconfigs.TINY_GEMMA2, 5e-2, 3e-1),
}


@pytest.fixture(scope="module")
def ranks():
    with Ranks(N_SP, backend="gloo", device="cpu", threads=1, timeout=td.RUN_TIMEOUT_S) as r:
        yield r


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < N_SP:
        pytest.skip(f"needs {N_SP} devices")
    return JaxMesh(np.array(jax.devices()[:N_SP]), ("sp",))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, configs.TINY_TEST.vocab_size, size=(B, S)).astype(np.int32)


def _jax_ring(jcfg, jmesh, toks, lens=None):
    params = jllama.init_params(jcfg, seed=0)
    logits, cache, out_lens = jsp_prefill(params, jcfg, jnp.asarray(toks), jmesh, axis="sp",
                                          seq_lens=None if lens is None else jnp.asarray(lens))
    return params, np.asarray(logits, np.float32), cache, np.asarray(out_lens)


@pytest.mark.parametrize("case", list(CASES))
def test_sp_prefill_matches_jax_ring(ranks, jmesh, tokens, case):
    cfg, jcfg, logit_tol, cache_tol = CASES[case]
    toks = tokens % cfg.vocab_size
    (logits, planes, lens, _), same = ranks.run(td.sp_prefill_rank, cfg, 0, toks, tp=1, dp=N_SP)
    assert same, "ranks returned different bits"
    assert (lens == S).all()
    # The gate: layer 0's K/V (and scales) are the one-process prefill's bits.
    _, want = llama.prefill_chunked(llama.init_params(cfg, 0, device="cpu"), cfg, torch.from_numpy(toks))
    for name, t in want.planes().items():
        np.testing.assert_array_equal(planes[name][0, :, :, :S], td._np(t)[0, :, :, :S] if t.dtype != torch.int8
                                      else t.numpy()[0, :, :, :S], err_msg=name)
    _, jlogits, jcache, _ = _jax_ring(jcfg, jmesh, toks)
    if not cfg.kv_quant:  # int8 codes flip at bin edges on rounding differences
        for name in ("k", "v"):
            np.testing.assert_allclose(planes[name][:, :, :, :S], np.asarray(getattr(jcache, name), np.float32)[:, :, :, :S],
                                       rtol=cache_tol, atol=cache_tol, err_msg=name)
    np.testing.assert_allclose(logits, jlogits, rtol=logit_tol, atol=logit_tol * np.abs(jlogits).max())
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


def test_decode_continues_from_sp_cache(ranks, tokens):
    """Four greedy decode steps from the ring-built cache against the same
    steps from the port's one-process cache (the JAX test's hand-off
    contract), teacher-forced on the one-process tokens: logits within
    2e-2 of their largest value, the same argmax unless the one-process
    top-2 gap is within NEAR_TIE of it (the caches differ within the cache
    tolerance; this tiny model has a gap of 0.005 at step 1).  Against the
    JAX package's decode the port's bf16 projections differ by up to
    ``test_torch_llama.py``'s 0.2, so the gate is the port's own cache."""
    cfg = configs.TINY_TEST
    tparams = llama.init_params(cfg, 0, device="cpu")
    _, cache = llama.prefill_chunked(tparams, cfg, torch.from_numpy(tokens))
    tok, pos, fed, want = torch.as_tensor([5, 9], dtype=torch.int32), torch.full((B,), S, dtype=torch.int32), [], []
    for _ in range(4):
        fed.append(tok.numpy())
        lg, cache = llama.decode_step(tparams, cfg, tok, cache, pos)
        want.append(lg.numpy())
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    (_, _, _, got), _ = ranks.run(td.sp_prefill_rank, cfg, 0, tokens, None, np.asarray(fed), tp=1, dp=N_SP)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    top2 = np.sort(want, axis=-1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= NEAR_TIE * scale
    assert ((got.argmax(-1) == want.argmax(-1)) | tie).all()


def test_right_padded_rows(ranks, jmesh, tokens):
    """Row 1's last token lies inside rank 1's slice; its logits come from
    there, match the JAX ring's and do not follow the padding's tokens."""
    cfg, jcfg = configs.TINY_TEST, jconfigs.TINY_TEST
    lens = np.asarray([S, S // 2 - 3], np.int32)
    toks = tokens.copy()
    toks[1, lens[1]:] = 0
    (got, _, out_lens, _), _ = ranks.run(td.sp_prefill_rank, cfg, 0, toks, lens, tp=1, dp=N_SP)
    np.testing.assert_array_equal(out_lens, lens)
    _, want, _, _ = _jax_ring(jcfg, jmesh, toks, lens)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    toks2 = toks.copy()
    toks2[1, lens[1]:] = 7
    (got2, _, _, _), _ = ranks.run(td.sp_prefill_rank, cfg, 0, toks2, lens, tp=1, dp=N_SP)
    np.testing.assert_array_equal(got2[1], got[1])


def test_refusals():
    """A length that does not divide over the ranks raises before any
    collective; a tensor-parallel mesh has no ring."""
    with pytest.raises(ValueError, match="tp x sp"):
        ring_of(Mesh(tp=2, dp=2, rank=0, tp_rank=0, dp_rank=0, tp_group=None, dp_group=None,
                     device=torch.device("cpu"), backend="gloo"))
    cfg = configs.TINY_TEST
    ring = Ring(mesh=None, group=None, size=N_SP, rank=0)
    with pytest.raises(ValueError, match="must divide over 4"):
        sp_prefill(llama.init_params(cfg, 0, device="cpu"), cfg, torch.zeros((1, 30), dtype=torch.int32), ring)
