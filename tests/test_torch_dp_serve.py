"""``Engine(mesh=)`` over a dp x tp mesh: data-parallel serving over gloo
ranks on the CPU (one group of 4 for the module: dp = 2 x tp = 2 on all
four, dp = 2 x tp = 1 on ranks 0 and 1).

* Greedy tokens are the same on every rank and agree with the JAX
  package's Engine over ``make_mesh(tp=, dp=)`` on the same weights under
  the near-tie rule (a difference must start where the JAX logits' top-2
  gap is at most 2e-2), also in continuous batching (5 prompts in 2
  slots) and in int8 / kv8.
* Each rank's cache holds its dp group's slots only, and their rows agree
  with the one-process Engine's rows of the same slots within the cache
  tolerance of ``tests/test_sp.py`` (5e-2).
* Sampling follows the global slot, not the rank's row: seeded and
  unseeded sampled requests give the one-process Engine's tokens.  (The
  JAX package's stochastic bits are not reproduced, so its sampled tokens
  are no reference.)
* Speculation and the prefix cache give the plain data-parallel Engine's
  tokens; what the JAX Engine refuses over a mesh, and a batch that dp
  does not divide, are refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.parallel.mesh import make_mesh as jax_mesh
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models import configs, llama
from nf4_tpu_torch.parallel.launch import Ranks
from nf4_tpu_torch.parallel.mesh import Mesh
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import SamplingParams
from _torch_threads import _one_thread  # noqa: F401

PROMPTS = [[3, 5, 7], [11, 13], [1, 2, 3, 4, 5, 6, 7, 8, 9], [200, 100, 50, 25], [9, 9, 9, 1], [42] * 20]
NEW = 6
NEAR_TIE = 2e-2


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, backend="gloo", device="cpu", threads=1, timeout=td.RUN_TIMEOUT_S) as r:
        yield r


def _cfgs(tp_shards, int8=False):
    return (dataclasses.replace(configs.TINY_TP, tp_shards=tp_shards, kv_quant=int8),
            dataclasses.replace(jconfigs.TINY_TP, tp_shards=tp_shards, kv_quant=int8))


def _jax_tokens(jcfg, prompts, batch_size, mesh=None, int8=False):
    if mesh is not None and len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    params = jllama.init_params(jcfg, seed=0)
    if int8:
        params = jllama.recode_params_int8(params)
    eng = JaxEngine(params, jcfg, batch_size=batch_size, eos_token=-1, mesh=mesh)
    return params, [r.tokens for r in eng.generate(prompts, max_new_tokens=NEW)]


def _agree_until_near_tie(params, jcfg, prompts, got, want):
    """Each request's tokens equal the JAX Engine's, or first differ where
    the JAX logits' top-2 gap after the common tokens is at most NEAR_TIE."""
    for prompt, g, w in zip(prompts, got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                seq = jnp.asarray([list(prompt) + list(w[:i])], jnp.int32)
                row = np.asarray(jllama.prefill(params, jcfg, seq)[0], np.float32)[0, -1]
                top2 = np.sort(row)[-2:]
                assert top2[1] - top2[0] <= NEAR_TIE, "diverged where the JAX Engine's choice was clear"
                break
        else:
            assert len(g) == len(w) == NEW


def _same_on_every_rank(every):
    assert all(e[0] == every[0][0] for e in every), "ranks sampled different tokens"
    return every[0][0]


@pytest.mark.parametrize("tp,dp", [(2, 2), (1, 2)], ids=["dp2xtp2", "dp2xtp1"])
def test_dp_engine_matches_jax_engine(ranks, tp, dp):
    cfg, jcfg = _cfgs(tp)
    every = ranks.run(td.generate_mesh, cfg, 0, PROMPTS, NEW, tp=tp, dp=dp)
    got = _same_on_every_rank(every)
    params, want = _jax_tokens(jcfg, PROMPTS, 4, jax_mesh(tp=tp, dp=dp))
    _agree_until_near_tie(params, jcfg, PROMPTS, got, want)
    for r, (_, rows, k, stats) in enumerate(every):
        lo = (r // tp) * 4 // dp
        assert rows == (lo, lo + 4 // dp) and k.shape[1] == 4 // dp, "a rank holds only its dp group's slots"
        assert stats["comm"]["calls"] > 0


def test_tp_prefill_and_decode_step_over_dp_match_jax(ranks):
    """``tp_prefill`` / ``tp_decode_step`` at dp = 2 x tp = 2: each rank runs
    its dp group's rows into a cache of those rows; the logits of the whole
    batch, the same on every rank, against the JAX package's over
    ``make_mesh(tp=2, dp=2)`` with ``data_axis="dp"`` (within 2e-2 of the
    largest, ``tests/test_torch_parallel.py``'s tolerance)."""
    from nf4_tpu.parallel import tp as jtp

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    cfg, jcfg = _cfgs(2)
    toks = np.arange(24, dtype=np.int32).reshape(4, 6) * 7 % 256
    tok, pos = np.array([5, 9, 2, 7], np.int32), np.full(4, 6, np.int32)
    mesh = jax_mesh(tp=2, dp=2)
    sharded, _ = jtp.shard_params(jtp.localize_params(jllama.init_params(jcfg, seed=0), 2), mesh)
    want, jcache = jtp.tp_prefill(sharded, jcfg, mesh, jnp.asarray(toks), data_axis="dp")
    want_dec, _ = jtp.tp_decode_step(sharded, jcfg, mesh, jnp.asarray(tok), jcache, jnp.asarray(pos), data_axis="dp")
    logits, dec, caches, same, _ = ranks.run(td.prefill_decode, cfg, 0, toks, tok, pos, tp=2, dp=2)
    assert same, "ranks hold different logits"
    for got, w in ((logits, np.asarray(want, np.float32)), (dec, np.asarray(want_dec, np.float32))):
        np.testing.assert_allclose(got, w, rtol=0, atol=2e-2 * np.abs(w).max())
    assert all(c["k"].shape[1] == 2 for c in caches), "a rank's cache holds its dp group's 2 rows"


def test_continuous_batching_five_prompts_two_slots(ranks):
    """5 requests through 2 slots, one per dp group: every refill prefills
    on the group that owns the slot, and the first tokens reach both."""
    cfg, jcfg = _cfgs(1)
    prompts = [[i + 1, i + 2] for i in range(5)]
    every = ranks.run(td.generate_mesh, cfg, 0, prompts, NEW, batch_size=2, tp=1, dp=2)
    got = _same_on_every_rank(every)
    params, want = _jax_tokens(jcfg, prompts, 2, jax_mesh(tp=1, dp=2))
    assert len(got) == 5
    _agree_until_near_tie(params, jcfg, prompts, got, want)
    assert [e[1] for e in every] == [(0, 1), (1, 2)]


def test_cache_rows_are_the_one_process_rows(ranks):
    """Each rank's cache rows agree with the one-process Engine's rows of
    its slots after the same call (the last requests each slot served)."""
    cfg, _ = _cfgs(1)
    every = ranks.run(td.generate_mesh, cfg, 0, PROMPTS, NEW, tp=1, dp=2)
    eng = Engine(td.model(cfg, 0), cfg, batch_size=4, eos_token=-1, device="cpu", cuda_graphs=False)
    want = [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=NEW)]
    assert _same_on_every_rank(every) == want
    whole = eng.state()[0].k.float().numpy()
    for _, (lo, hi), k, _ in every:
        np.testing.assert_allclose(k, whole[:, lo:hi], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
def test_sampling_follows_the_global_slot(ranks, seeded):
    """Sampled requests (per-request filters, penalties, logprobs) give the
    one-process Engine's tokens at dp = 2 x tp = 1: a row's noise is a hash
    of its seed and step, or of the draw's key and its GLOBAL slot."""
    cfg, _ = _cfgs(1)
    sps = [SamplingParams(temperature=0.8, top_k=20, seed=7 + i if seeded else None,
                          repetition_penalty=1.1 if i % 2 else 1.0) for i in range(len(PROMPTS))]
    kw = dict(sampling=sps, return_logprobs=True)
    every = ranks.run(td.generate_mesh, cfg, 0, PROMPTS, NEW, gen_kw=kw, tp=1, dp=2)
    eng = Engine(td.model(cfg, 0), cfg, batch_size=4, eos_token=-1, device="cpu", cuda_graphs=False)
    want = [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=NEW, **kw)]
    assert _same_on_every_rank(every) == want


def test_int8_kv8_over_dp_tp(ranks):
    """int8 weights and an int8 KV cache at dp = 2 x tp = 2 (kernels D and
    C-int8 on a card) against the JAX int8 / kv8 Engine."""
    cfg, jcfg = _cfgs(2, int8=True)
    got = _same_on_every_rank(ranks.run(td.generate_mesh, cfg, 0, PROMPTS, NEW, int8=True, tp=2, dp=2))
    params, want = _jax_tokens(jcfg, PROMPTS, 4, int8=True)
    _agree_until_near_tie(params, jcfg, PROMPTS, got, want)


@pytest.mark.parametrize("extra", [dict(spec_k=3), dict(prefix_cache=True)], ids=["spec_k3", "prefix_cache"])
def test_spec_and_prefix_cache_over_dp(ranks, extra):
    """Greedy speculation (its verify forward split over the dp groups) and
    the prefix cache (the prefix prefilled on every rank) give the plain
    data-parallel Engine's tokens."""
    cfg, _ = _cfgs(1)
    prompts = [[9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8, 7, 6, 5, 4, 3] + p for p in PROMPTS[:4]]
    plain = _same_on_every_rank(ranks.run(td.generate_mesh, cfg, 0, prompts, NEW, tp=1, dp=2))
    every = ranks.run(td.generate_mesh, cfg, 0, prompts, NEW, engine_kw=extra, tp=1, dp=2)
    assert _same_on_every_rank(every) == plain
    stats = every[0][3]
    if "spec_k" in extra:
        assert stats["spec"]["steps"] > 0
    else:
        assert stats["prefix"]["prefix_len"] == 16


def _mesh(tp=1, dp=1):
    return Mesh(tp=tp, dp=dp, rank=0, tp_rank=0, dp_rank=0, tp_group=None, dp_group=None,
                device=torch.device("cpu"), backend="gloo")


def test_dp_refusals():
    cfg = dataclasses.replace(configs.TINY_TP, tp_shards=1, num_layers=1)
    params = llama.init_params(cfg, 0, device="cpu")
    kw = dict(eos_token=-1, device="cpu", cuda_graphs=False)
    with pytest.raises(ValueError, match="batch_size 3 must be a multiple of the data-parallel degree 2"):
        Engine(params, cfg, batch_size=3, mesh=_mesh(dp=2), **kw)
    with pytest.raises(NotImplementedError, match="CUDA graphs over a process group"):
        Engine(params, cfg, batch_size=4, mesh=_mesh(dp=2), **dict(kw, cuda_graphs=True))
    with pytest.raises(ValueError, match="draft-model speculation is single-device"):
        Engine(params, cfg, batch_size=4, mesh=_mesh(dp=2), spec_k=3, draft=(params, cfg), **kw)
    eng = Engine(params, cfg, batch_size=4, mesh=_mesh(dp=2), **kw)
    assert eng.local_batch == 2 and eng.rows[:2] == (0, 2)
    with pytest.raises(ValueError, match="score\\(\\) is single-device"):
        eng.score([[1, 2, 3]])
