"""The port's shared-prefix cache (``Engine(prefix_cache=True)``) against
nf4_tpu's, the cases of ``tests/test_prefix_cache.py`` but tensor
parallelism.

The bar is the JAX package's: the same tokens (and logprobs within 1e-5)
as the port's own Engine without the cache on the same prompts.  Against
the JAX Engine with ``prefix_cache=True``: the same ``prefix_stats``, and
its tokens under the near-tie rule of ``test_torch_engine.py`` (the port
rounds weights to bf16, the JAX CPU path does not).

One case goes past the reference: a request admitted mid-call into a slot
that sat idle.  Idle slots ride decode chunks frozen at position 0 and
verify frozen at positions 0..spec_k, inside the prefix; the port writes
the saved prefix into a slot at every refill, so the admitted request
gets its tokens alone.  (The JAX Engine broadcasts the prefix once per
call and its admitted request attends to what the idle slot wrote.)
"""

import dataclasses

import numpy as np
import pytest
from test_torch_engine import _hold_to_jax

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu.serve.engine import _common_prefix_len as jax_common_prefix_len
from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.convert import config_from_dict
from nf4_tpu_torch.serve.engine import Engine, _common_prefix_len
from _torch_threads import _one_thread  # noqa: F401

PREFIX = [7, 3, 11, 5, 2, 9, 13, 4, 8, 6, 1, 12, 10, 14, 15, 3, 7, 2, 5, 9]


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX params, port cfg, port params): tiny-test at
    max_seq_len 128, the same seeded weights in both packages."""
    cfg = dataclasses.replace(jconfigs.TINY_TEST, max_seq_len=128)
    tcfg = config_from_dict(config_to_dict(cfg))
    return cfg, jllama.init_params(cfg, seed=0), tcfg, llama.init_params(tcfg, seed=0, device="cpu")


def _prompts(n):
    return [PREFIX + [20 + i, 21 + i, 22 + (i % 3)] for i in range(n)]


def _tokens(results):
    return [r.tokens for r in results]


def test_common_prefix_len():
    for prompts in ([[1, 2, 3], [1, 2, 4], [1, 2]], [[1, 2], [3, 4]], [[5, 6, 7]], _prompts(3), [[], [1]]):
        assert _common_prefix_len(prompts) == jax_common_prefix_len(prompts)
    assert _common_prefix_len([[1, 2, 3], [1, 2, 4], [1, 2]]) == 2


def test_prefix_matches_plain_with_refill(setup):
    """5 requests through 2 slots: refills continue from the prefix; the
    plain Engine's tokens and logprobs, the JAX prefix Engine's stats and
    tokens."""
    cfg, jparams, tcfg, tparams = setup
    prompts = _prompts(5)
    want = Engine(tparams, tcfg, batch_size=2, eos_token=-1, device="cpu").generate(
        prompts, max_new_tokens=8, return_logprobs=True)
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, prefix_cache=True, device="cpu")
    got = eng.generate(prompts, max_new_tokens=8, return_logprobs=True)
    assert eng.prefix_stats == {"prefix_len": len(PREFIX), "tokens_saved": len(PREFIX) * 4, "reused": False}
    assert _tokens(got) == _tokens(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)
    jeng = JaxEngine(jparams, cfg, batch_size=2, eos_token=-1, prefix_cache=True)
    jwant = jeng.generate(prompts, max_new_tokens=8)
    assert eng.prefix_stats == jeng.prefix_stats
    _hold_to_jax(cfg, jparams, got, jwant, {-1})


def test_cross_call_prefix_reuse(setup):
    """A second call with the same prefix reuses the saved rows: only the
    continuations prefill, no prefix-sized bucket; a different prefix
    prefills again; ``prefix_stats`` as the JAX Engine's."""
    cfg, jparams, tcfg, tparams = setup
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, prefix_cache=True, device="cpu")
    jeng = JaxEngine(jparams, cfg, batch_size=2, eos_token=-1, prefix_cache=True)
    first = eng.generate(_prompts(3), max_new_tokens=6)
    jeng.generate(_prompts(3), max_new_tokens=6)
    assert eng.prefix_stats["reused"] is False and eng.prefix_stats == jeng.prefix_stats

    buckets = []
    orig = eng.prefill_group
    eng.prefill_group = lambda cache, toks, *a, **kw: (buckets.append(toks.shape[1]), orig(cache, toks, *a, **kw))[1]
    second = eng.generate(_prompts(3), max_new_tokens=6)
    jeng.generate(_prompts(3), max_new_tokens=6)
    assert eng.prefix_stats["reused"] is True and eng.prefix_stats == jeng.prefix_stats
    assert buckets == [16, 16]  # a group of 2, then a refill: continuation buckets only
    assert _tokens(second) == _tokens(first)

    eng.prefill_group = orig
    other = [[9, 9] + PREFIX + [40 + i] for i in range(3)]
    want = Engine(tparams, tcfg, batch_size=2, eos_token=-1, device="cpu").generate(other, max_new_tokens=6)
    got = eng.generate(other, max_new_tokens=6)
    assert eng.prefix_stats["reused"] is False and eng.prefix_stats["prefix_len"] == len(PREFIX) + 2
    assert _tokens(got) == _tokens(want)


def test_short_lcp_disables_prefix(setup):
    """A shared prefix under 16 tokens leaves the plain path untouched."""
    cfg, jparams, tcfg, tparams = setup
    prompts = [[1, 2, 3, 40 + i, 50 + i] for i in range(3)]
    want = Engine(tparams, tcfg, batch_size=2, eos_token=-1, device="cpu").generate(prompts, max_new_tokens=5)
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, prefix_cache=True, device="cpu")
    got = eng.generate(prompts, max_new_tokens=5)
    assert eng.prefix_stats["prefix_len"] == 0 and _tokens(got) == _tokens(want)
    single = eng.generate([PREFIX + [1, 2]], max_new_tokens=2)  # one prompt: no prefix
    assert eng.prefix_stats["prefix_len"] == 0 and len(single[0].tokens) == 2


def test_prompt_equal_to_prefix_edge(setup):
    """A prompt that IS the shared prefix: Lp stops one short, so that
    request still prefills its last token (its first logits)."""
    cfg, jparams, tcfg, tparams = setup
    prompts = [list(PREFIX), PREFIX + [30], PREFIX + [31, 32]]
    want = Engine(tparams, tcfg, batch_size=3, eos_token=-1, device="cpu").generate(prompts, max_new_tokens=6)
    eng = Engine(tparams, tcfg, batch_size=3, eos_token=-1, prefix_cache=True, device="cpu")
    got = eng.generate(prompts, max_new_tokens=6)
    jeng = JaxEngine(jparams, cfg, batch_size=3, eos_token=-1, prefix_cache=True)
    jwant = jeng.generate(prompts, max_new_tokens=6)
    assert eng.prefix_stats["prefix_len"] == len(PREFIX) - 1 and eng.prefix_stats == jeng.prefix_stats
    assert _tokens(got) == _tokens(want)
    _hold_to_jax(cfg, jparams, got, jwant, {-1})


def test_prefix_with_kv_quant(setup):
    """int8 KV: the saved prefix carries the scale planes; the plain int8-KV
    Engine's tokens and logprobs."""
    _, _, tcfg, tparams = setup
    cfg8 = dataclasses.replace(tcfg, kv_quant=True)
    prompts = _prompts(4)
    want = Engine(tparams, cfg8, batch_size=2, eos_token=-1, device="cpu").generate(
        prompts, max_new_tokens=6, return_logprobs=True)
    eng = Engine(tparams, cfg8, batch_size=2, eos_token=-1, prefix_cache=True, device="cpu")
    got = eng.generate(prompts, max_new_tokens=6, return_logprobs=True)
    assert set(eng._prefix_saved[1]) == {"k", "v", "k_scale", "v_scale"}
    assert _tokens(got) == _tokens(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)


@pytest.mark.parametrize("draft", [False, True], ids=["prompt-lookup", "draft-model"])
def test_prefix_with_speculative(setup, draft):
    """prefix_cache with spec_k (prompt lookup, or a draft model whose cache
    takes the full prompts): the plain Engine's tokens."""
    _, _, tcfg, tparams = setup
    prompts = _prompts(4)
    want = Engine(tparams, tcfg, batch_size=2, eos_token=-1, device="cpu").generate(prompts, max_new_tokens=10)
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, prefix_cache=True, spec_k=3, device="cpu",
                 draft=(tparams, tcfg) if draft else None)
    eng.spec_min_accept = 0.0
    got = eng.generate(prompts, max_new_tokens=10)
    assert eng.prefix_stats["prefix_len"] == len(PREFIX) and eng.spec_stats["steps"] > 0
    assert _tokens(got) == _tokens(want)


@pytest.mark.parametrize("spec_k, kv_quant", [(0, False), (3, False), (0, True)])
def test_request_admitted_into_an_idle_slot(setup, spec_k, kv_quant):
    """Two prompts through three slots, so one slot sits idle (riding decode
    frozen at position 0, or verifying at 0..spec_k) until a request
    extending the prefix is admitted mid-call: its tokens and logprobs are
    its tokens alone, without the cache; a prompt off the prefix is not
    admissible to the call."""
    _, _, tcfg, tparams = setup
    cfg = dataclasses.replace(tcfg, kv_quant=kv_quant)
    late = PREFIX + [40, 41, 42, 43]
    solo = Engine(tparams, cfg, batch_size=3, eos_token=-1, device="cpu").generate(
        [late], max_new_tokens=12, return_logprobs=True)[0]
    eng = Engine(tparams, cfg, batch_size=3, eos_token=-1, prefix_cache=True, spec_k=spec_k, decode_chunk=2,
                 device="cpu")
    eng.spec_min_accept = 0.0
    calls, features = [], []

    def admit(f):
        calls.append(1)
        features.append(f)
        return [(late, None, None)] if len(calls) == 3 else []

    admit.peek = lambda: len(calls) < 3
    res = eng.generate(_prompts(2), max_new_tokens=12, admit=admit, return_logprobs=True)
    assert len(res) == 3 and features[0]["prefix"] == tuple(PREFIX)
    assert res[2].tokens == solo.tokens
    np.testing.assert_allclose(res[2].logprobs, solo.logprobs, atol=1e-5)
    assert eng.spec_stats["steps"] > 0 if spec_k else eng.spec_stats["steps"] == 0
    assert not Engine.admissible(features[0], [9] + PREFIX, eng.sampling)
    assert not Engine.admissible(features[0], list(PREFIX), eng.sampling)
    assert Engine.admissible(features[0], PREFIX + [1], eng.sampling)


def test_the_reference_admitted_request_reads_idle_writes(setup):
    """The fault of the reference that the port does not copy (ROADMAP §3):
    the same admission through the JAX prefix Engine gives the admitted
    request log-probabilities off its run alone by more than LOGIT_TOL
    (an idle slot's frozen decode wrote its position 0, inside the
    prefix, and the continuation never rewrites it)."""
    cfg, jparams, _, _ = setup
    late = PREFIX + [40, 41, 42, 43]
    solo = JaxEngine(jparams, cfg, batch_size=3, eos_token=-1).generate([late], max_new_tokens=12,
                                                                         return_logprobs=True)[0]
    calls = []

    def admit(f):
        calls.append(1)
        return [(late, None, None)] if len(calls) == 3 else []

    admit.peek = lambda: len(calls) < 3
    eng = JaxEngine(jparams, cfg, batch_size=3, eos_token=-1, prefix_cache=True, decode_chunk=2)
    got = eng.generate(_prompts(2), max_new_tokens=12, admit=admit, return_logprobs=True)[2]
    assert np.abs(np.asarray(got.logprobs) - np.asarray(solo.logprobs)).max() > 0.2


def test_lora_bank_refused_with_prefix_cache(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="not composable"):
        Engine(tparams, tcfg, prefix_cache=True, lora_bank=object(), device="cpu")
