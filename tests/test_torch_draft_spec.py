"""Draft-model speculation in the port (``Engine(draft=(params, cfg))``) on
the CPU.

A small model proposes the drafts greedily over a cache of its own, kept
in lockstep with the target's positions.  The verify keeps the tokens
independent of the draft: greedy waves equal the plain Engine's for any
draft model.  A draft equal to the target accepts all k drafts of every
round.  A low-acceptance draft pauses speculation, its cache falls behind
and catches up by continuation prefills on the next probe; a refilled
slot prefills its prompt into the draft cache.  The JAX package's
``tests/test_draft_spec.py`` holds the same cases there; one run here is
also held to the JAX Engine with the same draft under the near-tie rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import SamplingParams

LOGIT_TOL = 0.2  # test_torch_engine.py's: the port rounds weights to bf16
PROMPTS = [[11, 23, 5], [17, 3, 29]]  # novel text: prompt lookup would not help


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """The JAX target and draft (seeds 0 and 1) and their port copies."""
    cfg = jconfigs.TINY_TEST
    tcfg = config_from_dict(config_to_dict(cfg))
    jp = [jllama.init_params(cfg, seed=s) for s in (0, 1)]
    tp = [params_from_numpy(jax.tree.map(np.asarray, p), tcfg, device="cpu") for p in jp]
    return cfg, jp, tcfg, tp


def _make(models, draft=None, spec_k=3, min_accept=0.0, **kw):
    _, _, tcfg, (target, other) = models
    d = None if draft is None else ({"self": target, "other": other}[draft], tcfg)
    eng = Engine(target, tcfg, batch_size=2, eos_token=-1, decode_chunk=8, device="cpu", draft=d,
                 spec_k=spec_k if d else 0, **kw)
    eng.spec_min_accept = min_accept
    return eng


@pytest.fixture(scope="module")
def plain(models):
    return [r.tokens for r in _make(models).generate(PROMPTS, max_new_tokens=48)]


def test_self_draft_accepts_every_draft(models, plain):
    """Draft == target: every round accepts its k drafts, all 23 tokens per
    request after the prefill's come from verify rounds, in chunks."""
    eng = _make(models, "self", min_accept=0.15)
    got = eng.generate(PROMPTS, max_new_tokens=24)
    assert [r.tokens for r in got] == [p[:24] for p in plain]
    s = eng.spec_stats
    assert s["emitted"] == 2 * 23 and s["pauses"] == 0 and s["steps"] <= 12


def test_any_draft_is_token_identical(models, plain):
    eng = _make(models, "other")
    assert [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=48)] == plain
    assert eng.spec_stats["steps"] > 0


def test_pause_then_catch_up(models, plain, monkeypatch):
    """A low-acceptance draft pauses speculation; plain decode advances the
    target while the draft cache falls behind, and each re-probe first
    prefills the gap into the draft cache (from the stale position): the
    tokens stay the plain ones."""
    starts = []
    real = Engine.prefill_draft

    def spy(self, cache, tokens, lengths, slots, start=None):
        starts.append(None if start is None else list(start))
        return real(self, cache, tokens, lengths, slots, start)

    monkeypatch.setattr(Engine, "prefill_draft", spy)
    eng = _make(models, "other", min_accept=0.5)
    eng.spec_cooldown = 2
    assert [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=48)] == plain
    assert eng.spec_stats["pauses"] >= 1
    assert starts[0] is None and any(s is not None and min(s) > 3 for s in starts[1:]), starts


def test_stop_token_and_budget(models, plain):
    eng = _make(models, "self")
    stop = plain[0][5]
    got = eng.generate(PROMPTS, max_new_tokens=24,
                       sampling=[SamplingParams(stop_tokens=(stop,)), SamplingParams(max_new_tokens=7)])
    assert got[0].tokens == plain[0][: plain[0].index(stop)] and got[0].finished
    assert got[1].tokens == plain[1][:7]


def test_refill_prefills_the_draft_cache(models):
    """A queued request refilling a freed slot prefills its prompt into the
    draft cache; its tokens equal its run alone on a plain Engine."""
    eng = _make(models, "other")
    got = eng.generate(PROMPTS + [[9, 8, 7]], max_new_tokens=20,
                       sampling=[SamplingParams(max_new_tokens=4), SamplingParams(max_new_tokens=20),
                                 SamplingParams(max_new_tokens=12)])
    assert got[2].tokens == _make(models).generate([[9, 8, 7]], max_new_tokens=12)[0].tokens


def test_stochastic_draft_runs_and_repeats_with_its_seed(models):
    sp = SamplingParams(temperature=0.8)
    runs = [_make(models, "other", seed=7).generate(PROMPTS, max_new_tokens=16, sampling=sp) for _ in range(2)]
    assert [r.tokens for r in runs[0]] == [r.tokens for r in runs[1]]
    assert all(len(r.tokens) == 16 for r in runs[0])


def test_against_the_jax_draft_engine(models):
    """The JAX Engine with the same draft: tokens agree up to the first step
    whose JAX top-2 logit gap is within LOGIT_TOL."""
    cfg, (target, other), _, _ = models
    want = JaxEngine(target, cfg, batch_size=2, eos_token=-1, spec_k=3, draft=(other, cfg)).generate(
        PROMPTS, max_new_tokens=12)
    got = _make(models, "other", min_accept=0.15).generate(PROMPTS, max_new_tokens=12)
    for g, w in zip(got, want):
        seq = list(w.prompt)
        for a, b in zip(g.tokens, w.tokens):
            if a != b:
                logits, _ = jllama.prefill(target, cfg, jnp.asarray([seq], jnp.int32))
                top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL, "diverged where JAX's choice was clear"
                break
            seq.append(b)


@pytest.mark.parametrize("kw, match", [
    (dict(spec_k=0), "requires spec_k"),
    (dict(spec_k=16), r"spec_k must be in \[0, 16\)"),
    (dict(spec_k=-1), r"spec_k must be in \[0, 16\)"),
    (dict(vocab_size=99), "vocabulary"),
    (dict(max_seq_len=32), "max_seq_len"),
])
def test_the_arguments_are_checked(models, kw, match):
    _, _, tcfg, (target, _) = models
    spec_k = kw.pop("spec_k", 3)
    dcfg = dataclasses.replace(tcfg, **kw)
    draft = None if spec_k != 0 and match.startswith("spec_k") else (target, dcfg)
    with pytest.raises(ValueError, match=match):
        Engine(target, tcfg, device="cpu", spec_k=spec_k, draft=draft)


def test_draft_cache_follows_its_own_config(models):
    """The draft keeps an int8 KV cache of its own where its config says so
    (a bf16 target): the tokens stay the plain ones."""
    _, _, tcfg, (target, other) = models
    eng = Engine(target, tcfg, batch_size=2, eos_token=-1, device="cpu", spec_k=3,
                 draft=(llama.recode_params_int8(other), dataclasses.replace(tcfg, kv_quant=True)))
    eng.spec_min_accept = 0.0
    want = _make(models).generate(PROMPTS, max_new_tokens=16)
    assert [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=16)] == [r.tokens for r in want]
    _, dec = eng.state()
    assert dec.dcache.k.dtype == torch.int8 and dec.cache.k.dtype == torch.bfloat16
