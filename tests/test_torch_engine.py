"""The port's greedy Engine against ``nf4_tpu.serve.engine.Engine``.

Teacher-forced rule: every token the port emits must be within LOGIT_TOL of
the JAX model's top logit at that step (the JAX logits of the port's own
prompt + tokens), and must BE the JAX argmax wherever the JAX top-2 gap
exceeds LOGIT_TOL.  Against the JAX engine's own output the two token
streams must agree up to the first step whose JAX top-2 gap is within the
tolerance (a near-tie has no canonical winner across programs).
LOGIT_TOL is the forward tolerance of ``test_torch_llama.py``, for the same
reason: the port's projections round weights to bf16, JAX's CPU path does
not.  The same holds in the int8/kv8 serving mode.
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
from nf4_tpu_torch.serve.sampling import BatchedSampling, KeyStream, SamplingParams, sample, sample_batched
from _torch_threads import _one_thread  # noqa: F401

LOGIT_TOL = 0.2


@pytest.fixture(scope="module")
def models():
    cfg = jconfigs.TINY_TEST
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _prompts():
    rng = np.random.default_rng(5)
    return [list(map(int, rng.integers(3, 256, size=n))) for n in (3, 17, 9, 30, 1, 12)]


def _emitted_seq(result, stops):
    """A result's prompt and emitted tokens, the stop token included."""
    seq = list(result.prompt) + list(result.tokens)
    if result.finished:
        seq.append(next(iter(stops)))  # the stop token the port emitted
    return seq


def _jax_logits(cfg, params, seqs):
    """The JAX model's fp32 logits [len(seq), V] of each sequence, from one
    right-padded prefill: causal attention keeps the padding out of every
    real position, so one compiled shape serves them all."""
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        toks[i, : len(s)] = s
    logits, _ = jllama.prefill(params, cfg, jnp.asarray(toks))
    logits = np.asarray(logits, np.float32)
    return [logits[i, : len(s)] for i, s in enumerate(seqs)]


def _teacher_forced(cfg, params, result, stops, logits=None):
    """Check the port's tokens against the JAX logits of its own sequence
    (``logits``: those logits, already computed)."""
    seq = _emitted_seq(result, stops)
    if logits is None:
        logits = _jax_logits(cfg, params, [seq])[0]
    emitted = seq[len(result.prompt):]
    for i, tok in enumerate(emitted):
        row = logits[len(result.prompt) - 1 + i]
        top2 = np.sort(row)[-2:]
        assert row[tok] >= top2[1] - LOGIT_TOL, (i, tok, row[tok], top2[1])
        if top2[1] - top2[0] > LOGIT_TOL:
            assert tok == int(np.argmax(row)), (i, tok)


def _agree_until_near_tie(cfg, params, got, want, logits=None):
    """``logits``: the JAX logits of ``want``'s prompt and tokens, already
    computed (row i predicts the token after position i)."""
    seq = list(want.prompt)
    for g, w in zip(got.tokens, want.tokens):
        if g != w:
            row = _jax_logits(cfg, params, [seq])[0][-1] if logits is None else logits[len(seq) - 1]
            top2 = np.sort(row)[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL, "diverged where JAX's choice was clear"
            return
        seq.append(w)
    assert len(got.tokens) == len(want.tokens) and got.finished == want.finished


def _hold_to_jax(cfg, params, got, want, stops):
    """Both rules for every result: the teacher-forced rule on the port's
    tokens and the near-tie rule against the JAX engine's, with the JAX
    logits of all of them from one padded prefill."""
    seqs = [_emitted_seq(g, stops) for g in got] + [list(w.prompt) + list(w.tokens) for w in want]
    rows = _jax_logits(cfg, params, seqs)
    for i, (g, w) in enumerate(zip(got, want)):
        _teacher_forced(cfg, params, g, stops, rows[i])
        _agree_until_near_tie(cfg, params, g, w, rows[len(got) + i])


@pytest.mark.parametrize("eos_pick", [None, 2])
def test_engine_matches_jax_engine(models, eos_pick):
    """Six prompts of mixed lengths through two slots (so slots refill),
    decode chunks of 4; with ``eos_pick`` the eos token is the JAX engine's
    third token for the first prompt, so that request ends early."""
    cfg, params, tcfg, tparams = models
    prompts = _prompts()
    eos = -1
    if eos_pick is not None:
        probe = JaxEngine(params, cfg, batch_size=2, eos_token=-1).generate(prompts[:1], max_new_tokens=8)
        eos = probe[0].tokens[eos_pick]
    want = JaxEngine(params, cfg, batch_size=2, eos_token=eos, decode_chunk=4).generate(prompts, max_new_tokens=8)
    got = Engine(tparams, tcfg, batch_size=2, eos_token=eos, decode_chunk=4, device="cpu").generate(
        prompts, max_new_tokens=8
    )
    assert [r.prompt for r in got] == prompts
    if eos_pick is not None:
        assert got[0].finished and len(got[0].tokens) <= eos_pick
    for g, w in zip(got, want):
        assert len(g.tokens) <= 8
        _teacher_forced(cfg, params, g, {eos})
        _agree_until_near_tie(cfg, params, g, w)


@pytest.fixture(scope="module")
def int8_models(models):
    """The ``--int8 --kv8`` serving mode: int8-recoded weights, int8 KV cache."""
    cfg, params, tcfg, tparams = models
    return (dataclasses.replace(cfg, kv_quant=True), jllama.recode_params_int8(params),
            dataclasses.replace(tcfg, kv_quant=True), llama.recode_params_int8(tparams))


def test_int8_kv8_engine_matches_jax_engine(int8_models):
    """The int8/kv8 engine against the JAX engine in the same mode, under
    the same teacher-forced rule and tolerance."""
    cfg, params, tcfg, tparams = int8_models
    prompts = _prompts()
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4).generate(prompts, max_new_tokens=8)
    got = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu").generate(
        prompts, max_new_tokens=8
    )
    assert [r.prompt for r in got] == prompts
    for g, w in zip(got, want):
        assert len(g.tokens) == 8
        _teacher_forced(cfg, params, g, {-1})
        _agree_until_near_tie(cfg, params, g, w)


def test_int8_kv8_segmented_prefill_is_invisible(int8_models):
    """With an int8 cache too, segments and slot refills (which gather and
    scatter the scale planes with K/V) do not change greedy output."""
    _, _, tcfg, tparams = int8_models
    prompts = _prompts()
    ref = Engine(tparams, tcfg, batch_size=1, eos_token=-1, decode_chunk=1, device="cpu").generate(
        prompts, max_new_tokens=6
    )
    eng = Engine(tparams, tcfg, batch_size=3, eos_token=-1, decode_chunk=4, device="cpu")
    eng.PREFILL_SEGMENT = 8
    got = eng.generate(prompts, max_new_tokens=6)
    assert [r.tokens for r in got] == [r.tokens for r in ref]


def test_segmented_prefill_and_chunking_are_invisible(models):
    """Greedy output does not depend on the prefill segment length, the
    decode chunk size or the slot count."""
    _, _, tcfg, tparams = models
    prompts = _prompts()
    ref = Engine(tparams, tcfg, batch_size=1, eos_token=-1, decode_chunk=1, device="cpu").generate(
        prompts, max_new_tokens=6
    )
    eng = Engine(tparams, tcfg, batch_size=3, eos_token=-1, decode_chunk=4, device="cpu")
    eng.PREFILL_SEGMENT = 8  # the 30-token prompt (bucket 32) prefills in 4 segments
    got = eng.generate(prompts, max_new_tokens=6)
    assert [r.tokens for r in got] == [r.tokens for r in ref]


def test_stop_tokens_budget_and_bad_prompts(models):
    cfg, _, tcfg, tparams = models
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, device="cpu")
    probe = eng.generate([[5, 6, 7]], max_new_tokens=6)[0]
    stop = probe.tokens[1]
    r = eng.generate([[5, 6, 7]], max_new_tokens=6, stop_tokens=[stop])[0]
    assert r.finished and r.tokens == probe.tokens[:1]
    r = eng.generate([[5, 6, 7]], sampling=SamplingParams(max_new_tokens=2))[0]
    assert r.tokens == probe.tokens[:2] and not r.finished
    rs = eng.generate([[], list(range(cfg.max_seq_len + 5)), [1, 2]], max_new_tokens=3)
    assert [len(x.tokens) for x in rs] == [0, 0, 3]
    # The context limit ends generation.
    r = eng.generate([list(np.arange(cfg.max_seq_len - 3) % cfg.vocab_size)], max_new_tokens=50)[0]
    assert len(r.tokens) <= 3 and not r.finished


def test_greedy_only():
    """Greedy rows take the first index on ties; a stochastic draw needs a
    key, and a seeded row's draw depends on (seed, step) only, not on the
    engine's key stream."""
    logits = torch.tensor([[0.1, 2.0, 2.0], [3.0, -1.0, 0.0]])
    assert sample(logits, SamplingParams()).tolist() == [1, 0]  # first index on ties
    with pytest.raises(ValueError, match="requires a key"):
        sample(logits, SamplingParams(temperature=0.7))
    bp = BatchedSampling.stack([SamplingParams(temperature=0.7, seed=3)] * 2, "cpu")
    steps = torch.tensor([5, 5])
    draws = [sample_batched(logits, bp, KeyStream(seed, "cpu").next(), step_idx=steps).tolist() for seed in (0, 9)]
    assert draws[0] == draws[1]
    assert all(0 <= t < 3 for t in draws[0])
