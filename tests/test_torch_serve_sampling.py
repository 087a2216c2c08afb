"""The port's Engine with per-request sampling, logprobs, streaming,
cancellation and admission, against ``nf4_tpu.serve.engine.Engine`` on the
CPU (the cases of ``tests/test_per_request_sampling.py``,
``test_penalties.py``, ``test_top_logprobs.py``, ``test_cancel.py`` and
``test_admission.py``).

Greedy rows (plain, penalized or biased) follow ``test_torch_engine.py``'s
rule: the port's tokens equal the JAX Engine's up to the first step whose
top-2 gap in the JAX logits, with that row's penalties and bias applied, is
within LOGIT_TOL (the port rounds weights to bf16, JAX's CPU path does
not).  Logprobs and top logprobs are held within LOGIT_TOL up to that step.
Stochastic rows cannot reproduce ``jax.random``'s bits: their distribution
is held in ``test_torch_sampling.py``; here a seeded request's tokens must
not depend on its batchmates, the decode chunk, the pipeline or the Engine.
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
from nf4_tpu.serve import sampling as jsampling
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy
from nf4_tpu_torch.parallel.mesh import Mesh
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import SamplingParams
from _torch_threads import _one_thread  # noqa: F401

LOGIT_TOL = 0.2  # test_torch_engine.py's


@pytest.fixture(scope="module")
def models():
    cfg = jconfigs.TINY_TEST
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _j(sp):
    """The JAX package's SamplingParams of the same fields (one or a list)."""
    if isinstance(sp, list):
        return [_j(p) for p in sp]
    return jsampling.SamplingParams(**dataclasses.asdict(sp))


def _engine(models, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("eos_token", -1)
    return Engine(models[3], models[2], device="cpu", **kw)


def _adjusted(row, sp, emitted):
    """The JAX package's penalties and bias on one fp32 logit row, for the
    tokens ``emitted`` before this step."""
    row = row.copy()
    counts = np.bincount(np.asarray(emitted, np.int64), minlength=row.size).astype(np.float32)
    seen = counts > 0
    if sp.repetition_penalty != 1.0:
        pen = np.where(row > 0, row / sp.repetition_penalty, row * sp.repetition_penalty)
        row = np.where(seen, pen, row)
    row = row - (sp.presence_penalty * seen + sp.frequency_penalty * counts)
    for t, b in sp.logit_bias:
        row[t] += b
    return row


def _jax_rows(models, prompt, tokens):
    cfg, params = models[0], models[1]
    seq = list(prompt) + list(tokens)
    logits, _ = jllama.prefill(params, cfg, jnp.asarray([seq], jnp.int32))
    return np.asarray(logits[0], np.float32)[len(prompt) - 1:]


def _agree_until_near_tie(models, got, want, sp=SamplingParams()):
    """Equal up to the first step whose adjusted JAX top-2 gap is within
    LOGIT_TOL; returns that step (or the length)."""
    rows = _jax_rows(models, want.prompt, want.tokens)
    for i, (g, w) in enumerate(zip(got.tokens, want.tokens)):
        if g != w:
            top2 = np.sort(_adjusted(rows[i], sp, want.tokens[:i] if i else []))[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL, f"diverged at step {i} where JAX's choice was clear"
            return i
    assert len(got.tokens) == len(want.tokens)
    return len(got.tokens)


def test_mixed_call_greedy_rows_match_jax_engine(models):
    """Greedy rows (plain, penalized, biased) next to a stochastic one
    give the JAX Engine's tokens; the first token of a penalized row is
    unpenalized (nothing emitted yet), as there."""
    cfg, params = models[0], models[1]
    prompts = [[3, 5, 7], [2, 4, 6, 8], [9, 1, 6], [11, 12]]
    probe = _engine(models).generate(prompts[3:], max_new_tokens=2)[0].tokens
    sps = [SamplingParams(), SamplingParams(temperature=1.0, top_k=20),
           SamplingParams(repetition_penalty=1.5, presence_penalty=0.3, frequency_penalty=0.2),
           SamplingParams(logit_bias=((probe[1], -100.0), (17, 0.5)))]
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4).generate(
        prompts, max_new_tokens=8, sampling=_j(sps))
    got = _engine(models, decode_chunk=4).generate(prompts, max_new_tokens=8, sampling=sps)
    for i in (0, 2, 3):
        _agree_until_near_tie(models, got[i], want[i], sps[i])
    assert probe[1] not in got[3].tokens
    assert len(got[1].tokens) == 8 and all(0 <= t < cfg.vocab_size for t in got[1].tokens)


def test_logprobs_and_top_logprobs_match_jax(models):
    cfg, params = models[0], models[1]
    prompts = [[1, 2, 3, 4], [5, 6]]
    sp = SamplingParams(top_logprobs=3)
    kw = dict(max_new_tokens=6, sampling=sp, return_logprobs=True)
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4).generate(prompts, **dict(kw, sampling=_j(sp)))
    got = _engine(models, decode_chunk=4).generate(prompts, **kw)
    for g, w in zip(got, want):
        assert len(g.logprobs) == len(g.tokens) and len(g.top_logprobs) == len(g.tokens)
        for tok, lp, row in zip(g.tokens, g.logprobs, g.top_logprobs):
            assert row[0][0] == tok and abs(row[0][1] - lp) <= 1e-6 * max(1.0, abs(lp))
            assert [v for _, v in row] == sorted((v for _, v in row), reverse=True)
        n = _agree_until_near_tie(models, g, w)
        for i in range(n):
            assert abs(g.logprobs[i] - w.logprobs[i]) <= LOGIT_TOL
            vals = [v for _, v in w.top_logprobs[i]]
            for j, ((gt, gv), (wt, wv)) in enumerate(zip(g.top_logprobs[i], w.top_logprobs[i])):
                assert abs(gv - wv) <= LOGIT_TOL
                gaps = [vals[j - 1] - vals[j]] if j else []
                gaps += [vals[j] - vals[j + 1]] if j + 1 < len(vals) else []
                if min(gaps) > LOGIT_TOL:
                    assert gt == wt, (i, j)


def test_per_request_top_logprobs_k(models):
    res = _engine(models).generate([[1, 2, 3], [4, 5, 6]], max_new_tokens=4,
                                   sampling=[SamplingParams(top_logprobs=4), SamplingParams()])
    assert all(len(row) == 4 for row in res[0].top_logprobs) and res[1].top_logprobs is None
    assert res[0].logprobs is None


SEEDED = SamplingParams(temperature=1.2, top_p=0.95, seed=123)


@pytest.fixture(scope="module")
def seeded_alone(models):
    return _engine(models, batch_size=1, decode_chunk=1, seed=5).generate([[3, 5, 7]], max_new_tokens=12,
                                                                            sampling=SEEDED)[0].tokens


@pytest.mark.parametrize("chunk, pipelined", [(1, True), (4, True), (4, False), (8, True), (8, False)])
def test_seeded_stream_independent_of_batch_chunk_pipeline_engine(models, seeded_alone, chunk, pipelined):
    """A seeded request's tokens equal its run alone on another Engine
    (another engine seed), batched beside stochastic and penalized
    requests, at any decode chunk, pipelined or not."""
    eng = _engine(models, batch_size=3, decode_chunk=chunk, pipeline_decode=pipelined, seed=chunk * 10 + pipelined)
    res = eng.generate([[2, 4, 6], [3, 5, 7], [8, 9]], max_new_tokens=12,
                       sampling=[SamplingParams(temperature=0.8), SEEDED,
                                 SamplingParams(temperature=0.9, presence_penalty=0.4)])
    assert res[1].tokens == seeded_alone
    assert len(set(seeded_alone)) > 3


def test_seeded_request_independent_of_a_longer_batchmate(models, monkeypatch):
    """At the default kv bucket a batchmate whose prompt reaches past the
    first key block raises every chunk's kv_len (1024 against 512); the
    seeded request's tokens and logprobs are the same bits as alone, at
    decode_chunk 8 pipelined and 4 not.  (On the CPU torch's sums add the
    masked slots' exact zeros in place; the card's version of this test is
    in test_torch_cuda.py.)"""
    from nf4_tpu_torch.serve.engine import Decoder

    cfg = dataclasses.replace(models[2], max_seq_len=1280)
    seen = []
    launch = Decoder.launch

    def spy(self, n, kv_len, *a, **kw):
        seen.append(kv_len)
        return launch(self, n, kv_len, *a, **kw)

    monkeypatch.setattr(Decoder, "launch", spy)
    rng = np.random.default_rng(11)
    mate = [int(t) for t in rng.integers(1, cfg.vocab_size, 600)]

    def run(prompts, chunk, pipelined):
        seen.clear()
        eng = Engine(models[3], cfg, batch_size=2, eos_token=-1, device="cpu", decode_chunk=chunk,
                     pipeline_decode=pipelined)
        sps = [SEEDED, SamplingParams(temperature=0.7)][: len(prompts)]
        res = eng.generate(prompts, max_new_tokens=16, sampling=sps, return_logprobs=True)[0]
        return res, max(seen)

    alone, kv_alone = run([[3, 5, 7]], 8, True)
    assert kv_alone == 512 and len(set(alone.tokens)) > 3
    for chunk, pipelined in ((8, True), (4, False)):
        beside, kv = run([[3, 5, 7], mate], chunk, pipelined)
        assert kv == 1024
        assert beside.tokens == alone.tokens and beside.logprobs == alone.logprobs


def test_unseeded_streams_differ_and_same_seed_agrees(models):
    eng = _engine(models)
    res = eng.generate([[3, 5, 7], [3, 5, 7]], max_new_tokens=16,
                       sampling=[SamplingParams(temperature=2.0, seed=1), SamplingParams(temperature=2.0, seed=2)])
    assert res[0].tokens != res[1].tokens
    res = eng.generate([[3, 5, 7], [3, 5, 7]], max_new_tokens=10, sampling=SamplingParams(temperature=1.0, seed=42))
    assert res[0].tokens == res[1].tokens
    res = eng.generate([[3, 5, 7], [3, 5, 7]], max_new_tokens=16, sampling=SamplingParams(temperature=2.0))
    assert res[0].tokens != res[1].tokens


def test_second_generate_on_one_engine(models):
    """The Engine keeps its cache between calls: a second call of the same
    greedy and seeded requests (other rows left in the cache) gives the
    same tokens."""
    eng = _engine(models, batch_size=3, decode_chunk=4)
    prompts = [list(range(3, 40)), [3, 5, 7], [9, 8]]
    sps = [SamplingParams(), SEEDED, SamplingParams(repetition_penalty=1.4)]
    first = eng.generate(prompts, max_new_tokens=12, sampling=sps)
    eng.generate([list(range(60, 110))] * 3, max_new_tokens=8)  # other rows into every slot
    again = eng.generate(prompts, max_new_tokens=12, sampling=sps)
    assert [r.tokens for r in again] == [r.tokens for r in first]


class TestChoicesMinTokensStops:
    def test_greedy_choice(self, models):
        free = _engine(models, batch_size=1).generate([[1, 2, 3]], max_new_tokens=6)[0].tokens
        choices = ((7, 8, 9), (7, 8, 10, 11), (12,))
        assert tuple(free[:3]) not in choices
        res = _engine(models, batch_size=1).generate([[1, 2, 3]], max_new_tokens=2,
                                                     sampling=SamplingParams(choices=choices))[0]
        assert tuple(res.tokens) in choices and res.finished

    def test_shared_prefix_choice_ends_at_first_match(self, models):
        res = _engine(models, batch_size=1).generate([[1, 2, 3]], max_new_tokens=8,
                                                     sampling=SamplingParams(choices=((5, 6), (5, 6, 7))))[0]
        assert tuple(res.tokens) == (5, 6)

    def test_stochastic_choices(self, models):
        choices = ((4, 5), (6,), (7, 8, 9))
        for seed in range(4):
            res = _engine(models, batch_size=1).generate(
                [[2, 3]], max_new_tokens=6, sampling=SamplingParams(temperature=1.0, seed=seed, choices=choices))[0]
            assert tuple(res.tokens) in choices, (seed, res.tokens)

    def test_choice_with_a_stop_token_and_min_tokens(self, models):
        got = []
        res = _engine(models, batch_size=1, eos_token=7).generate(
            [[1, 2, 3]], max_new_tokens=4, sampling=SamplingParams(choices=((7, 9),), min_new_tokens=2),
            on_token=lambda r, t: got.append(t))[0]
        assert tuple(res.tokens) == (7, 9) and res.finished and got == [7, 9]

    def test_min_tokens_overrides_instant_eos(self, models):
        eos = _engine(models, batch_size=1).generate([[1, 2, 3]], max_new_tokens=1)[0].tokens[0]
        short = _engine(models, batch_size=1, eos_token=eos).generate([[1, 2, 3]], max_new_tokens=8)[0]
        assert short.tokens == [] and short.finished
        res = _engine(models, batch_size=1, eos_token=eos).generate(
            [[1, 2, 3]], max_new_tokens=8, sampling=SamplingParams(min_new_tokens=4))[0]
        assert len(res.tokens) >= 4 and eos not in res.tokens[:4]
        lifted = _engine(models, batch_size=1, eos_token=eos).generate(
            [[1, 2, 3]], max_new_tokens=16, sampling=SamplingParams(min_new_tokens=2))[0]
        assert lifted.finished and 2 <= len(lifted.tokens) < 16

    def test_min_tokens_chunked_equals_single_steps(self, models):
        eos = _engine(models, batch_size=1).generate([[1, 2, 3]], max_new_tokens=1)[0].tokens[0]
        sp = [SamplingParams(min_new_tokens=3), SamplingParams()]
        fast = _engine(models, eos_token=eos, decode_chunk=2).generate([[1, 2, 3], [5, 6, 7]], max_new_tokens=6,
                                                                      sampling=sp)
        slow = _engine(models, eos_token=eos, decode_chunk=1).generate([[1, 2, 3], [5, 6, 7]], max_new_tokens=6,
                                                                      sampling=sp)
        assert [r.tokens for r in fast] == [r.tokens for r in slow] and len(fast[0].tokens) >= 3

    def test_per_request_budgets_and_stops(self, models):
        prompts = [[10 + i, 20 + i, 3] for i in range(5)]
        budgets = [2, 7, 3, 9, 5]
        whole = {b: _engine(models, decode_chunk=4).generate(prompts, max_new_tokens=b) for b in set(budgets)}
        res = _engine(models, decode_chunk=4).generate(
            prompts, max_new_tokens=64, sampling=[SamplingParams(max_new_tokens=b) for b in budgets])
        for i, b in enumerate(budgets):
            assert res[i].tokens == whole[b][i].tokens and len(res[i].tokens) == b
        base = whole[9]
        stop = base[0].tokens[2]
        cut = base[0].tokens.index(stop)
        res = _engine(models).generate(prompts[:2], max_new_tokens=9,
                                       sampling=[SamplingParams(stop_tokens=(stop,)), SamplingParams()])
        assert res[0].tokens == base[0].tokens[:cut] and res[0].finished and res[1].tokens == base[1].tokens

    def test_requests_ended_by_their_first_token(self, models):
        """A request refilled mid-call whose prefill token ends it (a budget
        of 1, a one-token choice, a stop token) retires before any decode
        step (the JAX Engine decodes it once more)."""
        eng = _engine(models, batch_size=1)
        firsts = [r.tokens[0] for r in eng.generate([[1, 2, 3], [4, 5, 6, 7]], max_new_tokens=1)]
        res = eng.generate([[1, 2, 3], [4, 5, 6, 7]], max_new_tokens=1)
        assert [r.tokens for r in res] == [[firsts[0]], [firsts[1]]]
        res = eng.generate([[1, 2, 3], [4, 5, 6, 7]], max_new_tokens=3,
                           sampling=[SamplingParams(), SamplingParams(choices=((firsts[1],), (9, 9)))])
        assert res[1].tokens == [firsts[1]] and res[1].finished
        res = eng.generate([[1, 2, 3], [4, 5, 6, 7]], max_new_tokens=3,
                           sampling=[SamplingParams(), SamplingParams(stop_tokens=(firsts[1],))])
        assert res[1].tokens == [] and res[1].finished


class TestPenalties:
    def test_presence_penalty_forbids_repeats(self, models):
        res = _engine(models, batch_size=1).generate([[1, 2, 3]], max_new_tokens=20,
                                                     sampling=SamplingParams(presence_penalty=1000.0))[0]
        assert len(set(res.tokens)) == len(res.tokens)

    def test_logit_bias_forces(self, models):
        res = _engine(models, batch_size=1).generate([[1, 2, 3]], max_new_tokens=6,
                                                     sampling=SamplingParams(logit_bias=((42, 1000.0),)))[0]
        assert res.tokens == [42] * 6

    def test_counts_reset_on_refill(self, models):
        sp = SamplingParams(frequency_penalty=0.8)
        fresh = [_engine(models, batch_size=1).generate([p], max_new_tokens=6, sampling=sp)[0].tokens
                 for p in ([1, 2, 3], [4, 5])]
        res = _engine(models, batch_size=1).generate([[1, 2, 3], [4, 5]], max_new_tokens=6, sampling=sp)
        assert [r.tokens for r in res] == fresh

    @pytest.mark.parametrize("mask", ["bool", "counts"])
    def test_dropped_chunk_restores_the_mask(self, models, mask):
        """A stop inside a chunk drops the chunk launched ahead of it, whose
        tokens were already recorded in the emitted-token state: pipelined
        and unpipelined give the same tokens."""
        sp = SamplingParams(repetition_penalty=1.6) if mask == "bool" else SamplingParams(frequency_penalty=0.6)
        prompts = [[1, 2, 3], [7, 8, 9, 10]]
        ref = _engine(models, decode_chunk=4, pipeline_decode=False).generate(prompts, max_new_tokens=30,
                                                                             sampling=sp)
        toks = ref[0].tokens
        i = next(i for i in range(5, 20) if i % 4 and toks[i] not in toks[:i])
        kw = dict(max_new_tokens=30, sampling=[SamplingParams(**{**sp.__dict__, "stop_tokens": (toks[i],)}), sp])
        pipe = _engine(models, decode_chunk=4)
        got = pipe.generate(prompts, **kw)
        want = _engine(models, decode_chunk=4, pipeline_decode=False).generate(prompts, **kw)
        assert [r.tokens for r in got] == [r.tokens for r in want] and got[0].tokens == toks[:i]
        assert pipe.pipeline_stats["discarded"] >= 1


class TestStreamingAndCancel:
    def test_on_token_streams_what_the_results_hold(self, models):
        stream = {}
        eng = _engine(models, decode_chunk=4)
        probe = eng.generate([[3, 1, 4]], max_new_tokens=10)[0].tokens
        i = next(i for i in range(3, 10) if probe[i] not in probe[:i])
        res = eng.generate([[3, 1, 4], [1, 5, 9], [2, 6]], max_new_tokens=10, stop_tokens=[probe[i]],
                           sampling=[SamplingParams(), SamplingParams(temperature=0.9), SamplingParams()],
                           on_token=lambda r, t: stream.setdefault(r, []).append(t))
        assert [stream.get(j, []) for j in range(3)] == [r.tokens for r in res]
        assert res[0].finished and stream[0] == probe[:i]

    def test_cancel_mid_decode_and_queued(self, models):
        cancelled = [False]

        def on_token(r, t):
            if r == 0:
                on_token.count += 1
                cancelled[0] = on_token.count >= 3

        on_token.count = 0
        res = _engine(models).generate([[3, 1, 4], [1, 5, 9], [2, 6, 5]], max_new_tokens=40, on_token=on_token,
                                       cancel=lambda r: (r == 0 and cancelled[0]) or r == 2)
        assert not res[0].finished and 3 <= len(res[0].tokens) <= 3 + 8
        assert res[2].tokens == [] and not res[2].finished
        solo = _engine(models).generate([[1, 5, 9]], max_new_tokens=40)[0]
        assert res[1].tokens == solo.tokens

    def test_never_cancelled_is_identity(self, models):
        base = _engine(models).generate([[3, 1, 4], [1, 5, 9]], max_new_tokens=8)
        with_cb = _engine(models).generate([[3, 1, 4], [1, 5, 9]], max_new_tokens=8, cancel=lambda r: False)
        assert [(a.tokens, a.finished) for a in base] == [(b.tokens, b.finished) for b in with_cb]


class TestAdmission:
    def test_admitted_request_token_identical_to_solo(self, models):
        fed = []

        def admit(features):
            if fed:
                return []
            fed.append(features)
            return [([9, 8, 7], SamplingParams(max_new_tokens=6), None)]

        res = _engine(models).generate([[3, 1, 4], [1, 5, 9, 2]], max_new_tokens=4, admit=admit,
                                       sampling=[SamplingParams(max_new_tokens=2), SamplingParams(max_new_tokens=10)])
        assert len(res) == 3 and [len(r.tokens) for r in res] == [2, 10, 6]
        assert res[2].tokens == _engine(models).generate([[9, 8, 7]], max_new_tokens=6)[0].tokens
        assert fed[0]["max_prompt_len"] == models[2].max_seq_len - 1 and not fed[0]["use_mask"]

    def test_admitted_stochastic_request_in_a_greedy_call(self, models):
        """A plain greedy call admits a seeded stochastic request (its
        chunks switch to the per-request body) with its tokens alone."""
        fed = []

        def admit(features):
            if fed:
                return []
            fed.append(True)
            return [([3, 5, 7], SEEDED, None)]

        res = _engine(models, decode_chunk=4).generate([[1, 2], [4, 5, 6]], max_new_tokens=12, admit=admit,
                                                       sampling=[SamplingParams(max_new_tokens=2), SamplingParams()])
        alone = _engine(models, batch_size=1).generate([[3, 5, 7]], max_new_tokens=12, sampling=SEEDED)[0]
        assert res[2].tokens == alone.tokens
        assert res[1].tokens == _engine(models).generate([[4, 5, 6]], max_new_tokens=12)[0].tokens

    def test_peek_admits_mid_run(self, models):
        order, fed, arrived = [], [], []

        def admit(features):
            if fed or not arrived:
                return []
            fed.append(True)
            return [([9, 8, 7], SamplingParams(max_new_tokens=8), None)]

        def peek():
            if not arrived and len(order) >= 4:
                arrived.append(True)
            return bool(arrived) and not fed

        admit.peek = peek
        res = _engine(models, decode_chunk=4).generate([[3, 1, 4]], max_new_tokens=48, admit=admit,
                                                       on_token=lambda r, t: order.append((r, t)))
        assert len(res) == 2 and len(res[1].tokens) == 8
        first_new = next(i for i, (r, _) in enumerate(order) if r != 0)
        assert first_new < max(i for i, (r, _) in enumerate(order) if r == 0)

    def test_inadmissible_request_raises(self, models):
        def admit(features):
            return [([5, 6], SamplingParams(repetition_penalty=1.5), None)]

        with pytest.raises(ValueError, match="admissible"):
            _engine(models).generate([[1, 2]], max_new_tokens=2, admit=admit)

    def test_admissible_agrees_with_jax(self, models):
        """On every ``features`` a port's call makes (an Engine without a
        bank, and one with a bank of 3 adapters; with and without a shared
        prefix), for requests with and without an adapter."""
        base = {"use_mask": False, "use_counts": False, "use_bias": False, "top_lp_k": 0, "return_logprobs": False,
                "max_prompt_len": 63, "prefix": (), "adapters": False, "num_adapters": 0}
        rich = dict(base, use_mask=True, use_counts=True, use_bias=True, top_lp_k=5, return_logprobs=True)
        feats = [base, rich, dict(base, use_counts=True), dict(base, use_mask=True), dict(base, use_bias=True),
                 dict(base, top_lp_k=3), dict(base, prefix=(7, 8)), dict(rich, prefix=(7, 8, 9)),
                 dict(base, adapters=True, num_adapters=3), dict(rich, adapters=True, num_adapters=3)]
        seen = []
        _engine(models).generate([[1, 2]], max_new_tokens=2, admit=lambda f: seen.append(f) or [])
        assert seen and set(seen[0]) == set(base)
        params = [SamplingParams(), SamplingParams(repetition_penalty=1.3), SamplingParams(presence_penalty=0.5),
                  SamplingParams(frequency_penalty=0.1), SamplingParams(logit_bias=((3, 1.0),)),
                  SamplingParams(min_new_tokens=2), SamplingParams(choices=((1,),)), SamplingParams(top_logprobs=3),
                  SamplingParams(top_logprobs=5), SamplingParams(temperature=0.9, seed=1)]
        prompts = [[], [1], [7, 8, 9], [7, 8, 9, 1], list(range(63)), list(range(64))]
        for f in feats:
            for sp in params:
                for prompt in prompts:
                    for kw in ({}, {"logprobs": True}, {"adapter": 0}, {"adapter": 2}, {"adapter": -2}):
                        want = JaxEngine.admissible(f, prompt, _j(sp), **kw)
                        assert Engine.admissible(f, prompt, sp, **kw) == want, (f, sp, prompt, kw)


def test_sampling_argument_checks_and_unported_options(models):
    eng = _engine(models)
    with pytest.raises(ValueError, match="one SamplingParams per prompt"):
        eng.generate([[1, 2], [3, 4]], max_new_tokens=2, sampling=[SamplingParams()])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate([[1, 2]], max_new_tokens=0)
    # Adapters are ported (test_torch_multi_lora.py); they need a bank.
    with pytest.raises(ValueError, match="needs Engine\\(lora_bank"):
        eng.generate([[1, 2]], max_new_tokens=2, adapter=[0])
    with pytest.raises(ValueError, match="needs Engine\\(lora_bank"):
        eng.score([[1, 2]], adapter=[0])
    assert len(eng.score([[1, 2, 3]])[0]) == 2  # scoring and the prefix cache are ported
    assert _engine(models, prefix_cache=True).prefix_cache
    dp_mesh = Mesh(tp=1, dp=2, rank=0, tp_rank=0, dp_rank=0, tp_group=None, dp_group=None,
                   device=torch.device("cpu"), backend="gloo")
    # Data parallelism is ported (test_torch_dp_serve.py); dp must divide the slots.
    assert _engine(models, mesh=dp_mesh, cuda_graphs=False).local_batch == 1
    with pytest.raises(ValueError, match="multiple of the data-parallel degree"):
        _engine(models, mesh=dp_mesh, cuda_graphs=False, batch_size=3)
    with pytest.raises(ValueError, match="stacked bank"):
        _engine(models, lora_bank=object())
    with pytest.raises(ValueError, match="lora_bank is not composable"):
        _engine(models, prefix_cache=True, lora_bank=object())
    # A default of the Engine's own: None entries take it.
    eng = _engine(models, sampling=SamplingParams(max_new_tokens=3))
    res = eng.generate([[1, 2], [3]], max_new_tokens=5, sampling=[None, SamplingParams()])
    assert [len(r.tokens) for r in res] == [3, 5]
