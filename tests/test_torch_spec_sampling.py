"""Speculative decoding under stochastic sampling in the port (rejection
sampling, ``spec_verify_sampled`` and the sampled chunks) on the CPU.

With a stub forward whose logits are fixed, the token emitted at a verify
round's first position (the draft if accepted, a residual draw if not) is
distributed as the row's filtered distribution, computed by the JAX
package's ``filter_logits_batched``; so is the first token of every round
of a sampled chunk.  Draws are many rows of one call (each row's noise is
its own), and the empirical distribution is held to ``TV_LIMIT`` in total
variation (the JAX package's ``tests/test_spec_sampling.py`` holds 4,000
draws per token within 0.04).  Greedy rows reduce to the argmax rule; a
collapsed row (top_k 1) accepts its argmax drafts and rejects others.  In
the Engine: a deterministic stochastic setting and the greedy row of a
mixed batch keep the plain Engine's tokens; stochastic waves run the
sampled chunks; a penalty, a seed, a logit bias, top logprobs or a
dynamic row leave the call to plain decode, token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve import sampling as jsampling
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy
from nf4_tpu_torch.serve import engine as engine_mod
from nf4_tpu_torch.serve import speculative as spec
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import BatchedSampling, KeyStream, SamplingParams

# Total-variation limit of an empirical distribution of DRAWS samples over
# a few tokens: about 4x its standard deviation there.
DRAWS, TV_LIMIT = 20000, 0.02
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5, 6]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stub(logits):
    """A verify forward returning fixed logits [B, k+1, V]."""
    def fwd(params, tokens, cache, positions, seq_lens):
        return logits, cache
    return fwd


def _target(row, sp: SamplingParams) -> np.ndarray:
    """The row's filtered sampling distribution, by the JAX package."""
    bp = jsampling.BatchedSampling.stack([jsampling.SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                                                                   top_p=sp.top_p, min_p=sp.min_p)])
    return np.asarray(jax.nn.softmax(jsampling.filter_logits_batched(jnp.asarray([row], jnp.float32), bp)))[0]


def _tv(tokens, p) -> float:
    freq = np.bincount(np.asarray(tokens).ravel(), minlength=len(p)) / np.asarray(tokens).size
    return 0.5 * float(np.abs(freq - p).sum())


ROW = [1.2, 0.3, -0.5, 0.8, -1.0, 0.1]


@pytest.mark.parametrize("sp, draft", [
    (SamplingParams(temperature=1.0), 2),  # a low-probability draft
    (SamplingParams(temperature=1.0), 0),  # the likeliest draft
    (SamplingParams(temperature=0.7, top_k=4), 3),
    (SamplingParams(temperature=1.3, top_p=0.8, min_p=0.05), 5),  # a draft the filter removes
])
def test_first_position_marginal_is_the_filtered_distribution(sp, draft):
    k, v = 1, len(ROW)
    logits = torch.tensor(ROW).expand(DRAWS, k + 1, v)
    bp = BatchedSampling.stack([sp] * DRAWS, "cpu")
    drafts = torch.full((DRAWS, k), draft, dtype=torch.int32)
    zeros = torch.zeros(DRAWS, dtype=torch.int32)
    key = KeyStream(7, "cpu").next()
    targets, accepted, _, _ = spec.spec_verify_sampled(None, zeros, drafts, None, zeros, key, bp, fwd=_stub(logits),
                                                       k=k)
    assert _tv(targets[:, 0].numpy(), _target(ROW, sp)) <= TV_LIMIT
    assert (accepted.numpy() <= k).all() and ((targets[:, 0] == draft) == (accepted == 1)).all()


def test_every_round_marginal_of_a_sampled_chunk():
    """spec_chunk_sampled chains rounds with one key each: the first emitted
    token of every round is distributed as p."""
    k, v, n_steps = 2, len(ROW), 3
    sp = SamplingParams(temperature=0.9, top_k=5)
    logits = torch.tensor(ROW).expand(DRAWS, k + 1, v)
    bp = BatchedSampling.stack([sp] * DRAWS, "cpu")
    hist = torch.zeros((DRAWS, 32), dtype=torch.int32)
    zeros = torch.zeros(DRAWS, dtype=torch.int32)
    keys = KeyStream(3, "cpu")
    targets, accepted, _, _, _, tok, pos = spec.spec_chunk_sampled(
        None, zeros, hist, None, zeros, keys, bp, fwd=_stub(logits), k=k, n_steps=n_steps)
    assert int(keys.counter) == n_steps  # one key per round
    p = _target(ROW, sp)
    for step in range(n_steps):
        assert _tv(targets[step, :, 0].numpy(), p) <= TV_LIMIT, step
    assert torch.equal(pos, (accepted + 1).sum(0).to(torch.int32))


def _greedy_targets(logits):
    return torch.argmax(logits, -1).to(torch.int32)


def test_greedy_rows_reduce_to_the_argmax_rule():
    """Greedy rows through the sampled verify: the greedy verify's accept
    counts and emitted tokens; greedy rows of a chunk emit the argmax at
    every position of every round."""
    b, k, v = 3, 4, 16
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((b, k + 1, v), generator=gen) * 2
    am = _greedy_targets(logits)
    drafts = am[:, :-1].clone()
    drafts[1, 2] = (drafts[1, 2] + 1) % v
    zeros = torch.zeros(b, dtype=torch.int32)
    bp = BatchedSampling.stack([SamplingParams()] * b, "cpu")
    t, a, _, _ = spec.spec_verify_sampled(None, zeros, drafts, None, zeros, KeyStream(0, "cpu").next(), bp,
                                          fwd=_stub(logits), k=k)
    tg, ag, _, _ = spec.spec_verify(None, zeros, drafts, None, zeros, fwd=_stub(logits), k=k)
    assert a.tolist() == ag.tolist() == [k, 2, k]
    for r in range(b):
        assert t[r, : a[r] + 1].tolist() == tg[r, : ag[r] + 1].tolist()
    row = torch.tensor([[0.1, 2.0, -1.0, 0.5, 0.0]]).expand(1, 3, 5)
    out = spec.spec_chunk_sampled(None, zeros[:1], torch.zeros((1, 32), dtype=torch.int32), None, zeros[:1],
                                  KeyStream(0, "cpu"), BatchedSampling.stack([SamplingParams()], "cpu"),
                                  fwd=_stub(row), k=2, n_steps=3)
    for step in range(3):
        assert (out[0][step, 0, : out[1][step, 0] + 1] == 1).all()
    assert int(out[5][0]) == 1


@pytest.mark.parametrize("wrong", [False, True])
def test_collapsed_rows(wrong):
    """top_k 1 at temperature 1: p is a point mass on the argmax, so argmax
    drafts are always accepted (the bonus is the argmax), and a wrong
    first draft is always rejected for the argmax."""
    b, k, v = 3, 4, 16
    logits = torch.randn((b, k + 1, v), generator=torch.Generator().manual_seed(1)) * 2
    am = _greedy_targets(logits)
    drafts = am[:, :-1].clone()
    if wrong:
        drafts[:, 0] = (drafts[:, 0] + 1) % v
    zeros = torch.zeros(b, dtype=torch.int32)
    bp = BatchedSampling.stack([SamplingParams(temperature=1.0, top_k=1)] * b, "cpu")
    keys = KeyStream(5, "cpu")
    for _ in range(5):
        t, a, _, _ = spec.spec_verify_sampled(None, zeros, drafts, None, zeros, keys.next(), bp, fwd=_stub(logits), k=k)
        if wrong:
            assert a.tolist() == [0] * b and torch.equal(t[:, 0], am[:, 0])
        else:
            assert a.tolist() == [k] * b and torch.equal(t, am)


@pytest.fixture(scope="module")
def tiny():
    cfg = jconfigs.TINY_TEST
    tcfg = config_from_dict(config_to_dict(cfg))
    return tcfg, params_from_numpy(jax.tree.map(np.asarray, jllama.init_params(cfg, seed=0)), tcfg, device="cpu")


def _engine(tiny, spec_k=0, **kw):
    tcfg, tparams = tiny
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu", spec_k=spec_k, **kw)
    eng.spec_min_accept = 0.0
    return eng


def test_deterministic_sampling_keeps_the_plain_tokens(tiny):
    """temperature 1 with top_k 1 is the argmax: the speculative Engine's
    tokens are the plain Engine's, through the sampled chunks."""
    sp = SamplingParams(temperature=1.0, top_k=1)
    want = _engine(tiny).generate(PROMPTS, max_new_tokens=10, sampling=sp)
    eng = _engine(tiny, 3)
    assert [r.tokens for r in eng.generate(PROMPTS, max_new_tokens=10, sampling=sp)] == [r.tokens for r in want]
    assert eng.spec_stats["steps"] > 0


def test_stochastic_waves_run_the_sampled_chunks(tiny, monkeypatch):
    """A mixed batch (greedy and stochastic rows) runs the sampled chunks;
    the greedy row keeps its plain tokens, every row its budget."""
    calls = []
    real = engine_mod.spec_chunk_sampled
    monkeypatch.setattr(engine_mod, "spec_chunk_sampled", lambda *a, **kw: calls.append(kw["n_steps"]) or real(*a, **kw))
    want = _engine(tiny).generate(PROMPTS, max_new_tokens=17)
    eng = _engine(tiny, 3)
    got = eng.generate(PROMPTS, max_new_tokens=17, sampling=[SamplingParams(), SamplingParams(temperature=0.9)])
    assert got[0].tokens == want[0].tokens and all(len(r.tokens) == 17 for r in got)
    assert calls and eng.spec_stats["emitted"] >= eng.spec_stats["steps"] > 0


@pytest.mark.parametrize("sp", [
    SamplingParams(repetition_penalty=2.0),
    SamplingParams(temperature=0.8, presence_penalty=0.5),
    SamplingParams(temperature=0.8, frequency_penalty=0.5),
    SamplingParams(temperature=0.8, seed=11),
    SamplingParams(logit_bias=((7, -100.0),)),
    SamplingParams(top_logprobs=2),
    SamplingParams(min_new_tokens=30),
], ids=["repetition", "presence", "frequency", "seed", "bias", "top_logprobs", "min_new_tokens"])
def test_opt_outs_leave_the_call_to_plain_decode(tiny, sp):
    """An active request with a penalty, a seed, a logit bias, top logprobs
    or a dynamic row: no verify round runs, and the tokens are the plain
    Engine's (the same schedule, so the same draws)."""
    sps = [SamplingParams(), sp]
    want = _engine(tiny).generate(PROMPTS, max_new_tokens=8, sampling=sps)
    eng = _engine(tiny, 3)
    got = eng.generate(PROMPTS, max_new_tokens=8, sampling=sps)
    assert [r.tokens for r in got] == [r.tokens for r in want] and eng.spec_stats["steps"] == 0
