"""The port's speculative Engine (``Engine(spec_k=...)``) on the CPU.

Greedy speculation keeps exactly the tokens the model itself emits, so its
tokens must equal the port's plain Engine's, whatever the drafts: through
a stop token inside a chunk (the chunk launched ahead of it dropped, its
in-place cache and history writes left behind), continuous-batching
refills, budget tails, early retirement (idle slots frozen) and the
pipeline on and off, in the 4-bit and the int8/kv8 modes.  Against the
JAX Engine with ``spec_k=3`` the tokens agree up to the first near-tie
(``test_torch_engine.py``'s rule).  The adaptive controller pauses on low
acceptance and stays token-identical, backs off geometrically, resets
after a good probe, and never pauses at threshold 0.  The JAX package's
``tests/test_speculative.py`` and ``tests/test_spec_chunk.py`` hold the
same cases there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import SamplingParams
from _torch_threads import _one_thread  # noqa: F401

LOGIT_TOL = 0.2  # test_torch_engine.py's: the port rounds weights to bf16
# Mixed lengths, more prompts than slots, repetitive ones (drafts accepted)
# and ordinary ones (drafts rejected).
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2], [4, 5], [9], [7, 8, 7, 8, 7, 8, 7], [10, 11, 12, 13]]
NOVEL = [[11, 23, 5], [17, 3, 29]]  # no self-repetition: prompt lookup rarely hits


@pytest.fixture(scope="module")
def modes():
    """(JAX cfg, JAX params, port cfg, port params) in the 4-bit mode and
    in the int8/kv8 mode."""
    cfg = jconfigs.TINY_TEST
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return {
        "nf4": (cfg, params, tcfg, tparams),
        "int8kv8": (dataclasses.replace(cfg, kv_quant=True), jllama.recode_params_int8(params),
                    dataclasses.replace(tcfg, kv_quant=True), llama.recode_params_int8(tparams)),
    }


def _engine(mode_entry, spec_k=0, min_accept=0.0, batch_size=2, decode_chunk=4, **kw):
    """The port's Engine on the CPU; speculation with the controller's
    threshold ``min_accept`` (0: always speculate)."""
    _, _, tcfg, tparams = mode_entry
    eng = Engine(tparams, tcfg, batch_size=batch_size, eos_token=-1, decode_chunk=decode_chunk, device="cpu",
                 spec_k=spec_k, **kw)
    eng.spec_min_accept = min_accept
    return eng


def _tokens(results):
    return [r.tokens for r in results]


@pytest.fixture(scope="module")
def plain(modes):
    """The plain Engine's greedy tokens of PROMPTS (24 new tokens), per mode."""
    return {m: _engine(modes[m]).generate(PROMPTS, max_new_tokens=24, return_logprobs=True) for m in modes}


@pytest.mark.parametrize("mode", ["nf4", "int8kv8"])
@pytest.mark.parametrize("spec_k", [3, 4])
def test_greedy_spec_token_identical_to_plain(modes, plain, mode, spec_k):
    """Through refills, early finishers and pipelined chunks: the plain
    Engine's tokens, its logprobs within 1e-3, speculation engaged and
    chunks launched ahead."""
    eng = _engine(modes[mode], spec_k)
    got = eng.generate(PROMPTS, max_new_tokens=24, return_logprobs=True)
    assert _tokens(got) == _tokens(plain[mode])
    for g, w in zip(got, plain[mode]):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-3)
    s = eng.spec_stats
    assert s["steps"] > 0 and s["emitted"] > s["steps"] and s["pauses"] == 0
    assert eng.pipeline_stats["launched"] > 0


def test_stop_mid_chunk_drops_the_chunk_ahead(modes):
    """A stop token inside a pipelined chunk retires its slot and drops
    the chunk launched ahead, which wrote K/V and history past the
    consumed state; the other slot continues from that cache and history,
    and every token equals the plain Engine's with the same stop."""
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 7, 5, 6, 7, 5]]
    ref = _engine(modes["nf4"]).generate(prompts, max_new_tokens=40)
    dropped = 0
    for stop in dict.fromkeys(ref[0].tokens[4:16]):  # candidate stops, first occurrences
        eng = _engine(modes["nf4"], 3)
        got = eng.generate(prompts, max_new_tokens=40, stop_tokens=[stop])
        want = _engine(modes["nf4"]).generate(prompts, max_new_tokens=40, stop_tokens=[stop])
        assert _tokens(got) == _tokens(want) and [r.finished for r in got] == [r.finished for r in want]
        dropped += eng.pipeline_stats["discarded"]
        if dropped:
            break
    assert dropped >= 1, "no stop dropped a chunk launched ahead"


def test_budget_tails_and_early_retirement(modes, plain):
    """Per-request budgets that end mid-round (the extra tokens dropped) and
    an early finisher whose slot rides along frozen: each request's tokens
    are its plain ones, cut at its budget."""
    budgets = [3, 24, 7, 13, 1]
    sps = [SamplingParams(max_new_tokens=b) for b in budgets]
    eng = _engine(modes["nf4"], 3)
    got = eng.generate(PROMPTS, max_new_tokens=24, sampling=sps)
    assert _tokens(got) == [w.tokens[:b] for w, b in zip(plain["nf4"], budgets)]
    assert eng.spec_stats["steps"] > 0


def test_pipeline_on_and_off(modes, plain):
    """Pipelined and unpipelined speculation give the same tokens."""
    eng = _engine(modes["nf4"], 3, pipeline_decode=False)
    assert _tokens(eng.generate(PROMPTS, max_new_tokens=24)) == _tokens(plain["nf4"])
    assert eng.pipeline_stats == {"launched": 0, "discarded": 0} and eng.spec_stats["steps"] > 0


def test_device_drafting_accepts_as_host_drafting(modes):
    """The device drafter accepts exactly what the host drafter does on the
    same greedy stream (decode_chunk=1: host-stepped verify rounds)."""
    stats = {}
    for chunk in (1, 4):
        eng = _engine(modes["nf4"], 3, batch_size=1, decode_chunk=chunk)
        eng.generate([[1, 2, 3] * 5], max_new_tokens=40)
        stats[chunk] = dict(eng.spec_stats)
    assert stats[4] == stats[1] and stats[4]["emitted"] > stats[4]["steps"]


def test_against_the_jax_spec_engine(modes):
    """The JAX Engine with spec_k=3 on the same weights and requests: the
    tokens agree up to the first step whose JAX top-2 logit gap is within
    LOGIT_TOL."""
    cfg, params, _, _ = modes["nf4"]
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4, spec_k=3).generate(
        PROMPTS[:3], max_new_tokens=16)
    got = _engine(modes["nf4"], 3, min_accept=0.15).generate(PROMPTS[:3], max_new_tokens=16)
    for g, w in zip(got, want):
        seq = list(w.prompt)
        for a, b in zip(g.tokens, w.tokens):
            if a != b:
                logits, _ = jllama.prefill(params, cfg, jnp.asarray([seq], jnp.int32))
                top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL, "diverged where JAX's choice was clear"
                break
            seq.append(b)
        else:
            assert len(g.tokens) == len(w.tokens)


def test_controller_pauses_on_low_acceptance(modes):
    """Novel prompts: the controller pauses after a failed probe (plain
    chunks serve the cooldown), with the plain tokens, and fewer verify
    rounds than an engine that always speculates."""
    ref = _engine(modes["nf4"]).generate(NOVEL, max_new_tokens=40)
    eng = _engine(modes["nf4"], 3, min_accept=0.15)
    assert _tokens(eng.generate(NOVEL, max_new_tokens=40)) == _tokens(ref)
    always = _engine(modes["nf4"], 3)
    assert _tokens(always.generate(NOVEL, max_new_tokens=40)) == _tokens(ref)
    assert eng.spec_stats["pauses"] >= 1 and always.spec_stats["pauses"] == 0
    assert eng.spec_stats["steps"] < always.spec_stats["steps"]


def test_controller_backs_off_and_resets(modes):
    """An unreachable threshold fails every probe: the cooldown doubles from
    its base to its cap.  A good probe resets it (a periodic prompt)."""
    eng = _engine(modes["nf4"], 3, min_accept=99.0)
    eng.spec_cooldown, eng.spec_cooldown_max = 2, 16
    eng.generate(NOVEL, max_new_tokens=96)
    pauses = eng.spec_stats["pauses"]
    assert pauses >= 2 and eng._spec_backoff == min(16, 2 * 2 ** (pauses - 1))
    good = _engine(modes["nf4"], 3, min_accept=0.15, batch_size=1)
    good._spec_backoff = 16
    good.generate([[1, 2, 3] * 5], max_new_tokens=24)
    assert good.spec_stats["pauses"] == 0 and good._spec_backoff == 0


def test_cancel_under_speculation(modes, plain):
    """A request cancelled while speculative chunks run retires with the
    tokens read before the poll that saw it (a prefix of its plain ones,
    unfinished); the other requests keep their plain tokens."""
    seen = []
    eng = _engine(modes["nf4"], 3)
    got = eng.generate(PROMPTS, max_new_tokens=24, on_token=lambda r, t: seen.append(r),
                       cancel=lambda r: r == 0 and seen.count(0) >= 5)
    assert not got[0].finished and 5 <= len(got[0].tokens) < 24
    assert got[0].tokens == plain["nf4"][0].tokens[: len(got[0].tokens)]
    assert _tokens(got[1:]) == _tokens(plain["nf4"][1:]) and eng.spec_stats["steps"] > 0
