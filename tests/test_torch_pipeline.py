"""The port's pipelined decode (``Engine(pipeline_decode=True)``) on the CPU.

Chunk c+1 is launched from chunk c's device outputs before chunk c is read
back (``nf4_tpu_torch/serve/engine.py``, ``_Scheduler.decode``), as in the
JAX package's ``generate`` (``tests/test_pipeline_decode.py`` holds the
same cases there).  Greedy tokens with the pipeline on and off must be
identical, through mid-chunk stops (a dropped chunk), budget tails,
continuous-batching refills and idle slots; against the JAX Engine they
must agree up to the first near-tie (``test_torch_engine.py``'s rule and
tolerance), in the 4-bit and the int8/kv8 modes.  On the CPU the launch
and read-back run synchronously: these tests hold the scheduling; the card
tests hold the graphs and the overlap.
"""

import collections
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
from nf4_tpu_torch.ops import _cuda
from nf4_tpu_torch.serve import engine as engine_mod
from nf4_tpu_torch.serve.engine import Decoder, Engine, kv_bucket

LOGIT_TOL = 0.2  # test_torch_engine.py's: the port rounds weights to bf16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's ops gain nothing from more, and
    beside other test processes their thread pools' waits dominate."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _engines(tcfg, tparams, batch_size=2, **kw):
    """The port's Engine with the pipeline on and off."""
    common = dict(batch_size=batch_size, eos_token=-1, decode_chunk=4, device="cpu")
    return (Engine(tparams, tcfg, **common, **kw),
            Engine(tparams, tcfg, pipeline_decode=False, **common, **kw))


def _tokens(results):
    return [r.tokens for r in results]


def _agree_until_near_tie(cfg, params, got, want):
    """``test_torch_engine.py``'s rule: equal up to the first step whose JAX
    top-2 logit gap is within LOGIT_TOL."""
    seq = list(want.prompt)
    for g, w in zip(got.tokens, want.tokens):
        if g != w:
            logits, _ = jllama.prefill(params, cfg, jnp.asarray([seq], jnp.int32))
            top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL, "diverged where JAX's choice was clear"
            return
        seq.append(w)
    assert len(got.tokens) == len(want.tokens) and got.finished == want.finished


@pytest.mark.parametrize("mode", ["nf4", "int8kv8"])
def test_pipeline_matches_unpipelined_and_jax(modes, mode):
    """Token-identical with the pipeline on and off; the pipeline engages;
    both agree with the (pipelined) JAX Engine."""
    cfg, params, tcfg, tparams = modes[mode]
    prompts = [[1, 2, 3], [4, 5]]
    pipe, plain = _engines(tcfg, tparams)
    got = pipe.generate(prompts, max_new_tokens=24)
    assert _tokens(got) == _tokens(plain.generate(prompts, max_new_tokens=24))
    assert pipe.pipeline_stats["launched"] > 0 and pipe.pipeline_stats["discarded"] == 0
    assert plain.pipeline_stats == {"launched": 0, "discarded": 0}
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4).generate(prompts, max_new_tokens=24)
    for g, w in zip(got, want):
        assert len(g.tokens) == 24
        _agree_until_near_tie(cfg, params, g, w)


def test_mid_chunk_stop_discards_the_chunk_ahead(modes):
    """A stop token inside a chunk retires the slot; the chunk launched
    ahead of it is dropped and the tokens equal the unpipelined engine's."""
    _, _, tcfg, tparams = modes["nf4"]
    probe = Engine(tparams, tcfg, batch_size=1, eos_token=-1, decode_chunk=4, device="cpu")
    ref = probe.generate([[1, 2, 3]], max_new_tokens=24)[0].tokens
    # The first token comes from the prefill, then chunks of 4: index i is
    # the last of its chunk when i % 4 == 0.  A stop at its first
    # occurrence, inside a chunk that has a chunk launched after it:
    i = next(i for i in range(5, 20) if i % 4 and ref[i] not in ref[:i])
    pipe, plain = _engines(tcfg, tparams, batch_size=1)
    a = pipe.generate([[1, 2, 3]], max_new_tokens=24, stop_tokens=[ref[i]])[0]
    b = plain.generate([[1, 2, 3]], max_new_tokens=24, stop_tokens=[ref[i]])[0]
    assert a.tokens == b.tokens == ref[:i] and a.finished and b.finished
    assert pipe.pipeline_stats["discarded"] >= 1


def test_continuous_batching_refill(modes):
    """More prompts than slots: retirement and refill between pipelined
    runs give the unpipelined engine's tokens and agree with the JAX
    Engine."""
    cfg, params, tcfg, tparams = modes["nf4"]
    prompts = [[1, 2, 3], [7, 8], [9], [10, 11, 12, 13], [2], [3, 4]]
    pipe, plain = _engines(tcfg, tparams)
    got = pipe.generate(prompts, max_new_tokens=13)
    assert _tokens(got) == _tokens(plain.generate(prompts, max_new_tokens=13))
    assert pipe.pipeline_stats["launched"] > 0
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4).generate(prompts, max_new_tokens=13)
    for g, w in zip(got, want):
        _agree_until_near_tie(cfg, params, g, w)


def _record_launches(monkeypatch):
    """Record (n, kv_len, from the host?) of every Decoder launch."""
    seen = []
    launch = Decoder.launch

    def spy(self, n, kv_len, tokens=None, positions=None, active=None, **kw):
        seen.append((n, kv_len, tokens is not None))
        return launch(self, n, kv_len, tokens, positions, active, **kw)

    monkeypatch.setattr(Decoder, "launch", spy)
    return seen


def test_budget_tail_single_steps(modes, monkeypatch):
    """A budget that is not a multiple of the chunk: its tail single-steps,
    and no chunk is launched past the budget."""
    _, _, tcfg, tparams = modes["nf4"]
    prompts = [[1, 2, 3], [4, 5]]
    pipe, plain = _engines(tcfg, tparams)
    want = plain.generate(prompts, max_new_tokens=10)
    seen = _record_launches(monkeypatch)
    got = pipe.generate(prompts, max_new_tokens=10)
    assert _tokens(got) == _tokens(want) and all(len(r.tokens) == 10 for r in got)
    # 1 token from the prefill, 9 decode steps: a chunk, the chunk launched
    # ahead of it, one single step.
    assert [(n, host) for n, _, host in seen] == [(4, True), (4, False), (1, True)]
    assert pipe.pipeline_stats == {"launched": 1, "discarded": 0}


def test_idle_slots_keep_chunking(modes, monkeypatch):
    """After one request retires (here at the context limit) and the queue
    is empty, the other slot keeps decoding in pipelined chunks, its idle
    neighbour riding along frozen; each request's tokens equal its solo
    run's."""
    _, _, tcfg, tparams = modes["nf4"]
    long_prompt = list(range(3, 3 + tcfg.max_seq_len - 6))  # 5 steps of context left
    prompts = [long_prompt, [4, 5]]
    seen = _record_launches(monkeypatch)
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu")
    res = eng.generate(prompts, max_new_tokens=24)
    assert not res[0].finished and len(res[0].tokens) == 6 and len(res[1].tokens) == 24
    # The long request bounds the first chunk and then single-steps once;
    # alone, the short one runs 4 chunks (3 launched ahead) and 2 steps.
    assert [n for n, _, _ in seen] == [4, 1, 4, 4, 4, 4, 1, 1]
    assert eng.pipeline_stats == {"launched": 3, "discarded": 0}
    for p, r in zip(prompts, res):
        solo = Engine(tparams, tcfg, batch_size=1, eos_token=-1, decode_chunk=4, device="cpu")
        assert solo.generate([p], max_new_tokens=24)[0].tokens == r.tokens


@pytest.mark.parametrize("end, gran, max_len, want", [
    (1, 512, 8192, 512), (512, 512, 8192, 512), (513, 512, 8192, 1024), (1032, 256, 8192, 1280),
    (1032, 512, 8192, 1536), (1032, 1024, 8192, 2048), (8190, 1024, 8192, 8192), (60, 512, 64, 64),
])
def test_kv_bucket(end, gran, max_len, want):
    """Rounds the chunk's end up to a multiple of the granularity, capped
    at the cache length."""
    assert kv_bucket(end, gran, max_len) == want


def test_chunk_steps_share_one_kv_len(modes, monkeypatch):
    """Every step of a chunk reads the same ``kv_len``: the bucket of the
    chunk's end, set once on the host."""
    _, _, tcfg, tparams = modes["nf4"]
    calls = []
    step = engine_mod.decode_step

    def spy(params, cfg, token, cache, positions, kv_len=None):
        calls.append(kv_len)
        return step(params, cfg, token, cache, positions, kv_len=kv_len)

    monkeypatch.setattr(engine_mod, "decode_step", spy)
    seen = _record_launches(monkeypatch)
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu")
    eng.KV_BUCKET = 16
    eng.generate([[1, 2, 3], list(range(5, 15))], max_new_tokens=13)
    # Decode starts at position 10 (the longer prompt); the 12 steps are 3
    # chunks ending at 14, 18 and 22: buckets 16, 32 and 32.
    assert [(n, kv) for n, kv, _ in seen] == [(4, 16), (4, 32), (4, 32)]
    assert calls == [kv for n, kv, _ in seen for _ in range(n)]


def test_launches_under_capture_count_on_replay(monkeypatch):
    """A kernel called while a graph is captured goes into that graph's
    tally, not its launch count; each replay adds the tally; a launch under
    a plain capture counts nowhere.  The card and the library are stood in
    for: the accounting is host code."""

    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

    capturing = [False]

    class fake_capture:
        def __init__(self, graph, **kw):
            pass

        def __enter__(self):
            capturing[0] = True

        def __exit__(self, *exc):
            capturing[0] = False

    lib = type("Lib", (), {"fake_entry": staticmethod(lambda *args: 0)})()
    monkeypatch.setattr(_cuda, "KERNELS", {})
    monkeypatch.setattr(_cuda, "_load", lambda source: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    k = _cuda.Kernel("k", "src", "fake_entry", [])
    k()
    graph = _cuda.CountedGraph()
    with graph.capture(pool=None):
        k()
        k()
    assert k.launches == 1 and graph.tally == collections.Counter(k=2)
    for _ in range(3):
        graph.replay()
    assert FakeGraph.replays == 3 and _cuda.launch_counts() == {"k": 7}
    with torch.cuda.graph(FakeGraph()):  # a plain capture: a timing loop
        k()
    assert k.launches == 7
