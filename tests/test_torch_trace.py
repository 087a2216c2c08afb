"""The port's own trace (``nf4_tpu_torch/utils/trace.py``): the scheduler's
decode records and decode attention's device markers.

On the CPU: a tiny Qwen2-shaped ``Engine.generate`` leaves one record per
decode launch whose steps, active slots and positions account for every
token it decoded; the ring keeps the newest records; a decode forward
launches each layer's begin and end markers in turn and a prefill none;
the markers are no kernel of ``launch_counts()``.  On the card (marked
``cuda``): one replay of a captured decode chunk shows the markers around
each layer's attention kernels in a ``torch.profiler`` trace.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.configs import TINY_TEST
from nf4_tpu_torch.ops import _cuda
from nf4_tpu_torch.serve import engine as engine_mod
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import SamplingParams
from nf4_tpu_torch.utils import trace
from _torch_threads import _one_thread  # noqa: F401

# Qwen2's shape in small: grouped heads and q/k/v biases.
TINY_QWEN2 = dataclasses.replace(TINY_TEST, attn_bias=True)
CHUNK = 8


@pytest.fixture(scope="module")
def params():
    return llama.init_params(TINY_QWEN2, seed=0, device="cpu")


@pytest.fixture
def records():
    trace.DECODE_RECORDS.clear()
    yield trace.DECODE_RECORDS
    trace.DECODE_RECORDS.clear()


def _prompts(rng, lengths):
    return [rng.integers(0, TINY_QWEN2.vocab_size, n).tolist() for n in lengths]


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "unpipelined"])
def test_records_account_for_every_decoded_token(params, records, monkeypatch, pipelined):
    """Budgets that leave 8-step chunks and single steps: the records' steps
    x active slots are the tokens decoded after each prompt's first, and
    each record's positions are the slots' positions as its first step ran
    them (read from the Decoder's inputs)."""
    seen = []  # the active slots' positions as each decode body starts
    orig = engine_mod.Decoder.run_eager

    def run_eager(self, n, kv_len, kind=None):
        pos, act = self.inputs[1].numpy(), self.inputs[2].numpy() != 0
        seen.append((n, pos[act].astype(np.int64)))
        return orig(self, n, kv_len, kind)

    monkeypatch.setattr(engine_mod.Decoder, "run_eager", run_eager)
    eng = Engine(params, TINY_QWEN2, batch_size=2, eos_token=-1, decode_chunk=CHUNK, device="cpu",
                 pipeline_decode=pipelined)
    rng = np.random.default_rng(7)
    prompts = _prompts(rng, [5, 9, 3, 12])
    budgets = [40, 35, 9, 20]
    results = eng.generate(prompts, sampling=[SamplingParams(max_new_tokens=b) for b in budgets])
    assert [len(r.tokens) for r in results] == budgets
    recs = list(records)
    assert {r.n for r in recs} == {1, CHUNK} and {r.kind for r in recs} == {"decode"}
    assert not any(r.graphed for r in recs)  # the CPU runs no graph
    assert any(r.ahead for r in recs) == pipelined
    assert sum(r.n * len(r.positions) for r in recs) == sum(b - 1 for b in budgets)
    assert [(r.n, list(r.positions)) for r in recs] == [(n, list(p)) for n, p in seen]
    for r in recs:
        assert r.start_ns <= r.end_ns
    # Every position each request decoded at, once: position len(prompt) + j
    # for its tokens j = 0 .. budget - 2 (the first came from its prefill).
    want = sorted(len(p) + j for p, b in zip(prompts, budgets) for j in range(b - 1))
    got = sorted(int(x) + i for r in recs for x in r.positions for i in range(r.n))
    assert got == want


def test_ring_drops_its_oldest_records(records):
    for i in range(trace.RING + 3):
        trace.record_decode(i, 1, 0, False, np.zeros(0, np.int64))
    kept = list(trace.DECODE_RECORDS)
    assert len(kept) == trace.RING
    assert kept[0].start_ns == 3 and kept[-1].start_ns == trace.RING + 2


def _cache_with_prompt(params, n=6):
    tokens = torch.arange(1, n + 1, dtype=torch.int32)[None]
    _, cache = llama.prefill(params, TINY_QWEN2, tokens)
    return tokens, cache


def test_markers_around_each_layers_decode_attention(params, monkeypatch):
    """A decode forward of L layers marks begin and end L times each, in
    turn; a prefill marks nothing."""
    calls = []
    monkeypatch.setattr(trace, "mark_decode_attn", lambda which, t: calls.append(which))
    tokens, cache = _cache_with_prompt(params)
    assert calls == []
    llama.decode_step(params, TINY_QWEN2, tokens[:, -1], cache, torch.tensor([6], dtype=torch.int32), kv_len=16)
    assert calls == ["begin", "end"] * TINY_QWEN2.num_layers


def test_markers_are_not_counted_kernels(params):
    """The markers launch through their own path: no kernel of
    ``launch_counts()`` is theirs, and a decode step leaves the counts as
    they were."""
    before = _cuda.launch_counts()
    assert not any("mark" in name for name in before)
    tokens, cache = _cache_with_prompt(params)
    llama.decode_step(params, TINY_QWEN2, tokens[:, -1], cache, torch.tensor([6], dtype=torch.int32), kv_len=16)
    assert _cuda.launch_counts() == before


@pytest.mark.cuda
def test_markers_in_a_profiled_graph_replay():
    """On the card: one replay of a captured 4-step decode chunk, profiled,
    shows L x 4 begin/end pairs in order, each around attention's own
    kernels, and the replay's launch counts hold no marker."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nf4_tpu_torch.models.llama import LlamaConfig
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.serve.engine import kv_bucket

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=128, max_seq_len=256, attn_bias=True)
    eng = Engine(synthetic_params(cfg, seed=3, device="cuda"), cfg, batch_size=4, eos_token=-1, decode_chunk=4)
    cache, dec = eng.state()
    lens = np.asarray([37, 90, 5, 64], np.int32)
    toks = np.zeros((4, 128), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = (np.arange(n) * 7 + i) % cfg.vocab_size
    first = eng.prefill_group(cache, toks, lens, np.arange(4)).argmax(-1).to(torch.int32).cpu().numpy()
    n, act = 4, np.ones(4, np.int32)
    kv = kv_bucket(int(lens.max()) + 2 * n, eng.KV_BUCKET, cfg.max_seq_len)
    dec.read(dec.launch(n, kv, first, lens, act))  # captures the chunk's graph
    assert dec.graphed and eng.graph_stats["captured"] == 1
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        dec.read(dec.launch(n, kv))
        torch.cuda.synchronize()
    assert dec.graphed and eng.graph_stats["replayed"] == 2
    assert not any("mark" in name for name in _cuda.launch_counts())
    names = [e.name() for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
             if str(e.device_type()).endswith("CUDA")]
    marks = [name for name in names if name.startswith("nf4_mark_decode_attn_")]
    assert marks == ["nf4_mark_decode_attn_begin", "nf4_mark_decode_attn_end"] * (cfg.num_layers * n)
    inside, open_ = [], False
    for name in names:
        if name == "nf4_mark_decode_attn_begin":
            open_, count = True, 0
        elif name == "nf4_mark_decode_attn_end":
            inside.append(count)
            open_ = False
        elif open_:
            count += 1
    assert len(inside) == cfg.num_layers * n and min(inside) >= 3  # copies, products, softmax
