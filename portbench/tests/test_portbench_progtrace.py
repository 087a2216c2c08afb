"""The readers of the program's own trace (``progtrace.py``): on a synthetic
slice with hand-computed values, on a program that keeps no trace, and over
a tiny CPU cell, where the program's decode records must count the decode
steps and tokens the harness counts."""

import sys
import types

import numpy as np
import pytest
from conftest import run_tiny

from portbench import devtrace, harness, progtrace, work
from portbench.model import from_config

from nf4_tpu_torch.utils import trace

SEED = 2**31 + 5
# Two layers of 4 heads over 2 KV heads of 32: kv_dim 64, q_dim 128.
MODEL = from_config("t", {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
                          "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 100,
                          "rms_norm_eps": 1e-6, "max_position_embeddings": 256})
BEGIN, END = "nf4_mark_decode_attn_begin", "nf4_mark_decode_attn_end"
HOST0, DEV0 = 1_000, 1_000_000  # the slice's start on the host clock and the device clock


def _slice():
    """A 10 us slice: an end marker with no begin at its start, a kernel
    outside any pair, two pairs around attention kernels (two of them
    overlapping: 800 ns in union, then 400 ns), and a begin with no end at
    its close."""
    sl = devtrace.Slice()
    sl.t0, sl.t1 = (HOST0, DEV0), (HOST0 + 10_000, DEV0 + 10_000)
    rel = [(END, 100, 200), ("gemm", 300, 900),
           (BEGIN, 1000, 1100), ("copy", 1200, 1600), ("gemv", 1500, 2000), (END, 2100, 2200),
           (BEGIN, 3000, 3100), ("copy", 3100, 3500), (END, 3600, 3700),
           (BEGIN, 9800, 9900), ("copy", 9900, 9950)]
    sl.events = [(name, DEV0 + a, DEV0 + b) for name, a, b in rel]
    return sl


def _rec(start, end, n, graphed, positions):
    return trace.DecodeRecord(HOST0 + start, HOST0 + end, n, 0, graphed, np.asarray(positions, np.int64))


@pytest.fixture
def records():
    trace.DECODE_RECORDS.clear()
    yield trace.DECODE_RECORDS
    trace.DECODE_RECORDS.clear()


def _run(sl):
    return types.SimpleNamespace(model=MODEL, window=types.SimpleNamespace(slice=sl), trace=object())


def _fill(records):
    records.extend([
        _rec(-500, -100, 1, False, [3]),  # before the slice: ignored
        _rec(1000, 3000, 1, False, [10, 20]),  # on the device clock 1000-3000: idle 100 + 100 + 800 ns
        _rec(3000, 4000, 8, True, [5]),
        _rec(7000, 7500, 1, False, [30]),  # inside the idle stretch 3700-9800: 500 ns
        _rec(9500, 10_500, 8, True, [40]),  # ends after the slice: ignored
    ])


def test_readers_on_a_synthetic_slice(records):
    _fill(records)
    run = _run(_slice())
    assert [r.n for r in progtrace.records(run)] == [1, 8, 1]
    assert progtrace.marker_pairs(run.window.slice.events) == [(DEV0 + 1100, DEV0 + 2100), (DEV0 + 3100, DEV0 + 3600)]
    assert progtrace.attn_device_s(run) == pytest.approx(1200e-9)
    assert progtrace.eager_step_pct(run) == pytest.approx(100 * 2 / 10)
    assert progtrace.eager_idle_pct(run) == pytest.approx(100 * 1500 / 10_000)
    # Bytes per layer: K and V of every visible key (64 x 2 x 2 B each),
    # q and out of every active slot (128 x 2 x 2 B): keys 11 + 21, then
    # 6 .. 13 over 8 steps, then 31; every step is bound by its bytes.
    nbytes = (32 * 256 + 2 * 512) + (sum(range(6, 14)) * 256 + 8 * 512) + (31 * 256 + 512)
    least = 2 * nbytes / work.PEAK_HBM_BYTES_S
    assert progtrace.decode_attn_least_s(MODEL, progtrace.records(run)) == pytest.approx(least)
    assert progtrace.decode_attn_roofline(run) == pytest.approx(100 * least / 1200e-9)
    assert progtrace.on_device_clock((HOST0 + 5, HOST0 + 7), run) == (DEV0 + 5, DEV0 + 7)


def test_readers_read_zero_when_every_step_was_graphed(records):
    records.append(_rec(3000, 4000, 8, True, [5]))
    run = _run(_slice())
    assert progtrace.eager_step_pct(run) == 0 and progtrace.eager_idle_pct(run) == 0
    assert progtrace.decode_attn_roofline(run) > 0


def test_readers_read_nothing_without_the_programs_trace(records, monkeypatch):
    """Without records (no decode in the slice, or a program older than its
    trace) and without markers, every reader returns None and none raises."""
    run = _run(_slice())
    assert progtrace.eager_step_pct(run) is None and progtrace.eager_idle_pct(run) is None
    assert progtrace.decode_attn_roofline(run) is None
    _fill(records)
    monkeypatch.setitem(sys.modules, "nf4_tpu_torch.utils.trace", None)  # the import fails
    monkeypatch.delattr(sys.modules["nf4_tpu_torch.utils"], "trace")
    assert progtrace.records(run) == [] and progtrace.eager_step_pct(run) is None
    monkeypatch.undo()
    _fill(records)
    bare = _slice()
    bare.events = [e for e in bare.events if e[0] not in (BEGIN, END)]
    assert progtrace.attn_device_s(_run(bare)) is None and progtrace.decode_attn_roofline(_run(bare)) is None
    assert progtrace.records(types.SimpleNamespace(window=types.SimpleNamespace(slice=None), trace=None)) == []


@pytest.mark.parametrize("cell", ["tiny-qwen2.chat", "tiny-qwen2.batch"])
def test_records_count_the_harness_work(bench_dir, records, monkeypatch, cell):
    """Over a whole tiny run, the program's decode records count the decode
    steps and tokens of the harness's own ``Work`` (its wrapper of every
    decode launch), so the roofline's work is the benchmark's."""
    root, base = bench_dir
    views = []
    view = harness.RunView
    monkeypatch.setattr(harness, "RunView", lambda *a: views.append(view(*a)) or views[-1])
    result = run_tiny(root, base, cell, SEED)
    assert result["correct"]
    done = views[0].window.work
    recs = list(trace.DECODE_RECORDS)
    assert done.decode_steps > 0 and {r.kind for r in recs} == {"decode"}
    assert sum(r.n for r in recs) == done.decode_steps
    assert sum(r.n * len(r.positions) for r in recs) == done.decode_tokens
