"""The harness on the CPU at tiny sizes: traffic from the seed, the metric
arithmetic on hand-built timestamps, files found by name, no JAX, and a run
with the timed path broken underneath coming out not correct."""

import ast
import json
import sys

import numpy as np
import pytest
import torch
from conftest import CLOSED, OPEN, PORTBENCH, ROOT, run_tiny

from portbench import devtrace, harness, spec, work
from portbench.traffic import Request, Traffic

SEED = 2**31 + 5


WINDOW_S = 2.0


def _requests(spec_, seed, n=40):
    t = Traffic(spec_, 1000, seed, WINDOW_S)
    return [t.request(i) for i in range(n)]


@pytest.mark.parametrize("spec_", [OPEN, CLOSED], ids=["open", "closed"])
def test_traffic_same_seed_same_requests(spec_):
    a, b, c = _requests(spec_, SEED), _requests(spec_, SEED), _requests(spec_, SEED + 1)
    assert all(np.array_equal(x.prompt, y.prompt) and x.budget == y.budget and x.due == y.due for x, y in zip(a, b))
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    assert [x.budget for x in a] != [x.budget for x in c] or [len(x.prompt) for x in a] != [len(x.prompt) for x in c]
    if spec_["loop"] == "open":
        return  # the open loop's window: test_traffic_open_loop_window_same_load
    # Every seed offers the same load: each block of sizes is one set, reordered.
    blk = spec_["block"]
    for lo in range(blk, 40 - blk + 1, blk):  # past the closed loop's staggered first block
        assert sorted(len(x.prompt) for x in a[lo : lo + blk]) == sorted(len(x.prompt) for x in c[lo : lo + blk])


def test_traffic_open_loop_rate():
    t = Traffic(OPEN, 1000, SEED, WINDOW_S)
    due = [t.due(i) for i in range(8 * 50)]
    assert all(b > a for a, b in zip(due, due[1:]))
    assert abs(len(due) / due[-1] - OPEN["rate_per_s"]) < 0.05 * OPEN["rate_per_s"]


@pytest.mark.parametrize("window_s", [WINDOW_S, 51.0])
def test_traffic_open_loop_window_same_load(window_s):
    """Every window after the ramp holds the same requests under every seed:
    as many, the same sizes and the same gaps, in another order."""
    ramp = OPEN["ramp_s"]

    def window(seed, k):
        t = Traffic(OPEN, 1000, seed, window_s)
        lo, hi = ramp + k * window_s, ramp + (k + 1) * window_s
        reqs, i = [], 0
        while (r := t.request(i)).due < hi:
            if r.due >= lo:
                reqs.append(r)
            i += 1
        return reqs

    n = round(OPEN["rate_per_s"] * window_s)
    for k in (0, 1):
        a, c = window(SEED, k), window(SEED + 1, k)
        assert len(a) == len(c) == n
        for key in (lambda r: len(r.prompt), lambda r: r.budget):
            assert sorted(map(key, a)) == sorted(map(key, c))
        lo, hi = ramp + k * window_s, ramp + (k + 1) * window_s
        gaps = [sorted(np.diff([r.due for r in w] + [w[0].due + window_s])) for w in (a, c)]
        np.testing.assert_allclose(gaps[0], gaps[1], rtol=1e-9, atol=1e-9)
        assert [r.due for r in a] != [r.due for r in c]
        assert lo < min(a[0].due, c[0].due) and max(a[-1].due, c[-1].due) < hi
        assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]


class _Traffic:
    """Open-loop arrivals at given due times."""

    open, slots, ramp_s = True, 4, 0.0

    def __init__(self, dues):
        self.dues = dues

    def due(self, i):
        return self.dues[i] if i < len(self.dues) else 1e9


def _window(dues, served, w0=10.0, w1=20.0, tokens=()):
    """A window built by hand: call start 0, requests due at ``dues`` (those
    served are ``(handed, first, last, count, budget)``)."""
    win = harness.Window.__new__(harness.Window)
    win.t, win.t_call, win.w0, win.w1, win.seconds = _Traffic(dues), 0.0, w0, w1, w1 - w0
    win.served = []
    for due, (handed, first, last, count, budget) in zip(dues, served):
        s = harness.Served(Request(0, np.zeros(4, np.int32), budget, due), due, handed, first, last, count)
        win.served.append(s)
    win.next = len(served)
    win.token_times = list(tokens)
    return win


def test_tails_count_unanswered_requests():
    """Requests due at 11 and 12 are answered; the one due at 13 was handed
    over but has no token when the window closes at 20; the one due at 15 was
    never handed over.  Each unanswered one counts its wait so far."""
    win = _window([11.0, 12.0, 13.0, 15.0], [(11.0, 11.5, 12.5, 11, 11), (12.0, 12.2, 13.2, 6, 6), (13.0, None, None, 0, 8)])
    ttft = sorted(win.ttft_ms())
    assert ttft == pytest.approx([200.0, 500.0, 5000.0, 7000.0])
    assert work.percentile(win.ttft_ms(), 95) == pytest.approx(np.percentile([200, 500, 5000, 7000], 95))
    assert sorted(win.queue_wait_ms()) == pytest.approx([0.0, 0.0, 0.0, 5000.0])
    assert win.attempted() == 4


def test_out_tok_s_counts_tokens_inside_the_window():
    win = _window([], [], tokens=[9.0, 9.99, 10.0, 15.0, 19.5, 20.0, 20.01, 25.0])
    assert win.tokens_in_window() == 4
    assert spec.Benchmark(ROOT).reader("out_tok_s")(harness.RunView(None, win, 0.0, 10.0, None, None)) == 0.4


def test_itl_counts_gaps_inside_the_window_and_stalls_at_the_close():
    """Gaps whose later token falls inside the window count; a request still
    running at the close adds its wait since its last token."""
    win = _window([11.0, 12.0], [(11.0, 11.5, 19.0, 3, 3), (12.0, 12.2, 17.0, 2, 8)])
    win.token_gaps = [(9.5, 0.4), (11.6, 0.1), (19.0, 7.4), (17.0, 4.8), (20.5, 0.5)]
    assert sorted(win.itl_ms()) == pytest.approx([100.0, 3000.0, 4800.0, 7400.0])


def test_sample_spans_the_slots():
    """Whatever the answers' lengths, the sample takes the longest request and
    one of each slot until ``min_requests`` slots are covered."""
    win = _window([], [])
    win.served = [harness.Served(Request(i, np.zeros(100 if i == 0 else 10, np.int32), 400 if i == 0 else 5, 0.0),
                                 0.0, slot=i % 10) for i in range(30)]

    class _Res:
        def __init__(self, n):
            self.tokens = [0] * n

    win.results = [_Res(s.req.budget) for s in win.served]
    limits = {"served_tokens_target": 300, "min_requests": 8, "max_requests": 12, "max_ref_tokens": 10**6}
    picked = harness.sample(win, SEED, limits)
    assert picked[0] == 0 and len({win.served[r].slot for r in picked}) == 8 and len(picked) == 8


def test_padding_is_not_work():
    """A prompt's roofline work counts its real tokens, not its bucket's
    padding, and a weight's bytes its published m x n, not the tiles'."""
    from portbench.model import from_config
    from portbench.weights import projections

    m = from_config("t", {"hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 1,
                          "num_attention_heads": 28, "num_key_value_heads": 4, "vocab_size": 100,
                          "rms_norm_eps": 1e-6, "max_position_embeddings": 8192})
    real, padded = work.Work(), work.Work()
    real.add_prefill(m, [4200], 8192)
    padded.add_prefill(m, [4200], 4200)
    assert real.proj_least_s == pytest.approx(padded.proj_least_s, rel=0.02)  # segments read the weight again
    weight = sum(mm * n / 2 + -(-n // 64) * mm * 4 + (mm + n) * 2 for _, mm, n, _ in projections(m))  # + one row in, out
    assert work.proj_least_s(m, 1) == pytest.approx(weight / work.PEAK_HBM_BYTES_S, rel=1e-3)
    one, idle = work.Work(), work.Work()
    one.add_decode(m, 1, 1, np.array([100]))
    idle.add_decode(m, 1, 16, np.array([100]))
    assert one.proj_least_s == idle.proj_least_s


def test_busy_union_of_overlapping_intervals():
    """Two streams' kernels that overlap count once, and nothing outside the
    slice counts: busy <= the slice."""
    events = [("a", 0, 50), ("b", 40, 120), ("c", 100, 130), ("d", 200, 260), ("e", 290, 400)]
    busy, merged = devtrace.union_busy([(a, b) for _, a, b in events], 10, 300)
    assert merged == [(10, 130), (200, 260), (290, 300)]
    assert busy == 190 <= 300 - 10
    s = devtrace.summarize(events, 10, 300, [("prefill", 130, 205), ("read_back", 262, 280)])
    assert s.busy_s == pytest.approx(190e-9) and s.window_s == pytest.approx(290e-9)
    assert s.idle_by_label == pytest.approx({"host:prefill": 70e-9, "host:read_back": 30e-9})
    assert sum(s.kernel_s.values()) == pytest.approx((40 + 80 + 30 + 60 + 10) * 1e-9)


def test_kernel_short_names():
    assert devtrace.short_name("void dm::decode_kernel<(anonymous namespace)::dk::Nf4Decode>(__nv_bfloat16 const*, int)") \
        == "dm::decode_kernel<(anonymous namespace)::dk::Nf4Decode>"


def test_work_counts_follow_the_shapes():
    """A decode step's FLOPs are 2 x the active parameters per token plus the
    attention over its context; a prompt's logits are its last token's only."""
    from portbench.model import from_config

    m = from_config("t", {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                          "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 100,
                          "rms_norm_eps": 1e-6, "max_position_embeddings": 4096})
    layer = 64 * (64 + 2 * 32) + 64 * 64 + 64 * 256 + 128 * 64
    w = work.Work()
    w.add_decode(m, 1, 16, np.array([9]))
    assert w.model_flops == 2 * (2 * layer + 100 * 64) + 4 * 64 * 10 * 2
    p = work.Work()
    p.add_prefill(m, [3], 16)
    assert p.model_flops == 2 * (2 * layer * 3 + 100 * 64) + 4 * 64 * 6 * 2
    assert p.flash_calls == 0  # 16 positions: below kernel C's rows


def test_files_found_by_name(bench_dir):
    """A configuration, a traffic mix and a metric added as files in a copy are
    found by the names BENCHMARK.json gives, with no other edit."""
    root, base = bench_dir
    (base / "metrics" / "half_out_tok_s.py").write_text("def read(run):\n    return run.window.tokens_in_window() / 2\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["end_to_end"].append({"name": "half_out_tok_s", "unit": "tokens/s", "better": "higher", "bound": 0.1,
                              "source": "host_clock", "workloads": ["tiny-qwen2.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    b = spec.Benchmark(root, base)
    assert b.traffic(b.cell("tiny-qwen2.batch")["traffic"])["loop"] == "closed"
    assert b.config_path("tiny-qwen2").name == "tiny-qwen2.json"
    result = run_tiny(root, base, "tiny-qwen2.batch", SEED)
    assert {"setup_s", "out_tok_s", "half_out_tok_s"} <= set(result["metrics"])
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_no_module_imports_jax():
    """No module under portbench/ imports jax, flax or nf4_tpu (top-level
    names compared whole: nf4_tpu_torch is the program, and allowed)."""
    files = sorted(PORTBENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "nf4_tpu"), (path, m)


def _altered_token(monkeypatch):
    """A token altered where it is produced: every greedy pick moved by one."""
    import nf4_tpu_torch.serve.engine as engine

    orig = engine.sample
    monkeypatch.setattr(engine, "sample", lambda logits, p, *a, **k: (orig(logits, p, *a, **k) + 1) % logits.shape[-1])


def _state_unchanged(monkeypatch):
    """A decode step that leaves its state unchanged: no K/V written."""
    import nf4_tpu_torch.models.llama as llama

    orig = llama._write_kv
    monkeypatch.setattr(llama, "_write_kv", lambda cache, new, index: None if new.shape[2] == 1 else orig(cache, new, index))


def _half_batch(monkeypatch):
    """Half of the batch left out: the decode step computes its first half of
    rows only, the rest's logits left at zero."""
    import nf4_tpu_torch.serve.engine as engine

    orig = engine._decode_rows

    def half(*a, **k):
        logits = orig(*a, **k)
        logits[logits.shape[0] // 2 :] = 0.0
        return logits

    monkeypatch.setattr(engine, "_decode_rows", half)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["tiny-qwen2.chat", "tiny-qwen2.batch"])
def test_broken_timed_path_is_not_correct(bench_dir, monkeypatch, fault, cell):
    """A whole run past the look for a card, with the timed path broken
    underneath, comes out not correct (one chip: no exchange to leave out)."""
    root, base = bench_dir
    fault(monkeypatch)
    result = run_tiny(root, base, cell, SEED)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for name, c in result["checks"].items() if name in ("max_logit_gap", "gap_p90"))


@pytest.mark.parametrize("cell", ["tiny-qwen2.chat", "tiny-qwen2.batch"])
def test_sound_run_is_correct(bench_dir, cell):
    root, base = bench_dir
    result = run_tiny(root, base, cell, SEED)
    assert result["correct"] is True and result["attempted"] > 0


def test_run_refuses_without_a_card(monkeypatch, capsys):
    """No CUDA device: exit 2 and no result line."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "unset")
    spec_ = importlib.util.spec_from_file_location("portbench_run", PORTBENCH / "run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    assert run.main(["--workload", "qwen2-7b.chat", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
