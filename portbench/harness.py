"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (``setup_s`` runs from the process's start to the window's start):
build the program's kernels (cached in the checkout), draw the weights on
the card from the seed, build one ``Engine`` (16 slots, greedy, bf16 cache,
CUDA graphs, pipelined decode, no end token), run the cell's own prefill
shapes and capture the decode graphs of its own kv buckets, so that nothing
is captured in the window, then ramp the traffic untimed.

The window is one ``Engine.generate(admit=, on_token=, cancel=)`` call, the
call the HTTP front's dispatcher makes: ``admit`` hands over the traffic's
requests as they fall due (and as slots free), ``on_token`` stamps each
token on the host clock, ``cancel`` ends what is in flight at the window's
end.  The ramp is the same call's first stretch.  With ``--trace 1`` the
window's last seconds are traced (``devtrace.py``).

After the window: the peak memory is read, the program's state freed, and a
sample of the finished requests, drawn from the seed with the longest in
it and spread over the batch's slots, is run through the reference
(``reference.py``): the gaps by which the served tokens' logits lie below
the reference's best are held to the cell's limits
(``limits/<workload>.json``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import devtrace, model as model_mod, port, reference, spec, work
from .traffic import Request, Traffic
from .weights import Head, Layer

from nf4_tpu_torch.ops import _cuda
from nf4_tpu_torch.serve.engine import Engine, kv_bucket
from nf4_tpu_torch.serve.sampling import SamplingParams
from nf4_tpu_torch.utils.shapes import bucket_len

# The traced slice: the window's last seconds, so that the profiler's stop,
# which holds the host for seconds, falls after the window's close.
TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "nf4_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one the
    benchmark's process must not hold."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Program:
    """The program under test, built once per process: weights drawn from a
    seed into fixed buffers, one Engine over them, the cell's shapes warm."""

    def __init__(self, model: model_mod.Model, traffic: Traffic, seed: int, device, slots: int):
        self.model, self.device, self.slots = model, torch.device(device), slots
        self.phases = {}  # set-up seconds by phase, for the record on stderr
        t = time.perf_counter()
        if self.device.type == "cuda":
            _cuda.build()
        self.phases["kernels"] = time.perf_counter() - t
        self.layers = [Layer(model, self.device) for _ in range(model.layers)]
        self.head = Head(model, self.device)
        self.fill(seed)
        self.params = port.params(model, self.layers, self.head)
        self.phases["weights"] = time.perf_counter() - t - self.phases["kernels"]
        t = time.perf_counter()
        self.engine = port.engine(model, self.params, slots, self.device)
        self.phases["engine"] = time.perf_counter() - t
        t = time.perf_counter()
        self.warm(traffic)
        self.phases["warm"] = time.perf_counter() - t
        self.phases["graph_capture"] = self.engine.graph_stats["capture_s"]

    def fill(self, seed: int) -> None:
        """Draw run ``seed``'s weights into the buffers (the graphs keep
        their pointers)."""
        for i, lw in enumerate(self.layers):
            lw.fill(seed, i)
        self.head.fill(seed)

    def warm(self, traffic: Traffic) -> None:
        """Run every prefill shape and capture every decode graph the cell's
        traffic can reach, and no others."""
        eng, m = self.engine, self.model
        cache, dec = eng.state()
        lo = bucket_len(traffic.min_prompt)
        hi = min(bucket_len(traffic.max_prompt), m.max_seq)
        b = lo
        while b <= hi:
            # Groups of 2 and 4 once at a bucket of one segment or less (or
            # the smallest): longer buckets run the same segment shapes.
            for g in (1, 2, 4) if b <= eng.PREFILL_SEGMENT or b == lo else (1,):
                length = min(b, traffic.max_prompt)
                eng.prefill_group(cache, np.zeros((g, b), np.int32), np.full(g, length, np.int32), np.arange(g))
            b *= 2
        n = eng.decode_chunk
        top = kv_bucket(traffic.max_prompt + traffic.max_output + 2 * n, eng.KV_BUCKET, m.max_seq)
        kv = kv_bucket(traffic.min_prompt + 1, eng.KV_BUCKET, m.max_seq)
        zeros = np.zeros(self.slots, np.int32)
        while kv <= top:
            for steps in (n, 1):
                pos = np.full(self.slots, kv - steps, np.int32)
                dec.read(dec.launch(steps, kv, zeros, pos, np.ones(self.slots, np.int32), zeros))
            kv += eng.KV_BUCKET
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        self.engine = self.params = self.layers = self.head = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Served:
    """One request as the harness saw it."""

    req: Request
    due: float  # absolute host time it fell due (open loop) or was handed over (closed)
    handed: Optional[float] = None
    first: Optional[float] = None
    last: Optional[float] = None
    count: int = 0
    bad_token: bool = False
    slot: Optional[int] = None  # the cache slot its prefill wrote


class Window:
    """The callbacks of one ``generate`` call and what they recorded."""

    def __init__(self, program: Program, traffic: Traffic, seconds: float, trace: bool,
                 clock=time.perf_counter, sleep=time.sleep):
        self.p, self.t, self.seconds = program, traffic, float(seconds)
        self.clock, self.sleep = clock, sleep
        self.eng = program.engine
        self.model = program.model
        self.served: List[Served] = []  # by the Engine's request index (admission order)
        self.next = 0  # the traffic's next request
        self.in_flight = 0
        self.ramp_firsts = 0
        self.t_call = self.w0 = self.w1 = None
        self.token_times: List[float] = []
        self.token_gaps: List[tuple] = []  # (host time, seconds since the request's previous token)
        self._pending: Dict[tuple, int] = {}  # a handed-over request's prompt key -> its index
        self.work = work.Work()
        self.slice = devtrace.Slice() if trace else None
        self.slice_work: Optional[work.Work] = None
        self.slice_marks = None  # (work at the slice's start)
        self.pipe0 = self.pipe1 = None
        self.graphs0 = self.graphs1 = None
        self._pos = np.zeros(program.slots, np.int64)
        self._act = np.zeros(program.slots, bool)
        self._wrap()

    # -- the program's calls, counted ---------------------------------------

    def _wrap(self) -> None:
        eng, dec = self.eng, self.eng.state()[1]
        prefill, launch, read_all = eng.prefill_group, dec.launch, dec.read_all
        model, rows = self.model, self.p.slots

        def prefill_group(cache, tokens, lengths, slots, start=None, adapter_ids=None):
            for row, (length, slot) in enumerate(zip(lengths, slots)):
                r = self._pending.pop(_prompt_key(np.asarray(tokens[row, : int(length)])), None)
                if r is not None:
                    self.served[r].slot = int(slot)
            a = time.perf_counter_ns()
            out = prefill(cache, tokens, lengths, slots, start, adapter_ids)
            self._span("prefill", a)
            self.work.add_prefill(model, [int(x) for x in lengths], tokens.shape[1])
            return out

        def dec_launch(n, kv_len, tokens=None, positions=None, active=None, steps=None, kind=None):
            if tokens is not None:
                self._pos[:] = positions
                self._act[:] = np.asarray(active) != 0
            a = time.perf_counter_ns()
            handle = launch(n, kv_len, tokens, positions, active, steps, kind)
            self._span("decode_launch" if n > 1 else "decode_step_eager", a)
            self.work.add_decode(model, n, rows, self._pos[self._act])
            self._pos[self._act] += n
            return handle

        def dec_read_all(handle):
            a = time.perf_counter_ns()
            out = read_all(handle)
            self._span("read_back", a)
            return out

        eng.prefill_group, dec.launch, dec.read_all = prefill_group, dec_launch, dec_read_all
        self._unwrap = lambda: [delattr(o, a) for o, a in ((eng, "prefill_group"), (dec, "launch"),
                                                          (dec, "read_all"))]

    def _span(self, label: str, a: int) -> None:
        if self.slice is not None:
            self.slice.span(label, a, time.perf_counter_ns())

    # -- the window ------------------------------------------------------------

    def _open_window(self, w0: float) -> None:
        self.w0, self.w1 = w0, w0 + self.seconds

    def _snapshot(self) -> tuple:
        return dict(self.eng.pipeline_stats), dict(self.eng.graph_stats)

    def ended(self, now: float) -> bool:
        return self.w1 is not None and now >= self.w1

    def _tick(self, now: float) -> None:
        if self.w0 is None and self.t.open and now >= self.t_call + self.t.ramp_s:
            self._open_window(self.t_call + self.t.ramp_s)
        if self.w0 is not None and self.pipe0 is None and now >= self.w0:
            self.pipe0, self.graphs0 = self._snapshot()
        if self.w1 is not None and self.pipe1 is None and now >= self.w1:
            self.pipe1, self.graphs1 = self._snapshot()
        if self.slice is None or self.w0 is None:
            return
        span = min(TRACE_SECONDS, self.seconds)
        start = self.w1 - span
        if self.slice_marks is None and now >= start:
            self.slice.start()
            self.slice_marks = self.work.copy()
        elif self.slice_marks is not None and self.slice_work is None and now >= start + span:
            self._stop_slice()

    def _stop_slice(self) -> None:
        self.slice.stop()
        self.slice_work = self.work.minus(self.slice_marks)

    def _hand_over(self, now: float, count: int) -> list:
        out = []
        for _ in range(count):
            req = self.t.request(self.next)
            self.next += 1
            due = self.t_call + req.due if self.t.open else now
            self._pending[_prompt_key(req.prompt)] = len(self.served)
            self.served.append(Served(req, due, handed=now))
            self.in_flight += 1
            out.append((req.prompt.tolist(), SamplingParams(max_new_tokens=req.budget), None))
        return out

    def _due_count(self, now: float, idle: int) -> int:
        n = 0
        while n < idle and self.t_call + self.t.due(self.next + n) <= now:
            n += 1
        return n

    def admit(self, features) -> list:
        now = self.clock()
        self._tick(now)
        if self.ended(now):
            return []
        idle = self.p.slots - self.in_flight
        if not self.t.open:
            return self._hand_over(now, idle)
        n = self._due_count(now, idle)
        if n == 0 and self.in_flight == 0:
            # Nothing runs and nothing is due: wait for the next arrival, or
            # the call would end.
            wake = self.t_call + self.t.due(self.next)
            if self.w1 is not None:
                wake = min(wake, self.w1)
            a = time.perf_counter_ns()
            self.sleep(max(0.0, wake - now))
            self._span("admit_wait", a)
            now = self.clock()
            self._tick(now)
            if self.ended(now):
                return []
            n = self._due_count(now, idle)
        return self._hand_over(now, n)

    def peek(self) -> bool:
        now = self.clock()
        if self.ended(now) or self.in_flight >= self.p.slots:
            return False
        return (not self.t.open) or self.t_call + self.t.due(self.next) <= now

    def on_token(self, r: int, tok: int) -> None:
        now = self.clock()
        self._tick(now)
        s = self.served[r]
        if not 0 <= tok < self.model.vocab:
            s.bad_token = True
        s.count += 1
        if s.last is not None:
            self.token_gaps.append((now, now - s.last))
        s.last = now
        self.token_times.append(now)
        if s.first is None:
            s.first = now
            if not self.t.open and r < self.t.slots:
                self.ramp_firsts += 1
                if self.ramp_firsts == self.t.slots:
                    self._open_window(now + self.t.ramp_s)
        if s.count == s.req.budget:
            self.in_flight -= 1

    def cancel(self, r: int) -> bool:
        now = self.clock()
        self._tick(now)
        return self.ended(now)

    def run(self):
        def admit(features):
            return self.admit(features)

        admit.peek = self.peek  # the chunk loop's poll for a waiting request
        self.t_call = self.clock()
        if self.t.open and self.t.ramp_s <= 0:
            self._open_window(self.t_call)
        try:
            self.results = self.eng.generate([], admit=admit, on_token=self.on_token, cancel=self.cancel)
        finally:
            self._unwrap()
        end = self.clock()
        if self.w0 is None:  # the ramp never ended: the window is empty
            self._open_window(end)
        if self.pipe0 is None:
            self.pipe0, self.graphs0 = self._snapshot()
        if self.pipe1 is None:
            self.pipe1, self.graphs1 = self._snapshot()
        if self.slice is not None and self.slice_marks is not None and self.slice_work is None:
            self._stop_slice()
        return self

    # -- what the metrics read ---------------------------------------------------

    def due_in_window(self) -> List[Served]:
        return [s for s in self.served if self.w0 <= s.due < self.w1]

    def backlog(self, t: float) -> int:
        """Requests due by host time ``t`` and not yet handed over."""
        if not self.t.open:
            return 0
        due = 0
        while self.t_call + self.t.due(due) <= t:
            due += 1
        return due - sum(1 for s in self.served if s.handed <= t)

    def unhanded_dues(self) -> List[float]:
        """Due times, inside the window, of the requests never handed over
        (open loop): each counts the wait it had when the window closed."""
        out, k = [], 0
        while self.t.open and (due := self.t_call + self.t.due(self.next + k)) < self.w1:
            if due >= self.w0:
                out.append(due)
            k += 1
        return out

    def ttft_ms(self) -> List[float]:
        answered = [1e3 * ((s.first if s.first is not None and s.first <= self.w1 else self.w1) - s.due)
                    for s in self.due_in_window()]
        return answered + [1e3 * (self.w1 - due) for due in self.unhanded_dues()]

    def queue_wait_ms(self) -> List[float]:
        handed = [1e3 * (min(s.handed, self.w1) - s.due) for s in self.due_in_window()]
        return handed + [1e3 * (self.w1 - due) for due in self.unhanded_dues()]

    def itl_ms(self) -> List[float]:
        """Every gap between two consecutive tokens of one request whose
        later token came inside the window, and, for each request still
        running at the close, the wait since its last token: a stalled
        stream cannot hide."""
        gaps = [1e3 * g for t, g in self.token_gaps if self.w0 <= t <= self.w1]
        for s in self.served:
            if s.last is not None and s.count < s.req.budget and self.w0 <= s.last < self.w1:
                gaps.append(1e3 * (self.w1 - s.last))
        return gaps

    def tokens_in_window(self) -> int:
        return sum(1 for t in self.token_times if self.w0 <= t <= self.w1)

    def attempted(self) -> int:
        if self.t.open:
            return len(self.due_in_window()) + len(self.unhanded_dues())
        return sum(1 for s in self.served if self.w0 <= s.handed < self.w1)

    def failed(self) -> int:
        """Requests whose answer is malformed: more tokens than asked, a token
        outside the vocabulary, or tokens the callbacks and the result
        disagree on."""
        bad = 0
        for r, s in enumerate(self.served):
            res = self.results[r] if r < len(self.results) else None
            toks = [] if res is None else list(res.tokens)
            if s.bad_token or len(toks) > s.req.budget or len(toks) != s.count:
                bad += 1
        return bad

    def pipeline(self) -> Dict[str, int]:
        return {k: self.pipe1[k] - self.pipe0[k] for k in self.pipe0}

    def captured_in_window(self) -> int:
        return self.graphs1["captured"] - self.graphs0["captured"]


@dataclasses.dataclass
class RunView:
    """What a metric's reader gets: ``read(run) -> float | None``."""

    model: model_mod.Model
    window: Window
    setup_s: float
    seconds: float
    trace: Optional[devtrace.Summary]
    slice_work: Optional[work.Work]


def _prompt_key(tokens: np.ndarray) -> tuple:
    """A prompt's key: its length and first tokens (ids drawn uniformly over
    the vocabulary, so no two of a run share one)."""
    return len(tokens), np.asarray(tokens[:32], dtype=np.int64).tobytes()


def sample(window: Window, seed: int, limits: dict) -> List[int]:
    """Indices of the finished requests whose tokens are checked.  The longest
    (prompt and answer) first; then, in an order drawn from the seed, one
    request of each slot not yet covered, until ``min_requests`` slots are,
    so that the sample spans the batch whatever the answers' lengths; then
    more, until ``served_tokens_target`` tokens are covered.  At most
    ``max_requests``, within ``max_ref_tokens`` of reference work."""
    done = [r for r, s in enumerate(window.served)
            if r < len(window.results) and len(window.results[r].tokens) == s.req.budget]
    if not done:
        return []
    size = lambda r: len(window.served[r].req.prompt) + window.served[r].req.budget  # noqa: E731
    longest = max(done, key=size)
    rest = [r for r in done if r != longest]
    order = [rest[k] for k in np.random.default_rng([seed & (2**63 - 1), 7]).permutation(len(rest))]
    picked, served, total = [longest], window.served[longest].req.budget, size(longest)
    slots = {window.served[longest].slot}

    def take(r) -> bool:
        nonlocal served, total
        if len(picked) >= limits["max_requests"] or total + size(r) > limits["max_ref_tokens"]:
            return False
        picked.append(r)
        slots.add(window.served[r].slot)
        served += window.served[r].req.budget
        total += size(r)
        return True

    for r in order:
        if len(slots) >= limits["min_requests"]:
            break
        if window.served[r].slot not in slots:
            take(r)
    for r in order:
        if served >= limits["served_tokens_target"]:
            break
        if r not in picked:
            take(r)
    return picked


def gap_numbers(gaps: np.ndarray) -> Dict[str, float]:
    """The numbers a check can compare, from per-token gaps: the widest
    (``max_logit_gap``), the 90th percentile and the median over tokens
    (``gap_p90``, ``gap_p50``), and the share of tokens that are not the
    reference's best (``flip_share``)."""
    return {"max_logit_gap": float(gaps.max()), "gap_p90": float(np.percentile(gaps, 90)),
            "gap_p50": float(np.percentile(gaps, 50)), "flip_share": float(np.mean(gaps > 0))}


def readings(window: Window, picked: List[int], model: model_mod.Model, seed: int, device,
             control: bool = False) -> Dict[str, Dict[str, float]]:
    """The check's numbers over the sampled requests' served tokens, against
    the fp32 reference: ``{"program": ...}``, and with ``control`` the fp8
    control's (``"control"``: the gaps of the tokens the fp8 forward puts
    first at the same positions), under the same names, so that
    :func:`checks` and :func:`passed` judge both alike."""
    seqs, served = [], []
    for r in picked:
        prompt = window.served[r].req.prompt.astype(np.int64)
        toks = np.asarray(window.results[r].tokens, dtype=np.int64)
        seqs.append((np.concatenate([prompt, toks[:-1]]), len(prompt) - 1))
        served.append(toks)
    base = {"checked_tokens": int(sum(len(t) for t in served)), "checked_requests": len(picked),
            "checked_slots": len({window.served[r].slot for r in picked})}
    out = {"program": dict(base)}
    if control:
        out["control"] = dict(base)
    if not picked:
        return out
    lg = reference.logits(model, seed, seqs, device, ("fp32", "fp8") if control else ("fp32",))
    gaps = torch.cat([reference.token_gaps(ref, toks) for ref, toks in zip(lg["fp32"], served)])
    out["program"].update(gap_numbers(gaps.cpu().numpy()))
    if control:
        low = torch.cat([reference.control_gaps(ref, lo) for ref, lo in zip(lg["fp32"], lg["fp8"])])
        out["control"].update(gap_numbers(low.cpu().numpy()))
    return out


def checks(read: Dict[str, float], failed: int, limits: dict) -> List[tuple]:
    """(name, value, rule, limit) of every number compared: each number the
    cell's limits file names under ``limits``, the request checks, and the
    sample's reach (tokens, and slots of the batch)."""
    rows = [(name, read.get(name, float("inf")), "<=", lim) for name, lim in limits["limits"].items()]
    return rows + [
        ("failed_requests", failed, "<=", 0),
        ("checked_tokens", read.get("checked_tokens", 0), ">=", limits["min_checked_tokens"]),
        ("checked_slots", read.get("checked_slots", 0), ">=", limits["min_requests"]),
    ]


def passed(rows: List[tuple]) -> bool:
    return all((v <= lim) if rule == "<=" else (v >= lim) for _, v, rule, lim in rows)


def device_info(device, chips: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, t_process: float,
             device="cuda", base: Path = spec.HERE, out=sys.stdout, err=sys.stderr,
             clock=time.perf_counter, sleep=time.sleep) -> dict:
    """One run; prints the result line on ``out`` and returns it.  ``clock``
    and ``sleep`` are the host's, or a test's stand-ins."""
    bench = spec.Benchmark(root, base)
    cell = bench.cell(workload)
    model = model_mod.load(bench.config_path(cell["config"]))
    traffic = Traffic(bench.traffic(cell["traffic"]), model.vocab, seed, seconds)
    limits = bench.limits(workload)
    program = Program(model, traffic, seed, device, traffic.slots)
    if trace and torch.device(device).type == "cuda":
        devtrace.Slice.warm()
    t_call = clock()
    win = Window(program, traffic, seconds, trace, clock, sleep).run()
    setup_s = win.w0 - t_process
    phases = dict(program.phases, ramp=win.w0 - t_call)
    print("setup " + " ".join(f"{k} {v:.2f}" for k, v in phases.items()) + f" s; total {setup_s:.2f} s", file=err)
    dev_info = device_info(device, int(cell.get("chips", 1)))
    if win.captured_in_window():
        print(f"portbench: {win.captured_in_window()} decode graphs captured in the window", file=err)
    win.eng = None
    program.free()
    view = RunView(model, win, setup_s, seconds, win.slice.summary() if win.slice else None, win.slice_work)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(workload, kind):
        value = bench.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    picked = sample(win, seed, limits)
    read = readings(win, picked, model, seed, device)["program"]
    rows = checks(read, win.failed(), limits)
    result = {"correct": passed(rows), "attempted": win.attempted(), "failed": win.failed(),
              "metrics": metrics, "device": dev_info}
    if view.trace is not None:
        result["device"]["busy_s"] = view.trace.busy_s
        result["device"]["window_s"] = view.trace.window_s
        result["breakdown"] = view.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim, "rule": rule} for name, v, rule, lim in rows}
    for name, v, rule, lim in rows:
        print(f"check {name} {v} {rule} {lim}", file=err)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}", file=err)
        raise SystemExit(3)
    print(json.dumps(result), file=out, flush=True)
    return result
