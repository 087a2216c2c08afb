"""The device trace of a run's traced slice, reduced to a few numbers.

A slice is a stretch of the measured window bounded by two synchronizations:
every piece of work launched between them ran on the device between them,
so the work the harness counted there and the trace's device time are of the
same work.  ``torch.profiler`` records the CUDA activity alone (kernels,
copies, fills: no host operators, so the host path keeps its speed); the
reduction keeps summaries, never the trace.

* ``busy_s``: the union of the device's busy intervals inside the slice (two
  streams' kernels that overlap count once), never more than the slice.
* kernel time by name, for the rooflines' readers and the breakdown;
* idle gaps, each labelled by the harness's host span that covers its
  midpoint (``host:<span>``; ``host:scheduler`` where the host was inside
  the program between the harness's calls).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type and argument list."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


def union_busy(intervals: Sequence[Tuple[int, int]], lo: int, hi: int) -> Tuple[int, List[Tuple[int, int]]]:
    """(busy ns, merged intervals) of ``intervals`` clipped to [lo, hi]."""
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]  # short kernel name -> device seconds in the slice
    idle_by_label: Dict[str, float]  # host label -> idle device seconds

    def kernel_time(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose names hold any of ``patterns``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def summarize(events: Sequence[Tuple[str, int, int]], lo: int, hi: int,
              spans: Sequence[Tuple[str, int, int]]) -> Summary:
    """Reduce device ``events`` (name, start ns, end ns) inside [lo, hi] with
    the host ``spans`` (label, start ns, end ns) on the same clock."""
    kernel = collections.Counter()
    for name, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            kernel[short_name(name)] += (b - a) / 1e9
    busy, merged = union_busy([(a, b) for _, a, b in events], lo, hi)
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    idle = collections.Counter()
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        label = "host:scheduler"
        if k >= 0 and spans[k][2] >= mid:
            label = "host:" + spans[k][0]
        idle[label] += (b - a) / 1e9
    return Summary(busy / 1e9, (hi - lo) / 1e9, dict(kernel), dict(idle))


class Slice:
    """One traced stretch: :meth:`start` and :meth:`stop` each synchronize
    the device first.  Host spans are recorded on ``time.perf_counter_ns``
    and mapped onto the profiler's clock (``time.time_ns``, checked against
    the first device event) at the slice's start."""

    def __init__(self):
        self.prof = None
        self.events: List[Tuple[str, int, int]] = []
        self.spans: List[Tuple[str, int, int]] = []
        self.t0 = self.t1 = None  # (perf_counter_ns, time_ns) at start and stop
        self.recording = False

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so that its first start's cost
        falls in set-up."""
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = (time.perf_counter_ns(), time.time_ns())
        self.recording = True

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = (time.perf_counter_ns(), time.time_ns())
        self.recording = False
        self.prof.stop()
        raw = self.prof.profiler.kineto_results.events()
        for e in raw:
            if str(e.device_type()).endswith("CUDA"):
                if hasattr(e, "start_ns"):
                    a, d = e.start_ns(), e.duration_ns()
                else:  # older releases: microseconds
                    a, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
                self.events.append((e.name(), a, a + d))
        self.prof = None

    def span(self, label: str, a_ns: int, b_ns: int) -> None:
        if self.recording:
            self.spans.append((label, a_ns, b_ns))

    def summary(self) -> Optional[Summary]:
        if self.t0 is None or self.t1 is None:
            return None
        shift = self.t0[1] - self.t0[0]  # perf_counter ns -> profiler ns
        lo, hi = self.t0[1], self.t1[1]
        first = min((a for _, a, _ in self.events if a >= lo - 10**9), default=None)
        if first is not None and abs(first - lo) > 5 * 10**8:
            # The profiler's clock is not the host's wall clock here: align
            # the first device event with the slice's start.
            print(f"portbench: device clock offset {(first - lo) / 1e9:.3f} s; aligned", file=sys.stderr)
            delta = first - lo
            self.events = [(n, a - delta, b - delta) for n, a, b in self.events]
        spans = [(label, a + shift, b + shift) for label, a, b in self.spans]
        return summarize(self.events, lo, hi, spans)
