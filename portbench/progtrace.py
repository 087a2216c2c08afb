"""The program's own trace, read after a traced run: the scheduler's decode
records (``nf4_tpu_torch/utils/trace.py``) and decode attention's device
markers among the traced slice's events.  With ``port.py`` and
``harness.py``, the one module here that imports the program.

* :func:`records`: the decode records launched inside the slice's host
  bounds.  Both ends of a slice are synchronizations, so exactly their
  work ran in the slice.
* :func:`attn_device_s`: the device-busy time strictly between each begin
  marker and the end marker after it: decode attention's device time,
  inside graph replays too, the markers' own time left out.
* :func:`on_device_clock`: a record's host span on the events' clock, by
  the slice's own shift, as ``devtrace.Slice.summary`` maps the harness's
  spans.
* :func:`decode_attn_least_s`: the least time of the records' decode
  attention, from the model's published shapes and the positions the
  records give.

A program without this trace (one older than it) has no records and no
markers: every reading is then None, never an error.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from . import devtrace, work

BEGIN = "nf4_mark_decode_attn_begin"
END = "nf4_mark_decode_attn_end"


def _marker(name: str) -> Optional[str]:
    """BEGIN or END for a marker kernel's event name, else None."""
    return BEGIN if BEGIN in name else END if END in name else None


def _slice(run):
    """The run's traced slice, once it has both bounds; else None."""
    sl = run.window.slice
    if run.trace is None or sl is None or sl.t0 is None or sl.t1 is None:
        return None
    return sl


def records(run) -> list:
    """The program's decode records launched inside the slice's host bounds
    ``[t0, t1]`` (``time.perf_counter_ns``); [] without a slice, or for a
    program that keeps none."""
    sl = _slice(run)
    if sl is None:
        return []
    try:
        from nf4_tpu_torch.utils import trace
    except ImportError:
        return []
    lo, hi = sl.t0[0], sl.t1[0]
    return [r for r in trace.DECODE_RECORDS if lo <= r.start_ns and r.end_ns <= hi]


def on_device_clock(span: Tuple[int, int], run) -> Tuple[int, int]:
    """A host span (``perf_counter_ns``) on the slice's device clock."""
    sl = run.window.slice
    shift = sl.t0[1] - sl.t0[0]
    return span[0] + shift, span[1] + shift


def marker_pairs(events: Sequence[Tuple[str, int, int]]) -> List[Tuple[int, int]]:
    """(end of a begin marker, start of the next end marker), in order.  A
    begin followed by another begin is dropped, and so is an end with no
    begin before it: unpaired markers at the slice's edges count nothing."""
    marks = sorted((a, b, _marker(name)) for name, a, b in events if _marker(name))
    pairs, opened = [], None
    for a, b, name in marks:
        if name == BEGIN:
            opened = b
        elif opened is not None:
            pairs.append((opened, a))
            opened = None
    return pairs


def attn_device_s(run) -> Optional[float]:
    """The union of the device's busy intervals strictly between each marker
    pair inside the slice, in seconds; None when the slice holds no pair."""
    sl = _slice(run)
    if sl is None:
        return None
    pairs = marker_pairs(sl.events)
    if not pairs:
        return None
    starts = [a for a, _ in pairs]
    pieces = []
    for name, a, b in sl.events:
        if _marker(name):
            continue
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(pairs) and pairs[k][0] < b:
            lo, hi = max(a, pairs[k][0]), min(b, pairs[k][1])
            if hi > lo:
                pieces.append((lo, hi))
            k += 1
    busy, _ = devtrace.union_busy(pieces, sl.t0[1], sl.t1[1])
    return busy / 1e9


def decode_attn_least_s(model, recs) -> float:
    """Least time of the decode records' attention: per record, step and
    layer, the larger of its bytes over 3.35 TB/s (each active slot's K and
    V up to its own position in bf16, its q and out) and its FLOPs over 989
    TFLOP/s (4 x head_dim x heads per visible key).  A slot at position p
    sees p + i + 1 keys at step i.  No key block, kv bucket or idle slot is
    work.  A speculative round's queries are not reckoned (its accepted
    length is the device's): a run that speculates reads low."""
    total = 0.0
    for r in recs:
        if r.kind != "decode" or len(r.positions) == 0:
            continue
        act, base = len(r.positions), float(sum(int(p) for p in r.positions))
        for i in range(r.n):
            keys = base + act * (i + 1)
            nbytes = keys * model.kv_dim * 2 * work.BF16 + act * model.q_dim * 2 * work.BF16
            flops = 4.0 * model.head_dim * model.heads * keys
            total += max(nbytes / work.PEAK_HBM_BYTES_S, flops / work.PEAK_BF16_FLOPS)
    return total * model.layers


def decode_attn_roofline(run) -> Optional[float]:
    """100 x the least time of the slice's decode attention over its device
    time between the markers; None without records or markers."""
    recs = records(run)
    busy = attn_device_s(run) if recs else None
    if not busy:
        return None
    return 100.0 * decode_attn_least_s(run.model, recs) / busy


def eager_step_pct(run) -> Optional[float]:
    """100 x the steps of the slice's records that no graph ran over all
    their steps; None without records."""
    recs = records(run)
    steps = sum(r.n for r in recs)
    if steps == 0:
        return None
    return 100.0 * sum(r.n for r in recs if not r.graphed) / steps


def eager_idle_pct(run) -> Optional[float]:
    """100 x the slice's device-idle time inside the ungraphed records'
    launch spans (on the device clock) over the slice's seconds; 0 when
    every record was graphed, None without records."""
    recs = records(run)
    if not recs:
        return None
    sl = run.window.slice
    lo, hi = sl.t0[1], sl.t1[1]
    _, busy = devtrace.union_busy([(a, b) for _, a, b in sl.events], lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    spans = sorted(on_device_clock((r.start_ns, r.end_ns), run) for r in recs if not r.graphed)
    overlap, k = 0, 0
    for a, b in spans:
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        j = k
        while j < len(idle) and idle[j][0] < b:
            overlap += max(0, min(b, idle[j][1]) - max(a, idle[j][0]))
            j += 1
    return 100.0 * overlap / (hi - lo)
