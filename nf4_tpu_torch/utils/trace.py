"""The port's own trace: decode attention's device markers and the
scheduler's decode records.  Both are always on; there is no switch.

Device markers.  :func:`mark_decode_attn` launches one of two empty
one-thread kernels of ``csrc/mark.cu``, ``nf4_mark_decode_attn_begin`` and
``nf4_mark_decode_attn_end``, on the current stream.
``ops/attention.py:decode_attention`` launches the begin marker first and
the end marker last, so they are captured into every decode graph, and any
profiler capture of a serving process (``torch.profiler``, Nsight Systems)
shows decode attention's device time as the work between a begin and the
next end.  They are launched here, not through ``ops/_cuda.Kernel``, so
that ``launch_counts()`` counts the port's kernels alone.  On the CPU
nothing is launched.

Decode records.  Every decode launch of ``Engine.generate`` (a chunk, a
single step, a speculative chunk or verify round) appends one
:class:`DecodeRecord` to :data:`DECODE_RECORDS`, a ring of the newest
:data:`RING` records: its host span on ``time.perf_counter_ns``, its steps,
whether it was launched ahead of its predecessor's read-back, whether a
CUDA graph ran it, and the active slots' positions at its first step.  A
record costs two clock reads, one copy of the active positions and one
append.  Read the ring at the end of a run, never in the hot path.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import time
from typing import Deque

import numpy as np
import torch

__all__ = ["RING", "DECODE_RECORDS", "DecodeRecord", "mark_decode_attn", "record_decode"]

# The records a process keeps: a server that runs for days holds at most
# this many (~300 B each at 16 slots).
RING = 65536

_MARKS = {"begin": 0, "end": 1}
_mark_fn = None


def mark_decode_attn(which: str, t: torch.Tensor) -> None:
    """Launch decode attention's ``which`` ("begin" or "end") marker on the
    current stream when ``t`` is a CUDA tensor; nothing on the CPU."""
    global _mark_fn
    if not t.is_cuda:
        return
    if _mark_fn is None:
        from ..ops import _cuda

        fn = _cuda._load("mark").nf4_mark
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
        _mark_fn = fn
    err = _mark_fn(_MARKS[which], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nf4_mark({which}): CUDA launch failed with error {err}")


@dataclasses.dataclass(frozen=True)
class DecodeRecord:
    """One decode launch.  ``positions`` [active slots] is each active
    slot's position at the launch's first step (a slot at position p sees
    p + i + 1 keys at step i); for a speculative chunk launched ahead, the
    least it can be (each round advances a slot by at least one)."""

    start_ns: int  # time.perf_counter_ns() before the launch
    end_ns: int  # and after it returned
    n: int  # steps (decode) or verify rounds (spec)
    ahead: int  # 1: launched from its predecessor's device outputs, before that was read back
    graphed: bool  # a CUDA graph replay ran it
    positions: np.ndarray
    kind: str = "decode"  # or "spec"


DECODE_RECORDS: Deque[DecodeRecord] = collections.deque(maxlen=RING)


def record_decode(start_ns: int, n: int, ahead: int, graphed: bool, positions: np.ndarray,
                  kind: str = "decode") -> None:
    """Append the record of a launch that began at ``start_ns`` and has just
    returned; ``positions`` is kept as given (pass a copy)."""
    DECODE_RECORDS.append(DecodeRecord(start_ns, time.perf_counter_ns(), n, ahead, graphed, positions, kind))
