"""The general traffic generator: a mix's parameters in, requests out.

A traffic file (``traffic/<name>.json``) names the loop and the size
distributions::

    {"loop": "open", "rate_per_s": 3.0, "slots": 16, "ramp_s": 6.0,
     "prompt": {"dist": "lognormal", "median": 384, "sigma": 1.0, "min": 32, "max": 3072},
     "output": {"dist": "uniform", "min": 16, "max": 384}}

``loop`` is ``open`` (requests fall due on a schedule at ``rate_per_s``,
exponential gaps, whatever the server does) or ``closed`` (``slots`` clients,
each sending its next request the moment its last one ends).  ``ramp_s`` is
the untimed time before the measured window: from the call's start in an
open loop, from the last of the first ``slots`` requests' first tokens in a
closed one.  With ``stagger_ramp`` the first ``slots`` requests of a closed
loop are cut to ``(i + 1) / slots`` of their drawn budgets, so that the slots
do not all end together.  A distribution is ``lognormal`` (``median``,
``sigma``) or ``uniform``, clipped to [``min``, ``max``].

Every seed offers the same load.  Sizes and gaps come in blocks, each the
distribution's quantiles at ``(j + 0.5) / n`` for its ``n`` requests, in an
order drawn from the seed.  A closed loop's blocks are ``block`` requests
(default 32).  An open loop's are laid out in time: the ramp is one block of
``round(rate_per_s * ramp_s)`` requests and every block after it spans the
measured window, ``round(rate_per_s * window_s)`` requests whose gaps are
scaled to sum to ``window_s``, so the window holds the same requests, sizes
and gaps under every seed, in another order.  Token ids are uniform over the
vocabulary, drawn from the seed, with no shared prefix.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, Optional, Tuple

import numpy as np


GAPS = 2  # a block's table and order of gaps (0: prompt sizes, 1: answer sizes)


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: np.ndarray  # int32 [len]
    budget: int  # output tokens to serve
    due: float  # seconds after the call's start (open loop); 0.0 in a closed loop


def _quantile(dist: dict, q: float) -> float:
    kind = dist["dist"]
    if kind == "lognormal":
        return dist["median"] * math.exp(dist["sigma"] * statistics.NormalDist().inv_cdf(q))
    if kind == "uniform":
        return dist["min"] + (dist["max"] - dist["min"]) * q
    raise ValueError(f"unknown distribution {kind!r}; lognormal|uniform")


def _sizes(dist: dict, n: int) -> np.ndarray:
    """A block's sizes: the distribution's quantiles, rounded and clipped."""
    qs = [(j + 0.5) / n for j in range(n)]
    return np.clip(np.rint([_quantile(dist, q) for q in qs]), dist["min"], dist["max"]).astype(np.int64)


def _gaps(n: int) -> np.ndarray:
    """A block's gaps as shares of its span: the exponential's quantiles,
    scaled to sum to 1."""
    e = -np.log1p(-(np.arange(n) + 0.5) / n)
    return e / e.sum()


class Traffic:
    """The requests of one mix under one seed, made on demand by index.
    ``window_s``, the measured window's length, lays out an open loop's
    arrivals."""

    def __init__(self, spec: dict, vocab: int, seed: int, window_s: Optional[float] = None):
        if spec["loop"] not in ("open", "closed"):
            raise ValueError(f"loop must be open or closed, got {spec['loop']!r}")
        self.spec, self.vocab, self.seed = spec, vocab, int(seed)
        self.open = spec["loop"] == "open"
        self.slots = int(spec.get("slots", 16))
        self.ramp_s = float(spec.get("ramp_s", 0.0))
        self.rate = float(spec["rate_per_s"]) if self.open else 0.0
        if self.open:
            if window_s is None or window_s <= 0:
                raise ValueError("an open loop lays its arrivals out over the window: give window_s > 0")
            self.window_s = float(window_s)
            self.ramp_n = round(self.rate * self.ramp_s)
            self.window_n = max(1, round(self.rate * self.window_s))
            blocks = [(n, span) for n, span in ((self.ramp_n, self.ramp_s), (self.window_n, self.window_s)) if n]
        else:
            self.block = int(spec.get("block", 32))
            blocks = [(self.block, 0.0)]
        self._tables = {n: (_sizes(spec["prompt"], n), _sizes(spec["output"], n), _gaps(n)) for n, _ in blocks}
        self._shift = 0.5 * min(self._tables[n][GAPS].min() * span for n, span in blocks)
        self._offsets: Dict[int, np.ndarray] = {}
        self._orders: Dict[tuple, np.ndarray] = {}

    @property
    def max_prompt(self) -> int:
        return int(max(t[0].max() for t in self._tables.values()))

    @property
    def min_prompt(self) -> int:
        return int(min(t[0].min() for t in self._tables.values()))

    @property
    def max_output(self) -> int:
        return int(max(t[1].max() for t in self._tables.values()))

    def _where(self, i: int) -> Tuple[int, int, int]:
        """Request ``i``'s block, its place in the block and the block's size."""
        if not self.open:
            return i // self.block, i % self.block, self.block
        if i < self.ramp_n:
            return 0, i, self.ramp_n
        b, j = divmod(i - self.ramp_n, self.window_n)
        return b + (1 if self.ramp_n else 0), j, self.window_n

    def _order(self, block: int, what: int, n: int) -> np.ndarray:
        key = (block, what)
        if key not in self._orders:
            self._orders[key] = np.random.default_rng([self.seed & (2**63 - 1), block, what]).permutation(n)
        return self._orders[key]

    def _pick(self, table: int, i: int) -> float:
        b, j, n = self._where(i)
        return self._tables[n][table][self._order(b, table, n)[j]]

    def _span(self, b: int) -> Tuple[float, float]:
        """An open loop's block ``b``: its start after the call's start, and
        its length."""
        if self.ramp_n:
            if b == 0:
                return 0.0, self.ramp_s
            b -= 1
        return self.ramp_s + b * self.window_s, self.window_s

    def due(self, i: int) -> float:
        """Request ``i``'s due time, seconds after the call's start.  Every
        arrival is shifted by half the smallest gap, so that each lies
        clearly inside its block, and so inside or outside the window."""
        if not self.open:
            return 0.0
        b, j, n = self._where(i)
        start, span = self._span(b)
        if b not in self._offsets:
            gaps = self._tables[n][GAPS][self._order(b, GAPS, n)] * span
            self._offsets[b] = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
        return start + self._shift + float(self._offsets[b][j])

    def request(self, i: int) -> Request:
        length = int(self._pick(0, i))
        budget = int(self._pick(1, i))
        if not self.open and self.spec.get("stagger_ramp") and i < self.slots:
            budget = max(1, math.ceil(budget * (i + 1) / self.slots))
        rng = np.random.default_rng([self.seed & (2**63 - 1), i, 3])
        prompt = rng.integers(0, self.vocab, size=length, dtype=np.int64).astype(np.int32)
        return Request(i, prompt, budget, self.due(i))
