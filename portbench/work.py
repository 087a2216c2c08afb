"""The yardstick's arithmetic: the card's peaks, percentiles, and the
operations and bytes of the work a window ran, from the model's published
shapes and the tokens served.

The count never depends on which kernel ran:

* A token's model FLOPs are 2 x its active parameters (the projections, the
  top-k experts' share of an MoE layer) plus attention at 4 x q_dim x
  context per layer, and 2 x the lm_head's for each token whose logits are
  served: every decoded token, a prompt's last.  A prompt's attention is
  causal, position p seeing p + 1 keys.
* A projection's least time is the larger of its bytes over the card's
  bandwidth (the weight's 4-bit values and fp32 block scales at its
  published m x n, read once per forward, and its activations in and out)
  and its FLOPs over the bf16 peak.  Rows are the tokens the window ran: a
  prefill segment's real prompt tokens, a decode step's active slots; the
  padding of a prompt to its bucket, of an idle slot, or of a weight to the
  program's tiles is not work.
  An MoE layer's experts are each counted as read once per forward, all of
  them: at 16 decode rows x 2 routes over 8 experts an expert is missed with
  probability (6/8)^16 ~ 1%, and a prefill reaches every one.  Their FLOPs
  are the top-k share, the rows routed to each being rows x k / E.
* Kernel C's least time is the larger of its causal FLOPs (4 x head_dim x
  heads per visible query-key pair of the prompt's real tokens) over the bf16
  peak and its bytes (q and out of the real queries, K and V up to the
  prompt's end) over the bandwidth.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from .model import Model
from .weights import NF4_BLOCK, projections

# NVIDIA's H100 SXM data sheet, dense rates.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16 = 2

# The program's prefill attention dispatch (ops/attention.py): kernel C takes
# a prompt segment of S >= 256 rows when rows x heads x S x cache length
# reaches 2^27, at head sizes 64 and multiples of 128.
FLASH_MIN_ROWS = 256
FLASH_MIN_SCORES = 1 << 27
# The program's prefill segment (serve/engine.py, Engine.PREFILL_SEGMENT).
PREFILL_SEGMENT = 2048


def percentile(values: Sequence[float], pct: float) -> Optional[float]:
    """The ``pct`` percentile with linear interpolation between order
    statistics (numpy's default); None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), pct))


def layer_params(model: Model) -> int:
    """Parameters a token multiplies in the layers: every projection, the
    top-k experts' share of an MoE MLP."""
    total = 0
    for _, m, n, e in projections(model):
        total += m * n * (model.top_k if e else 1)
    return total * model.layers


def prompt_flops(model: Model, length: int) -> float:
    """Model FLOPs of a prompt of ``length`` tokens: every token through the
    layers, causal attention, the logits of its last token."""
    pairs = length * (length + 1) / 2  # the sum of p + 1
    return (2.0 * (layer_params(model) * length + model.vocab * model.hidden)
            + 4.0 * model.q_dim * pairs * model.layers)


def proj_least_s(model: Model, rows: int) -> float:
    """Least time of one forward's packed projections over ``rows`` rows."""
    total = 0.0
    for _, m, n, e in projections(model):
        weight = n * m / 2 + -(-n // NF4_BLOCK) * m * 4
        calls, routed = (e, rows * model.top_k / e) if e else (1, rows)
        io = routed * (n + m) * BF16
        flops = 2.0 * routed * m * n
        total += calls * max((weight + io) / PEAK_HBM_BYTES_S, flops / PEAK_BF16_FLOPS)
    return total * model.layers


def flash_eligible(model: Model, rows: int, width: int) -> bool:
    """Does the program's prefill of ``rows`` rows x ``width`` positions take
    kernel C (its dispatch rule, at the cache length ``max_seq``)?"""
    return (width >= FLASH_MIN_ROWS and rows * model.heads * width * model.max_seq >= FLASH_MIN_SCORES
            and (model.head_dim == 64 or model.head_dim % 128 == 0))


def flash_least_s(model: Model, lengths: Iterable[int], t0: int, width: int) -> float:
    """Least time of kernel C over one prefill segment of every layer:
    queries at positions t0 .. t0 + width - 1, each row's real tokens only."""
    flops = nbytes = 0.0
    for length in lengths:
        end = min(int(length), t0 + width)
        if end <= t0:
            continue
        pairs = (end * (end + 1) - t0 * (t0 + 1)) / 2
        flops += 4.0 * model.head_dim * model.heads * pairs
        nbytes += 2 * (end - t0) * model.q_dim * BF16 + 2 * end * model.kv_dim * BF16
    return model.layers * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


@dataclasses.dataclass
class Work:
    """The work launched in an interval, counted from the harness's records of
    the program's decode and prefill calls."""

    model_flops: float = 0.0
    proj_least_s: float = 0.0
    flash_least_s: float = 0.0
    decode_steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    prefill_calls: int = 0
    flash_calls: int = 0

    def add_decode(self, model: Model, n: int, rows: int, positions: np.ndarray) -> None:
        """``n`` steps over the active slots, at ``positions`` (the
        position each writes at its first step); ``rows``, the batch the
        program runs, idle slots included, is not work."""
        act = len(positions)
        ctx = n * float(np.sum(positions + 1)) + act * n * (n - 1) / 2
        per_token = 2.0 * (layer_params(model) + model.vocab * model.hidden)
        self.model_flops += per_token * act * n + 4.0 * model.q_dim * ctx * model.layers
        self.proj_least_s += n * proj_least_s(model, act)
        self.decode_steps += n
        self.decode_tokens += act * n

    def add_prefill(self, model: Model, lengths: Sequence[int], bucket: int) -> None:
        """A group of prompts of ``lengths`` padded to ``bucket``, run in
        segments of ``PREFILL_SEGMENT`` positions."""
        g = len(lengths)
        for length in lengths:
            self.model_flops += prompt_flops(model, int(length))
        self.prefill_tokens += int(sum(lengths))
        self.prefill_calls += 1
        for t0 in range(0, bucket, PREFILL_SEGMENT):
            width = min(PREFILL_SEGMENT, bucket - t0)
            real = sum(max(0, min(int(length), t0 + width) - t0) for length in lengths)
            if real:
                self.proj_least_s += proj_least_s(model, real)
            if flash_eligible(model, g, width):
                self.flash_least_s += flash_least_s(model, lengths, t0, width)
                self.flash_calls += model.layers

    def minus(self, other: "Work") -> "Work":
        return Work(**{f.name: getattr(self, f.name) - getattr(other, f.name) for f in dataclasses.fields(self)})

    def copy(self) -> "Work":
        return dataclasses.replace(self)

