"""SFT batch construction: padding and example packing with loss masks.

The port's own copy of the JAX package's ``train/data.py`` (numpy only, so
the two produce identical arrays): these helpers turn (prompt,
completion) token-id pairs into the fixed-shape arrays
``models.llama.train_forward`` consumes:

* ``pad_sft`` — one example per row, padded to ``seq_len``.  Simple, but
  short examples waste compute on padding.
* ``pack_sft`` — first-fit-decreasing packing of many examples per row.
  Attention stays EXACT: each row carries ``segment_ids`` (block-diagonal
  attention — a token never sees another example) and segment-relative
  ``positions`` (RoPE phases restart per example), so a packed batch
  computes the same per-example logits as separate rows.

Loss-mask convention (matches ``trainer.lm_loss``): ``loss_mask[b, t]``
weights the prediction OF token ``t`` (from slot ``t-1``).  Completion
tokens get weight 1; prompts, padding, and every segment's first slot
(no same-segment context to predict it from) get 0.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

__all__ = ["SFTBatch", "pad_sft", "pack_sft"]


@dataclasses.dataclass(frozen=True)
class SFTBatch:
    """Host-side arrays for one training batch.

    ``spans[i] = (row, start, length)`` locates input example ``i`` —
    useful for aligning packed logits with per-example rows in tests.
    """

    tokens: np.ndarray  # [B, S] int32
    loss_mask: np.ndarray  # [B, S] float32
    positions: np.ndarray  # [B, S] int32, segment-relative
    segment_ids: np.ndarray  # [B, S] int32, -1 = padding
    spans: Tuple[Tuple[int, int, int], ...]

    @property
    def efficiency(self) -> float:
        """Fraction of slots carrying real tokens (packing quality)."""
        return float((self.segment_ids >= 0).mean())


def _check(examples: Sequence[Tuple[Sequence[int], Sequence[int]]], seq_len: int):
    lens = []
    for i, (p, c) in enumerate(examples):
        if len(p) == 0:
            raise ValueError(
                f"example {i}: empty prompt — prepend a BOS token so the "
                "first completion token has same-segment context"
            )
        if len(c) == 0:
            raise ValueError(f"example {i}: empty completion")
        n = len(p) + len(c)
        if n > seq_len:
            raise ValueError(
                f"example {i}: length {n} > seq_len {seq_len}; truncate first"
            )
        lens.append(n)
    return lens


def _alloc(b: int, seq_len: int, pad_id: int):
    return (
        np.full((b, seq_len), pad_id, np.int32),
        np.zeros((b, seq_len), np.float32),
        np.zeros((b, seq_len), np.int32),
        np.full((b, seq_len), -1, np.int32),
    )


def _place(arrays, row, start, seg, prompt, completion):
    tokens, mask, positions, segs = arrays
    n_p, n_c = len(prompt), len(completion)
    n = n_p + n_c
    tokens[row, start : start + n_p] = prompt
    tokens[row, start + n_p : start + n] = completion
    # Weight completion tokens; slot 0 of a segment is never a completion
    # (prompts are non-empty), so every weighted target has in-segment
    # context.
    mask[row, start + n_p : start + n] = 1.0
    positions[row, start : start + n] = np.arange(n, dtype=np.int32)
    segs[row, start : start + n] = seg
    return (row, start, n)


def pad_sft(
    examples: Sequence[Tuple[Sequence[int], Sequence[int]]],
    seq_len: int,
    pad_id: int = 0,
) -> SFTBatch:
    """One example per row, padded to ``seq_len``."""
    _check(examples, seq_len)
    arrays = _alloc(len(examples), seq_len, pad_id)
    spans = tuple(
        _place(arrays, i, 0, 0, list(p), list(c))
        for i, (p, c) in enumerate(examples)
    )
    return SFTBatch(*arrays, spans=spans)


def pack_sft(
    examples: Sequence[Tuple[Sequence[int], Sequence[int]]],
    seq_len: int,
    pad_id: int = 0,
) -> SFTBatch:
    """First-fit-decreasing packing: several examples per row, exact
    attention via ``segment_ids`` + segment-relative ``positions``."""
    lens = _check(examples, seq_len)
    order = sorted(range(len(examples)), key=lambda i: -lens[i])
    rows: list[list[int]] = []  # example indices per row
    space: list[int] = []
    at: dict[int, Tuple[int, int]] = {}  # example -> (row, start)
    for i in order:
        for r in range(len(rows)):
            if space[r] >= lens[i]:
                at[i] = (r, seq_len - space[r])
                rows[r].append(i)
                space[r] -= lens[i]
                break
        else:
            at[i] = (len(rows), 0)
            rows.append([i])
            space.append(seq_len - lens[i])

    arrays = _alloc(len(rows), seq_len, pad_id)
    spans = []
    for i, (p, c) in enumerate(examples):
        row, start = at[i]
        seg = rows[row].index(i)
        spans.append(_place(arrays, row, start, seg, list(p), list(c)))
    return SFTBatch(*arrays, spans=tuple(spans))
