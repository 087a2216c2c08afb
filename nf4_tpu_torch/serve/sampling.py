"""Token sampling: the port of the JAX package's ``serve/sampling.py``.

:class:`SamplingParams` is one request's strategy; :class:`BatchedSampling`
holds the same fields as ``[B]`` tensors, one row per decode slot, so one
decode program (a CUDA graph on the card) serves every parameter mix.
:func:`sample_batched` keeps the JAX package's math and order: the
repetition / presence / frequency penalties, then ``logit_bias``, then
temperature; top-k keeps every entry at or above the k-th largest value
(ties kept), min-p drops what is below ``min_p`` times the row's largest
probability, top-p keeps the smallest prefix of the sorted row with
``cum - p < top_p`` (the top token always); greedy rows take the fp32
argmax, the first index on ties.

Randomness never comes from torch's global generator.  A stochastic draw
is Gumbel-max over counter-based noise: token = argmax(filtered logits +
g), g = -log(-log(u)), u a hash of (row key, token id).  The hash works on
int64 tensors masked to 32 bits, so the noise is the same on the CPU and
the card, and a CUDA graph needs no generator state: the keys come from
device buffers it reads.  A row's key is

- for a row with a ``seed``: a hash of (seed, step), the step being the
  tokens the request has generated so far, so its noise is a pure
  function of (seed, step), whatever its batchmates or the chunking (its
  tokens also follow its logits, which the Engine keeps independent of
  its batchmates' positions and the chunking, but not of the size of the
  group its prompt prefilled in: see ``serve/engine.py``);
- otherwise: a hash of (the draw's key, the row's index), the draw's key
  coming from a :class:`KeyStream` (the Engine's ``seed`` and a draw
  counter kept on the device).

The bits of ``jax.random`` are not reproduced: stochastic tokens follow
the JAX package's distribution, not its tokens.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

__all__ = [
    "SamplingParams",
    "BatchedSampling",
    "KeyStream",
    "apply_repetition_penalty",
    "sample",
    "sample_batched",
    "filter_logits_batched",
]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled
    # min-p filtering: drop tokens whose probability is below
    # min_p * max_probability (0 => disabled).
    min_p: float = 0.0
    # Divide logits of already-generated tokens by this factor (> 1
    # discourages repeats; 1 => disabled).  Applied to positive logits as
    # division and negative as multiplication, the standard CTRL rule.
    repetition_penalty: float = 1.0
    # OpenAI-style additive penalties (0 => disabled), applied after the
    # repetition penalty: logits -= presence_penalty * (count > 0)
    #                              + frequency_penalty * count,
    # where count is how many times the token was generated this request.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # Per-token logit offsets ((token_id, bias) pairs; a tuple so the
    # dataclass stays hashable).  Added after the penalties and before
    # greedy argmax / filtering, so +-large values force / ban tokens in
    # every mode.  The engine densifies these to a device-resident [B, V]
    # row per slot.
    logit_bias: tuple = ()
    # Host-side per-request controls (checked by the engine's scheduler,
    # never part of a device program):
    # extra end-of-sequence token ids on top of the engine's eos_token and
    # generate()'s stop_tokens argument.
    stop_tokens: tuple = ()
    # Generation budget override; None defers to generate()'s
    # max_new_tokens argument.
    max_new_tokens: Optional[int] = None
    # GUIDED CHOICE: constrain the output to be exactly one of these
    # token sequences (a tuple of int tuples).  The engine masks each
    # step's logits to the tokens consistent with some choice (within a
    # sampling mode: greedy picks the highest-logit allowed token,
    # stochastic samples among allowed) and finishes at the first full
    # match.  The request's budget is auto-extended to the longest
    # choice.  Host-side scheduler field.
    choices: tuple = ()
    # Suppress end-of-sequence until this many tokens are generated: the
    # engine bans its eos_token and this request's stop tokens (a -1e9
    # dense-bias row, lifted once the count is reached) so short prompts
    # cannot end instantly.  0 disables.
    min_new_tokens: int = 0
    # Record the top-N (token, logprob) alternatives of the model's raw
    # next-token distribution at every generated position (OpenAI
    # completions' integer ``logprobs`` / chat's ``top_logprobs``).
    # Host-side: the engine requests top-max(N) from the device once per
    # step and slices per request; 0 disables.
    top_logprobs: int = 0
    # Reproducible sampling: when set, this request's token stream depends
    # ONLY on (seed, tokens-generated-so-far) — identical across batch
    # compositions, decode chunk sizes, and engine restarts.  None (the
    # default) uses the engine's shared key stream.  Honored by the
    # engine; plain sample()/sample_batched() callers must pass the
    # per-row step index themselves (see sample_batched's step_idx).
    seed: Optional[int] = None


_M32 = 0xFFFFFFFF
# Domain tags, so a seeded row's key, a shared draw's key and a row's
# offset in a shared draw never come from the same hash input.
_TAG_SEED, _TAG_STREAM, _TAG_ROW, _TAG_TOKEN = 0x5EED5EED, 0x0C0FFEE5, 0x2545F491, 0x6A09E667


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): in two 16-bit
    halves of ``c``, so no product leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (``lowbias32``) of int64 values in [0, 2**32),
    elementwise; the same bits on every device."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix_int(v: int) -> int:
    return int(mix32(torch.tensor(v & _M32, dtype=torch.int64)))


class KeyStream:
    """A stream of draw keys on ``device``: key i = hash(seed, i), with the
    counter i in a device buffer that :meth:`next` advances in place, so a
    CUDA graph that draws advances it at every replay."""

    def __init__(self, seed: int, device):
        self.base = _mix_int(seed ^ _TAG_STREAM)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)

    def next(self) -> torch.Tensor:
        """The next draw's key (an int64 scalar tensor)."""
        key = mix32((self.counter & _M32) ^ self.base)
        self.counter += 1
        return key


class BatchedSampling(NamedTuple):
    """Per-row sampling parameters as ``[B]`` tensors on one device — the
    engine's per-request sampling representation.  Field semantics match
    :class:`SamplingParams` row-wise; a disabled filter (top_k 0, top_p 1,
    min_p 0, penalty 1) leaves that row untouched."""

    temperature: torch.Tensor  # [B] fp32
    top_k: torch.Tensor  # [B] int32
    top_p: torch.Tensor  # [B] fp32
    min_p: torch.Tensor  # [B] fp32
    repetition_penalty: torch.Tensor  # [B] fp32
    presence_penalty: torch.Tensor  # [B] fp32
    frequency_penalty: torch.Tensor  # [B] fp32
    seed: torch.Tensor  # [B] int64, the seed's low 32 bits (0 when unseeded)
    has_seed: torch.Tensor  # [B] bool

    @staticmethod
    def stack(params: Sequence[SamplingParams], device) -> "BatchedSampling":
        f32, dev = torch.float32, torch.device(device)
        return BatchedSampling(
            temperature=torch.tensor([p.temperature for p in params], dtype=f32, device=dev),
            top_k=torch.tensor([p.top_k for p in params], dtype=torch.int32, device=dev),
            top_p=torch.tensor([p.top_p for p in params], dtype=f32, device=dev),
            min_p=torch.tensor([p.min_p for p in params], dtype=f32, device=dev),
            repetition_penalty=torch.tensor([p.repetition_penalty for p in params], dtype=f32, device=dev),
            presence_penalty=torch.tensor([p.presence_penalty for p in params], dtype=f32, device=dev),
            frequency_penalty=torch.tensor([p.frequency_penalty for p in params], dtype=f32, device=dev),
            seed=torch.tensor([(p.seed or 0) & _M32 for p in params], dtype=torch.int64, device=dev),
            has_seed=torch.tensor([p.seed is not None for p in params], dtype=torch.bool, device=dev),
        )

    def copy_(self, other: "BatchedSampling") -> None:
        """Overwrite these tensors in place (static buffers of a graph)."""
        for mine, theirs in zip(self, other):
            mine.copy_(theirs)


def apply_repetition_penalty(
    logits: torch.Tensor,  # [B, V] fp32
    generated_mask: torch.Tensor,  # [B, V] bool — True where a token was emitted
    penalty: float,
) -> torch.Tensor:
    """CTRL-style repetition penalty on previously generated tokens."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(generated_mask, penalized, logits)


def _row_keys(
    key: torch.Tensor, rows: int, bp: Optional[BatchedSampling], step_idx: Optional[torch.Tensor]
) -> torch.Tensor:
    """Each row's noise key [B] (module docstring): the draw's key mixed
    with the row index; seeded rows (when ``step_idx`` is given) a hash of
    (seed, step) alone."""
    row = torch.arange(rows, dtype=torch.int64, device=key.device)
    keys = mix32(key ^ mix32(row ^ _TAG_ROW))
    if bp is None or step_idx is None:
        return keys
    seeded = mix32(mix32(bp.seed ^ _TAG_SEED) ^ (step_idx.to(torch.int64) & _M32))
    return torch.where(bp.has_seed, seeded, keys)


def _gumbel_argmax(logits: torch.Tensor, row_keys: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) (-inf entries never drawn):
    argmax of logits + Gumbel noise, the noise hashed from (row key, token
    id).  u takes 2**23 odd steps of 2**-24 in (0, 1), exact in fp32."""
    v = logits.shape[-1]
    ids = mix32(torch.arange(v, dtype=torch.int64, device=logits.device) ^ _TAG_TOKEN)
    h = mix32(row_keys[:, None] ^ ids[None, :])
    u = ((h >> 9) * 2 + 1).to(torch.float32) * (2.0**-24)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
    key: Optional[torch.Tensor] = None,
    generated_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pick next tokens [B] from logits under one strategy for every row."""
    logits = logits.float()
    if generated_mask is not None and params.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, generated_mask, params.repetition_penalty)
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        raise ValueError("stochastic sampling requires a key")
    bp = BatchedSampling.stack([params] * logits.shape[0], logits.device)
    return _gumbel_argmax(filter_logits_batched(logits, bp), _row_keys(key, logits.shape[0], None, None))


def filter_logits_batched(
    logits: torch.Tensor,  # [B, V] fp32 (penalties already applied)
    bp: BatchedSampling,
) -> torch.Tensor:
    """Row-wise temperature scaling + top-k / min-p / top-p filtering.

    Returns logits with filtered-out entries at -inf; ``softmax`` of the
    result is each row's target sampling distribution (greedy rows are
    scaled by temperature 1 and left unfiltered — callers special-case
    them with argmax)."""
    v = logits.shape[-1]
    neg = float("-inf")
    greedy = bp.temperature == 0.0
    lg = logits / torch.where(greedy, torch.ones_like(bp.temperature), bp.temperature)[:, None]

    k = bp.top_k.clamp(0, v)
    sorted_asc = torch.sort(lg, dim=-1).values
    kth = sorted_asc.gather(-1, (v - k).clamp(0, v - 1)[:, None].to(torch.int64))
    lg = lg.masked_fill((k > 0)[:, None] & (lg < kth), neg)

    probs = torch.softmax(lg, dim=-1)
    cutoff = bp.min_p[:, None] * probs.max(dim=-1, keepdim=True).values
    lg = lg.masked_fill((bp.min_p > 0.0)[:, None] & (probs < cutoff), neg)

    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < bp.top_p[:, None]
    threshold = torch.where(keep, sorted_desc, torch.full_like(sorted_desc, float("inf"))).min(
        dim=-1, keepdim=True
    ).values
    return lg.masked_fill((bp.top_p < 1.0)[:, None] & (lg < threshold), neg)


def sample_batched(
    logits: torch.Tensor,  # [B, V]
    bp: BatchedSampling,
    key: Optional[torch.Tensor] = None,
    generated_mask: Optional[torch.Tensor] = None,
    step_idx: Optional[torch.Tensor] = None,
    logit_bias: Optional[torch.Tensor] = None,  # [B, V] fp32
) -> torch.Tensor:
    """Row-wise :func:`sample`: each row uses its own parameters.  Greedy
    rows (temperature 0) take their argmax whatever ``key`` is; ``key``
    None means no row is stochastic.

    ``step_idx`` [B] — each row's tokens-generated-so-far count; with it a
    seeded row draws from (seed, step) instead of the shared key
    (``None`` ignores seeds).

    ``generated_mask`` is per-row emitted-token state: bool [B, V]
    (repetition penalty only) or int32 counts [B, V] (also enables the
    additive presence/frequency penalties)."""
    logits = logits.float()
    if generated_mask is not None:
        is_counts = generated_mask.dtype != torch.bool
        emitted = generated_mask > 0 if is_counts else generated_mask
        pen = bp.repetition_penalty[:, None]
        penalized = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where(emitted & (pen != 1.0), penalized, logits)
        if is_counts:
            cnt = generated_mask.float()
            logits = logits - (bp.presence_penalty[:, None] * emitted.float() + bp.frequency_penalty[:, None] * cnt)
    if logit_bias is not None:
        logits = logits + logit_bias

    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        return greedy_tok
    lg = filter_logits_batched(logits, bp)
    stoch_tok = _gumbel_argmax(lg, _row_keys(key, logits.shape[0], bp, step_idx))
    return torch.where(bp.temperature == 0.0, greedy_tok, stoch_tok)
