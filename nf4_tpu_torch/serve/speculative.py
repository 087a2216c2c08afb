"""Speculative decoding: prompt-lookup and draft-model drafts, verified in
one forward.

The port of the JAX package's ``serve/speculative.py``, function for
function.  Decode reads every weight byte to emit one token per slot;
verifying ``k`` drafted tokens in one forward reads the weights once for
``k + 1`` positions, so every accepted draft is a nearly free extra token.
The verify forward is the model's forward over the window
``slot_pos .. slot_pos + k`` with ``decode=True``
(``models/llama.py:forward``): its rows are decode rows, so their
projections route by count (B * (k + 1) <= 16 rows take the decode kernels
of B and D) and their attention is ``decode_attention``, which keeps a
row's logits a function of its own tokens and cache.

Drafts come from prompt lookup (the longest n-gram suffix of a slot's
history matched against its earlier occurrences, :func:`propose_ngram` on
the host, :func:`draft_ngram_device` on the device) or from a small draft
model run greedily (:func:`spec_chunk_draft`).  Two accept rules:

* greedy (:func:`spec_verify`): a draft is accepted iff it equals the
  model's argmax, so the tokens are plain greedy decode's for any drafts;
* stochastic (:func:`spec_verify_sampled`): speculative rejection
  sampling against each row's filtered distribution ``p``.  A draft is a
  point mass, so draft ``d`` is accepted with probability ``p(d)``; on the
  first rejection the token is drawn from ``p`` with ``d`` removed, after
  ``k`` accepts a bonus token from the last position's ``p``.  The emitted
  marginal at every position is ``p``.  Greedy rows reduce to the greedy
  rule, so mixed batches are fine.

Randomness is the port's counter-based noise (``serve/sampling.py``), never
torch's generator: one :class:`~nf4_tpu_torch.serve.sampling.KeyStream`
key per verify round, from which the uniforms, the residual draws and the
bonus draw each take a key of their own.  Key use does not depend on the
accept counts.  The distribution is the JAX package's, not its bits.

The chunk functions run ``n_steps`` rounds of draft, verify, history write
and advance with no host read, as Python loops over rounds (the JAX
package scans): what the Engine captures as one CUDA graph.  PyTorch idiom
in place of the JAX one: the cache, the history ``hist`` and the draft
cache are written in place (the JAX package returns new buffers), and the
sampled chunks take the key stream, not a key.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .sampling import BatchedSampling, _gumbel_argmax, _row_keys, filter_logits_batched, mix32

__all__ = [
    "propose_ngram",
    "draft_ngram_device",
    "draft_propose",
    "spec_verify",
    "spec_verify_sampled",
    "spec_chunk",
    "spec_chunk_sampled",
    "spec_chunk_draft",
    "spec_chunk_draft_sampled",
]

# Domain tags of the three keys a sampled verify round derives from its key.
_TAG_ACCEPT, _TAG_RESIDUAL, _TAG_BONUS = 0x3C6EF372, 0xA54FF53A, 0x510E527F


def propose_ngram(context: Sequence[int], k: int, max_ngram: int = 3) -> np.ndarray:
    """Propose ``k`` continuation tokens for ``context`` by prompt lookup
    (the JAX package's code).

    Finds the LAST earlier occurrence of the longest matching suffix
    n-gram (n = max_ngram down to 1) and returns the ``k`` tokens that
    followed it.  Always returns exactly ``k`` int32 tokens: short
    continuations are padded by repeating their final token, and when no
    n-gram recurs the last context token is proposed k times."""
    a = np.asarray(context, dtype=np.int64)
    length = int(a.size)
    out = None
    for n in range(min(max_ngram, length - 1), 0, -1):
        suf = a[length - n :]
        # Candidate starts i with a[i:i+n] == suf and at least one
        # continuation token; the suffix's own position is excluded by the
        # slice bound.
        starts = np.flatnonzero(a[: length - n] == suf[0])
        ok = np.ones(starts.size, dtype=bool)
        for j in range(1, n):
            ok &= a[starts + j] == suf[j]
        cand = starts[ok]
        if cand.size:
            i = int(cand[-1])
            out = a[i + n : i + n + k]
            break
    if out is None or out.size == 0:
        out = a[length - 1 :] if length else np.zeros(1, dtype=np.int64)
        out = out[:1]
    if out.size < k:
        out = np.concatenate([out, np.full(k - out.size, out[-1], dtype=np.int64)])
    return out.astype(np.int32)


def draft_ngram_device(hist: torch.Tensor, hlen: torch.Tensor, k: int, max_ngram: int = 3) -> torch.Tensor:
    """Prompt-lookup drafting on the device: static shapes, no host read,
    so a CUDA graph captures it (the JAX package's ``draft_ngram_device``).

    ``hist [B, S]`` int32: each slot's token history; entries at positions
    >= ``hlen[b]`` are stale and ignored.  ``hlen [B]`` int32: the valid
    history length per slot.  Returns drafts ``[B, k]`` int32: the tokens
    after the most recent earlier occurrence of the longest suffix n-gram,
    short or absent continuations clamped into the valid history."""
    b_sz, s_len = hist.shape
    dev = hist.device
    hlen = hlen.to(torch.int64)
    j = torch.arange(s_len, device=dev)[None, :]  # candidate starts
    best_start = torch.full((b_sz,), -1, dtype=torch.int64, device=dev)
    found = torch.zeros(b_sz, dtype=torch.bool, device=dev)
    for n in range(max_ngram, 0, -1):
        # match[b, j]: hist[b, j:j+n] equals the last n valid tokens, with a
        # continuation available (j + n <= hlen - 1), which also excludes
        # the suffix's own occurrence.
        match = torch.ones((b_sz, s_len), dtype=torch.bool, device=dev)
        for i in range(n):
            suf_i = hist.gather(1, torch.clamp(hlen - n + i, min=0)[:, None])
            shifted = torch.nn.functional.pad(hist[:, i:], (0, i))  # hist[b, j + i], stale past the end
            match &= shifted == suf_i
        valid = (j <= (hlen - n - 1)[:, None]) & (hlen >= n + 1)[:, None]
        cand = torch.where(match & valid, j, -1).amax(dim=1)  # the most recent
        hit = cand >= 0
        # The longest n wins: only rows still unmatched take a shorter one.
        best_start = torch.where(~found & hit, cand + n, best_start)
        found = found | hit
    start = torch.where(found, best_start, hlen - 1)
    idx = torch.minimum(start[:, None] + torch.arange(k, device=dev)[None, :], (hlen - 1)[:, None])
    return hist.gather(1, idx).to(torch.int32)


def draft_propose(dparams, cur_token, dcache, slot_pos, *, dfwd, steps: int):
    """``steps`` greedy decode steps of the draft model from ``cur_token``
    at ``slot_pos``: its proposals [B, steps] int32 and the draft cache,
    written at ``slot_pos .. slot_pos + steps - 1``.  ``dfwd(dparams, token,
    dcache, positions) -> (logits [B, V], dcache)`` is its decode step."""
    t, p, proposed = cur_token, slot_pos, []
    for _ in range(steps):
        logits, dcache = dfwd(dparams, t, dcache, p)
        t = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        proposed.append(t)
        p = p + 1
    return torch.stack(proposed, dim=1), dcache


def _window(cur_token, drafts, slot_pos, k: int):
    """The verify forward's tokens [B, k+1], positions [B, k+1] and the
    lengths after it [B]."""
    toks = torch.cat([cur_token[:, None], drafts], dim=1)
    pos = slot_pos[:, None] + torch.arange(k + 1, dtype=slot_pos.dtype, device=slot_pos.device)[None, :]
    return toks, pos, slot_pos + (k + 1)


def _accepted(accept: torch.Tensor) -> torch.Tensor:
    """The length of each row's accepted draft prefix [B] int32 from the
    per-position verdicts [B, k]."""
    return torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def _token_logprobs(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log P(targets) under the raw logits, [B, k+1]."""
    return torch.log_softmax(lg, dim=-1).gather(-1, targets.to(torch.int64)[..., None])[..., 0]


def spec_verify(params, cur_token, drafts, cache, slot_pos, *, fwd, k: int):
    """Verify ``k`` drafted tokens per slot in ONE forward.

    cur_token [B] int32: the last emitted (not yet consumed) token per
    slot; drafts [B, k] int32: its proposed continuations; slot_pos [B]
    int32: the position cur_token is written at.  ``fwd(params, tokens,
    cache, positions, seq_lens) -> (logits [B, S, V], cache)`` is the
    model's verify forward.

    Returns (targets [B, k+1], accepted [B], logprobs [B, k+1], cache):
    ``targets[:, i]`` is the greedy token after position i and slot ``s``
    emits ``targets[s, : accepted[s] + 1]``, exactly plain greedy decode's
    tokens.  All k+1 positions are written to the cache, rejected drafts
    too: the slot's next forward starts at ``slot_pos + accepted + 1 <=
    slot_pos + k + 1`` and writes every stale position before any query
    reads it."""
    toks, pos, seq_lens = _window(cur_token, drafts, slot_pos, k)
    logits, cache = fwd(params, toks, cache, pos, seq_lens)
    lg = logits.float()
    targets = torch.argmax(lg, dim=-1).to(torch.int32)
    accepted = _accepted(drafts == targets[:, :-1])
    return targets, accepted, _token_logprobs(lg, targets), cache


def _uniforms(key: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Uniforms [rows, cols] in (0, 1), hashed from ``key`` and each
    entry's index: 2**23 odd steps of 2**-24, exact in fp32."""
    idx = torch.arange(rows * cols, dtype=torch.int64, device=key.device)
    h = mix32(key ^ mix32(idx))
    return (((h >> 9) * 2 + 1).to(torch.float32) * (2.0**-24)).reshape(rows, cols)


def spec_verify_sampled(params, cur_token, drafts, cache, slot_pos, key, bp: BatchedSampling, *, fwd, k: int):
    """Stochastic counterpart of :func:`spec_verify`: ``key`` is the round's
    key (an int64 scalar tensor), ``bp`` the rows' :class:`BatchedSampling`.

    A draft ``d_i`` is accepted iff ``u_i < p_i(d_i)``, ``p_i`` the row's
    filtered sampling distribution at position i
    (:func:`~nf4_tpu_torch.serve.sampling.filter_logits_batched`, the
    pipeline the engine samples from); at the first rejection the emitted
    token is drawn from ``p_i`` with the draft removed, after k accepts a
    bonus token from ``p_k``.  Greedy rows (temperature 0) take the argmax
    rule.  The uniforms, the residual draws and the bonus draw each take a
    key derived from ``key``.  Same return and cache contract as
    :func:`spec_verify`; positions past ``accepted`` hold unemitted
    drafts."""
    b_sz = cur_token.shape[0]
    toks, pos, seq_lens = _window(cur_token, drafts, slot_pos, k)
    logits, cache = fwd(params, toks, cache, pos, seq_lens)
    lg = logits.float()  # [B, k+1, V]
    v = lg.shape[-1]
    argmax_tok = torch.argmax(lg, dim=-1).to(torch.int32)
    greedy = bp.temperature == 0.0
    # Every position filtered with its row's parameters (rows b * (k+1) + i).
    bp_rep = BatchedSampling(*(f[:, None].expand(b_sz, k + 1).reshape(-1) for f in bp))
    filt = filter_logits_batched(lg.reshape(b_sz * (k + 1), v), bp_rep).reshape(b_sz, k + 1, v)
    p = torch.softmax(filt, dim=-1)
    d64 = drafts.to(torch.int64)[..., None]
    pd = p[:, :k].gather(-1, d64)[..., 0]
    u = _uniforms(mix32(key ^ _TAG_ACCEPT), b_sz, k)
    accept = torch.where(greedy[:, None], drafts == argmax_tok[:, :k], u < pd)
    accepted = _accepted(accept)
    # The residual draw at every draft position (only the first rejected one
    # is emitted) and the bonus draw after k accepts.  A row collapsed onto
    # its draft (p(d) == 1) cannot reject, so its all -inf residual row is
    # never taken.
    res_logits = filt[:, :k].scatter(-1, d64, float("-inf"))
    res_tok = _gumbel_argmax(res_logits.reshape(b_sz * k, v),
                             _row_keys(mix32(key ^ _TAG_RESIDUAL), b_sz * k, None, None)).reshape(b_sz, k)
    bonus_tok = _gumbel_argmax(filt[:, k], _row_keys(mix32(key ^ _TAG_BONUS), b_sz, None, None))
    # The token emitted if the round ends at each position.
    chosen = torch.where(greedy[:, None], argmax_tok, torch.cat([res_tok, bonus_tok[:, None]], dim=1))
    chosen_at = chosen.gather(1, accepted.to(torch.int64)[:, None])
    pos_idx = torch.arange(k + 1, device=lg.device)[None, :]
    full = torch.cat([drafts, chosen[:, k:]], dim=1)
    targets = torch.where(pos_idx == accepted[:, None], chosen_at, full).to(torch.int32)
    return targets, accepted, _token_logprobs(lg, targets), cache


def _advance(targets, accepted, tok, pos, active):
    """The next token and position of each slot after a round: the token
    at ``accepted`` and ``accepted + 1`` positions on; inactive slots keep
    theirs (frozen)."""
    nxt = targets.gather(1, accepted.to(torch.int64)[:, None])[:, 0]
    adv = accepted + 1
    if active is not None:
        nxt = torch.where(active, nxt, tok)
        adv = adv * active.to(adv.dtype)
    return nxt, pos + adv.to(pos.dtype)


def _stack_rounds(rounds):
    """(targets [n, B, k+1], accepted [n, B], logprobs [n, B, k+1]) of the
    rounds' outputs."""
    return tuple(torch.stack(t) for t in zip(*rounds))


def _chunk_scan(params, cur_token, hist, cache, slot_pos, verify, active, *, k: int, n_steps: int, ngram: int):
    """The prompt-lookup chunk body: per round, draft on the device, run
    ``verify`` (greedy or rejection sampling), write all k+1 emitted-or-
    stale tokens after the consumed prefix, advance.

    ``hist [B, S]`` holds each slot's context with ``slot_pos + 1`` valid
    entries (``hist[b, slot_pos[b]]`` is ``cur_token[b]``), written in
    place.  Only ``accepted + 1`` of a round's tokens advance the lengths;
    the next round's writes cover the stale rest.  ``active [B]`` bool
    (None: all): inactive slots ride along frozen (token and position
    held), their writes landing in a stale window that a refill's prefill
    overwrites before anything reads it."""
    tok, pos, rounds = cur_token, slot_pos, []
    b_idx = torch.arange(tok.shape[0], device=tok.device)[:, None]
    for _ in range(n_steps):
        drafts = draft_ngram_device(hist, pos + 1, k, ngram)
        targets, accepted, lps, cache = verify(params, tok, drafts, cache, pos)
        widx = (pos + 1).to(torch.int64)[:, None] + torch.arange(k + 1, device=tok.device)[None, :]
        hist[b_idx, torch.clamp(widx, max=hist.shape[1] - 1)] = targets
        tok, pos = _advance(targets, accepted, tok, pos, active)
        rounds.append((targets, accepted, lps))
    return (*_stack_rounds(rounds), cache, hist, tok, pos)


def spec_chunk(params, cur_token, hist, cache, slot_pos, active=None, *, fwd, k: int, n_steps: int, ngram: int = 3):
    """``n_steps`` chained GREEDY prompt-lookup verify rounds with no host
    read: draft on the device (:func:`draft_ngram_device`), verify
    (:func:`spec_verify`), append the emitted run to the history, repeat.
    History and cache contract: see :func:`_chunk_scan`.

    Returns (targets [n, B, k+1], accepted [n, B], logprobs [n, B, k+1],
    cache, hist, cur_token [B], slot_pos [B]): the last four let a
    following chunk start with no host copy."""

    def verify(params, tok, drafts, cache, pos):
        return spec_verify(params, tok, drafts, cache, pos, fwd=fwd, k=k)

    return _chunk_scan(params, cur_token, hist, cache, slot_pos, verify, active, k=k, n_steps=n_steps, ngram=ngram)


def spec_chunk_sampled(params, cur_token, hist, cache, slot_pos, keys, bp: BatchedSampling, active=None, *, fwd,
                       k: int, n_steps: int, ngram: int = 3):
    """Stochastic counterpart of :func:`spec_chunk`: each round takes the
    next key of ``keys`` (a :class:`~nf4_tpu_torch.serve.sampling.KeyStream`,
    whose counter lives on the device) and verifies by
    :func:`spec_verify_sampled`, so the first emitted token of every round
    is distributed as the row's filtered distribution.  One key per round,
    whatever the accept counts.  Same returns as :func:`spec_chunk`."""

    def verify(params, tok, drafts, cache, pos):
        return spec_verify_sampled(params, tok, drafts, cache, pos, keys.next(), bp, fwd=fwd, k=k)

    return _chunk_scan(params, cur_token, hist, cache, slot_pos, verify, active, k=k, n_steps=n_steps, ngram=ngram)


def _draft_chunk_scan(params, dparams, cur_token, dcache, cache, slot_pos, verify, active, *, dfwd, k: int,
                      n_steps: int):
    """The draft-model chunk body: per round, the draft model proposes
    greedily in k+1 decode steps (one more than the drafts, so a fully
    accepted round leaves the draft cache covering every position below
    the advanced ``slot_pos``), the target verifies, and both caches
    advance in lockstep.

    Draft-cache invariant: accepted positions hold the accepted tokens'
    draft K/V (an accepted token IS the draft token, on the same accepted
    prefix); rejected and stale positions are written by the next round's
    proposal before any of its queries reads them.  ``active`` freezes
    idle slots as :func:`_chunk_scan` does.  ``dfwd(dparams, token, dcache,
    positions) -> (logits [B, V], dcache)`` is the draft's decode step."""
    tok, pos, rounds = cur_token, slot_pos, []
    for _ in range(n_steps):
        proposed, dcache = draft_propose(dparams, tok, dcache, pos, dfwd=dfwd, steps=k + 1)
        targets, accepted, lps, cache = verify(params, tok, proposed[:, :k], cache, pos)
        tok, pos = _advance(targets, accepted, tok, pos, active)
        rounds.append((targets, accepted, lps))
    return (*_stack_rounds(rounds), cache, dcache, tok, pos)


def spec_chunk_draft(params, dparams, cur_token, dcache, cache, slot_pos, active=None, *, fwd, dfwd, k: int,
                     n_steps: int):
    """``n_steps`` chained GREEDY draft-model propose-and-verify rounds with
    no host read; see :func:`_draft_chunk_scan` for the lockstep contract.

    Returns (targets [n, B, k+1], accepted [n, B], logprobs, cache,
    dcache, cur_token [B], slot_pos [B])."""

    def verify(params, tok, drafts, cache, pos):
        return spec_verify(params, tok, drafts, cache, pos, fwd=fwd, k=k)

    return _draft_chunk_scan(params, dparams, cur_token, dcache, cache, slot_pos, verify, active, dfwd=dfwd, k=k,
                             n_steps=n_steps)


def spec_chunk_draft_sampled(params, dparams, cur_token, dcache, cache, slot_pos, keys, bp: BatchedSampling,
                             active=None, *, fwd, dfwd, k: int, n_steps: int):
    """Stochastic counterpart of :func:`spec_chunk_draft`: rejection-
    sampling verify, one key of ``keys`` per round.  The draft's proposal
    stays greedy (a deterministic proposal).  Same returns."""

    def verify(params, tok, drafts, cache, pos):
        return spec_verify_sampled(params, tok, drafts, cache, pos, keys.next(), bp, fwd=fwd, k=k)

    return _draft_chunk_scan(params, dparams, cur_token, dcache, cache, slot_pos, verify, active, dfwd=dfwd, k=k,
                             n_steps=n_steps)
