"""Serving engine: continuous batching over a fixed slot count.

The counterpart of the JAX package's ``serve/engine.py``.  A fixed batch
of slots decodes together; finished requests retire and their slots
refill from the queue (and, with ``admit``, from requests arriving while
the call runs); prompts are bucketed to powers of two and same-bucket
groups (of 4, 2 or 1) prefill together into their slots, in segments of
``PREFILL_SEGMENT`` tokens above that length; decode runs ``decode_chunk``
steps per host read-back, with idle slots riding along frozen under an
active-slot mask.  Params may be packed 4-bit or int8-recoded
(``recode_params_int8``), and the cache bf16 or int8 (``cfg.kv_quant``).

Sampling is per request (``serve/sampling.py``): each slot's parameters
live in a :class:`BatchedSampling` of static device buffers, written when
the slot refills, so one decode program serves every parameter mix.

Decode chunks (the JAX package's ``_decode_multi_impl`` and
``_decode_multi_impl_batched``): a :class:`Decoder` runs ``n`` decode and
sampling steps over one cache from static device buffers (tokens,
positions, the active mask and each slot's generated-token count in; the
chunk's tokens, token logprobs and top logprobs out).  It has two bodies:
the plain greedy one (fp32 argmax only), which a call runs while every
active request is plain greedy, and the per-request one
(:func:`sample_batched` with the emitted-token mask or counts, the dense
bias rows and the draw keys, all read from device buffers).  Every step of
a chunk reads the same ``kv_len``, :func:`kv_bucket` of the chunk's end,
so the shapes repeat; decode attention reads whole key blocks up to it
(``ops/attention.py:decode_attention``), and a slot's logits do not
depend on it: not on its batchmates' positions, the chunk size or the
pipeline.  (They can depend on the size of the group the slot's prompt
prefilled in, which picks the prefill's kernel branches.)  On CUDA every
chunk of ``decode_chunk`` steps is
one CUDA graph, captured once per (kv bucket, n, :class:`ChunkKind`) in
the Engine's lifetime and replayed on the current stream; the graphs of a
:class:`Decoder` share one memory pool.  Single steps (the budget's tail,
slots whose bias rows change every step), prefill and the CPU run
eagerly, with the same kv buckets, so graphed and eager decode give the
same bits.  A failed capture or replay raises: nothing falls back to the
eager loop (``cuda_graphs=False`` asks for eager chunks).

Pipelined decode (``pipeline_decode=True``, the JAX package's default):
chunk c+1 is launched from chunk c's device outputs (its last token and
advanced positions and counts) before chunk c is read back, so the host's
read-back and bookkeeping overlap the device's next chunk; if chunk c
ended a request, chunk c+1 is dropped (``pipeline_stats``).  The cache is
written in place, unlike the JAX package's functional buffers, and a
dropped chunk is still harmless: it wrote K/V only at positions past each
slot's consumed position; the re-run, or a new request's prefill,
rewrites each such position before any query can see it, because a query
sees no slot past its own position, and a decode step writes its position
before it attends.  So no second cache buffer is held (the JAX package
holds one while a chunk is in flight).  The emitted-token mask is written
in place too, so it is copied before a chunk is launched ahead and put
back when that chunk is dropped.  On the CPU the same launch and
read-back logic runs synchronously.

The Engine keeps one cache and one :class:`Decoder` (and so its graphs)
for its lifetime; each :meth:`Engine.generate` call hands them to a
:class:`_Scheduler`, which owns the per-call state.  The rows a slot
held for an earlier call stay in the cache, and they are invisible for
the reason a dropped chunk's are: a new request's prefill writes
positions 0 to its bucket's end, each decode step writes its position
before attending, and no query sees a slot past its own position.  One
call runs at a time.  Prefix caching, scoring, LoRA and tensor
parallelism are not ported yet.

Speculative decoding (``spec_k > 0``; ``serve/speculative.py``, the JAX
package's speculation): each round drafts ``spec_k`` tokens per slot, by
prompt lookup over the slot's history or from a draft model
(``draft=(params, cfg)``, run greedily over a cache of its own), and
verifies them in one forward of ``spec_k + 1`` decode rows; greedy rows
accept a draft iff it is the argmax (plain greedy's tokens), stochastic
rows by rejection sampling (the sampled distribution).  A call leaves
speculation to plain decode while an active request has a penalty, a
logit bias, a seed, a dynamic bias row (choices, ``min_new_tokens``) or
the call asks for top logprobs.  Rounds run ``decode_chunk`` at a time
with no host read, as a graph of the Decoder's pool on CUDA, keyed by
(kv_len, n, :class:`SpecKind`), kv_len the bucket of the chunk's worst-case
end (every round advancing ``spec_k + 1``); prompt lookup reads a static
device history ``[B, max_seq_len]`` that refills write and the chunks
extend, the draft model its own cache, prefilled at refill and kept in
lockstep.  Pipelined, a chunk's successor starts from its device outputs
when it cannot end a request on budget.  A round that does not fit a
chunk is one eager, host-stepped verify.  An adaptive controller pauses
speculation when the mean accepted drafts per round fall below
``spec_min_accept`` (plain decode serves a cooldown of ``spec_cooldown``
chunks, doubling on each failed probe up to ``spec_cooldown_max``); a
draft model's slots that fell behind during a pause catch up by grouped
continuation prefills.  A dropped speculative chunk has written target K/V,
history and draft K/V past the consumed state, all in place; each such
position is written again before any query reads it (a round writes its
window before it attends, drafts at a position before proposing from it,
and history entries before ``slot_pos + 1`` are the consumed ones), so
nothing is rolled back.  Idle slots verify frozen at position 0, in a
window (< 16 positions) that any refill's prefill overwrites.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.llama import KVCache, LlamaConfig, LlamaParams, check_supported, decode_step, forward, init_kv_cache
from ..ops._cuda import CountedGraph
from ..ops.attention import DECODE_KV_BLOCK, DECODE_MAX_QUERIES
from ..utils.device import resolve_device
from ..utils.shapes import bucket_len
from .sampling import BatchedSampling, KeyStream, SamplingParams, sample, sample_batched
from .speculative import (
    draft_propose,
    propose_ngram,
    spec_chunk,
    spec_chunk_draft,
    spec_chunk_draft_sampled,
    spec_chunk_sampled,
    spec_verify,
    spec_verify_sampled,
)

__all__ = ["Engine", "Decoder", "ChunkKind", "SpecKind", "GenerationResult", "kv_bucket"]

GREEDY = SamplingParams()
# The most top-logprob alternatives a request may ask for (OpenAI's cap);
# the Decoder's output buffers hold this many.
MAX_TOP_LOGPROBS = 20


@dataclasses.dataclass
class GenerationResult:
    prompt: List[int]
    tokens: List[int]  # generated tokens, without the prompt or the stop token
    finished: bool  # True if a stop token or a full choice ended it (False: budget, context or cancel)
    # log P(token | prefix) for each generated token, when the engine was
    # asked for them (generate(..., return_logprobs=True)); else None.
    logprobs: Optional[List[float]] = None
    # Top-N (token_id, logprob) alternatives of the raw next-token
    # distribution at each generated position, when the request's
    # SamplingParams.top_logprobs > 0; else None.
    top_logprobs: Optional[List[List[tuple]]] = None


def _top_logprobs(logits: torch.Tensor, k: int):
    """(values, token ids int32) of the top-k raw log-softmax per row [B, k]."""
    values, ids = torch.topk(torch.log_softmax(logits.float(), dim=-1), k)
    return values, ids.to(torch.int32)


def _token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log P(tokens) under log_softmax(logits); logits [B, V], tokens [B]."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(-1, tokens.to(torch.int64)[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class ChunkKind:
    """What the per-request chunk body computes besides its tokens and
    token logprobs, one graph each (the JAX package's trace-static keys):
    the top-``top_lp_k`` logprobs, the emitted-token state (``mask`` None,
    ``"bool"`` or ``"counts"``) and the dense bias rows.  The plain greedy
    body is kind ``None``."""

    top_lp_k: int = 0
    mask: Optional[str] = None
    bias: bool = False


@dataclasses.dataclass(frozen=True)
class SpecKind:
    """A speculative chunk's body, one graph each: ``k`` drafts per round,
    drafted by a ``draft`` model (else prompt lookup), verified by the
    ``greedy`` rule (else rejection sampling)."""

    k: int
    draft: bool
    greedy: bool


def _verify_forward(params, tokens, cache, positions, seq_lens, *, cfg, kv_len):
    """The verify forward (``spec_verify``'s ``fwd``): decode rows."""
    return forward(params, cfg, tokens, cache, positions, seq_lens, kv_len=kv_len, decode=True)


def _draft_step(params, token, cache, positions, *, cfg, kv_len):
    """One decode step of the draft model (the chunks' ``dfwd``)."""
    return decode_step(params, cfg, token, cache, positions, kv_len=kv_len)


def _spec_ok(p: SamplingParams) -> bool:
    """Can a request be served by speculation?  Not with the penalties (their
    token state would have to evolve across unaccepted drafts), a logit
    bias, or a seed (rejection sampling's key use follows the accept
    counts, which would break (seed, step) reproducibility)."""
    return (p.repetition_penalty == 1.0 and p.presence_penalty == 0.0 and p.frequency_penalty == 0.0
            and not p.logit_bias and p.seed is None)


def prefill_rows(params, cfg: LlamaConfig, cache: KVCache, tokens: np.ndarray, lengths: np.ndarray,
                 slots: np.ndarray, device, start: Optional[np.ndarray] = None, segment: int = 2048):
    """Prefill a group of token rows (each padded to the same bucket) into
    cache slots ``slots``; returns the last-token logits [G, V].  ``start``
    [G] is each row's first position (default 0: a prompt); a continuation
    from ``start`` sees the slot's cache below it, and its padding's
    positions are cut at the cache's last slot, which no valid query
    reads.

    The slots' cache rows (the int8 scale planes' too) are gathered, run
    through the model and scattered back (the JAX package's
    ``_prefill_impl``).  Buckets above ``segment`` run segment by segment,
    each attending to the cache the earlier ones wrote; each row's logits
    come from the segment holding its last token."""
    dev = device
    g, bucket = tokens.shape
    slots_t = torch.as_tensor(slots, dtype=torch.long, device=dev)
    slot_cache = KVCache(**{name: t[:, slots_t] for name, t in cache.planes().items()})
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    t_max = cache.k.shape[3]
    first = 0 if start is None else int(np.max(start))
    start_t = None if start is None else torch.as_tensor(start, dtype=torch.int32, device=dev)
    last = None
    for t0 in range(0, bucket, segment):
        width = min(segment, bucket - t0)
        positions = (t0 + torch.arange(width, dtype=torch.int32, device=dev)).expand(g, width)
        seq_lens = torch.clamp(lens, max=t0 + width)
        if start_t is not None:
            positions = torch.clamp(start_t[:, None] + positions, max=t_max - 1)
            seq_lens = start_t + seq_lens
        logits, _ = forward(params, cfg, toks[:, t0 : t0 + width], slot_cache, positions, seq_lens,
                            last_only=True, kv_len=min(first + t0 + width, t_max))
        here = torch.as_tensor((lengths - 1) // segment == t0 // segment, device=dev)
        last = logits if last is None else torch.where(here[:, None], logits, last)
    for name, t in slot_cache.planes().items():
        getattr(cache, name)[:, slots_t] = t
    return last


def kv_bucket(end: int, granularity: int, max_seq_len: int) -> int:
    """The ``kv_len`` of a decode chunk whose last step writes position
    ``end - 1``: ``end`` rounded up to a multiple of ``granularity``, at
    most ``max_seq_len``.  One value for the whole chunk."""
    return min(-(-end // granularity) * granularity, max_seq_len)


def _uses_mask(p: SamplingParams) -> bool:
    return p.repetition_penalty != 1.0 or p.presence_penalty != 0.0 or p.frequency_penalty != 0.0


def _uses_counts(p: SamplingParams) -> bool:
    return p.presence_penalty != 0.0 or p.frequency_penalty != 0.0


def _uses_bias(p: SamplingParams) -> bool:
    return bool(p.logit_bias) or p.min_new_tokens > 0 or bool(p.choices)


def _plain_greedy(p: SamplingParams) -> bool:
    """Served by the plain greedy body: fp32 argmax of the raw logits."""
    return p.temperature == 0.0 and not _uses_mask(p) and not _uses_bias(p) and p.top_logprobs == 0


class Engine:
    """Continuous-batching engine on ``device`` (default ``cuda``);
    ``params`` must already live there.  ``sampling`` is the default
    :class:`SamplingParams`; ``seed`` starts the key stream of requests
    without a seed of their own.  On CUDA, decode chunks are CUDA graph
    replays unless ``cuda_graphs=False``; ``pipeline_decode`` launches each
    chunk's successor before reading the chunk back.

    ``spec_k > 0`` turns on speculative decoding (module docstring): prompt
    lookup over ``spec_ngram``-grams, or a draft model with ``draft=(params,
    cfg)`` (the same vocabulary, a ``max_seq_len`` at least this model's,
    its params on ``device``).  The adaptive controller's fields
    (``spec_min_accept``, ``spec_cooldown``, ``spec_cooldown_max``) may be
    set after construction; ``spec_stats`` counts the verify rounds
    consumed, the tokens they emitted and the controller's pauses.

    ``pipeline_stats`` counts the chunks launched ahead of a read-back and
    those dropped because the chunk before them ended a request;
    ``graph_stats`` the decode graphs captured, the seconds their captures
    took, their replays and the largest memory pool they held (bytes)."""

    # Prompts longer than this prefill in segments: bounded activation
    # memory (the JAX package's value).
    PREFILL_SEGMENT = 2048
    # The granularity of a decode chunk's kv_len (kv_bucket): a multiple of
    # it bounds the cache slots decode attention reads, in its key blocks
    # of DECODE_KV_BLOCK (512) slots; each bucket is a graph of its own,
    # captured once per Engine.
    KV_BUCKET = DECODE_KV_BLOCK

    def __init__(
        self,
        params: LlamaParams,
        cfg: LlamaConfig,
        batch_size: int = 8,
        eos_token: int = 2,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        decode_chunk: int = 8,
        device=None,
        pipeline_decode: bool = True,
        cuda_graphs: bool = True,
        mesh=None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        draft=None,
        prefix_cache: bool = False,
        lora_bank=None,
    ):
        unported = {"mesh": mesh is not None, "prefix_cache": prefix_cache, "lora_bank": lora_bank is not None}
        if any(unported.values()):
            raise NotImplementedError(f"not ported yet: {', '.join(k for k, v in unported.items() if v)}")
        check_supported(cfg)
        # spec_k stays below the smallest prefill bucket (16), so a refill's
        # prefill overwrites the window an idle slot's verify wrote.
        if not 0 <= spec_k < DECODE_MAX_QUERIES:
            raise ValueError(f"spec_k must be in [0, {DECODE_MAX_QUERIES})")
        if draft is not None:
            if spec_k == 0:
                raise ValueError("draft= requires spec_k > 0")
            dcfg = draft[1]
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if dcfg.max_seq_len < cfg.max_seq_len:
                raise ValueError("draft max_seq_len must cover the target's")
            check_supported(dcfg)
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.eos_token = eos_token
        self.sampling = sampling
        self.decode_chunk = decode_chunk
        self.device = resolve_device(device)
        self.pipeline_decode = pipeline_decode
        self.pipeline_stats = {"launched": 0, "discarded": 0}
        self.graph_stats = {"captured": 0, "capture_s": 0.0, "replayed": 0, "pool_bytes": 0}
        self.keys = KeyStream(seed, self.device)
        self.spec_k, self.spec_ngram = spec_k, spec_ngram
        self._draft = None if draft is None else tuple(draft)
        # The adaptive controller (the JAX package's): below spec_min_accept
        # mean accepted drafts per round, speculation pauses for a cooldown
        # of plain decode chunks, which doubles on each failed probe up to
        # spec_cooldown_max and resets on a good one.
        self.spec_min_accept = 0.15
        self.spec_cooldown = 8
        self.spec_cooldown_max = 128
        self._spec_pause = 0
        self._spec_backoff = 0
        self.spec_stats = {"steps": 0, "emitted": 0, "pauses": 0}
        self.graph_stream = None
        self._cache: Optional[KVCache] = None
        self._decoder: Optional[Decoder] = None
        if cuda_graphs and self.device.type == "cuda":
            self.graph_stream = torch.cuda.Stream(self.device)
            self._warm_up()

    def _warm_up(self) -> None:
        """One eager decode step and one per-request sampling step of every
        mask kind on the capture stream over a throwaway cache, before any
        capture, and with ``spec_k`` one verify round of each accept rule
        (through the draft model with one): whatever the decode path makes
        at first use (the byte tables, the occupancy queries, the tile
        counters, cuBLAS's workspace for that stream, the kernels'
        shared-memory opt-in and tensor maps for the verify's row count,
        the sampler's kernels) then exists when a graph is captured.  Its
        launches count as eager ones."""
        width = min(16, self.cfg.max_seq_len)
        cache = init_kv_cache(dataclasses.replace(self.cfg, max_seq_len=width), self.batch_size, self.device)
        dcache = None
        if self._draft is not None:
            dcfg = dataclasses.replace(self._draft[1], max_seq_len=width)
            dcache = init_kv_cache(dcfg, self.batch_size, self.device)
        dec = Decoder(self, cache, dcache)
        self.graph_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.graph_stream):
            logits = dec.run_eager(1, width)
            tok, _, active, steps = dec.inputs
            for mask in ("bool", "counts"):
                kind = ChunkKind(1, mask, True)
                dec.prepare(kind)
                dec.sample_step(logits, tok, active != 0, steps, kind)
            for greedy in (True, False) if self.spec_k else ():
                dec.inputs[1:3] = torch.stack((torch.zeros_like(tok), torch.ones_like(tok)))  # from position 0
                dec.run_spec(1, width, SpecKind(self.spec_k, self._draft is not None, greedy))
        torch.cuda.synchronize(self.device)
        self.keys.counter.zero_()  # the warm-up's draws do not count

    def state(self):
        """The Engine's cache and :class:`Decoder`, made at first use and
        kept: every :meth:`generate` call decodes through them, so each
        graph is captured once per Engine."""
        if self._decoder is None:
            self._cache = init_kv_cache(self.cfg, self.batch_size, device=self.device)
            dcache = None
            if self._draft is not None:
                dcache = init_kv_cache(self._draft[1], self.batch_size, device=self.device)
            self._decoder = Decoder(self, self._cache, dcache)
        return self._cache, self._decoder

    @staticmethod
    def admissible(features, prompt, sp: SamplingParams, *, logprobs: bool = False, adapter=None) -> bool:
        """Can an in-flight generate() call (described by the ``features``
        dict its ``admit`` callback receives) serve this request?

        A generate() call allocates only the sampling machinery its
        INITIAL requests need (penalty masks, bias rows, top-k logprobs,
        per-token logprobs); a late request needing more must wait for the
        next call."""
        if logprobs and not features["return_logprobs"]:
            return False
        if len(prompt) == 0 or len(prompt) > features["max_prompt_len"]:
            return False
        if sp.top_logprobs > features["top_lp_k"]:
            return False
        needs_counts = _uses_counts(sp)
        if needs_counts and not features["use_counts"]:
            return False
        if (needs_counts or sp.repetition_penalty != 1.0) and not features["use_mask"]:
            return False
        if _uses_bias(sp) and not features["use_bias"]:
            return False
        # Multi-LoRA serving is not ported: no call serves an adapter.
        return adapter is None

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 64,
        sampling=None,
        return_logprobs: bool = False,
        stop_tokens: Optional[Sequence[int]] = None,
        on_token=None,
        adapter=None,
        admit=None,
        cancel=None,
    ) -> List[GenerationResult]:
        """Completions for all prompts, in prompt order (requests admitted
        during the call follow, in admission order).

        ``sampling`` is one :class:`SamplingParams` for the whole call, or
        one per prompt (``None`` entries take the engine's).  Generation
        ends at ``eos_token``, a stop token (``stop_tokens`` plus the
        request's own), the budget (``max_new_tokens`` unless the
        request's params override it; a ``choices`` request's covers its
        longest choice), a full choice, the context limit or a cancel.
        ``return_logprobs=True`` also records log P(token | prefix) of each
        generated token.  ``on_token(request_idx, token)`` is called as
        each token is read back (never for a stop token, unless the
        request has ``choices``).

        ``admit(features)``, when given, is called whenever a slot is idle
        and the queue is empty; it returns ``(prompt, SamplingParams or
        None, adapter)`` requests to join the running call, each of which
        must be :meth:`admissible` for ``features``.  If ``admit`` has a
        ``peek()`` attribute (True when a request is waiting), the
        pipelined chunk loop polls it between chunks and leaves the loop
        to refill an idle slot.

        ``cancel(request_idx) -> bool`` is polled at every host sync: a
        request reporting True retires with what it has
        (``finished=False``), none of the tokens read back after the poll;
        a cancelled queued request never prefills."""
        if adapter is not None:
            raise NotImplementedError("not ported yet: adapter (multi-LoRA serving)")
        if sampling is None:
            sampling = self.sampling
        if isinstance(sampling, SamplingParams):
            per_req = [sampling] * len(prompts)
        else:
            per_req = [p if p is not None else self.sampling for p in sampling]
            if len(per_req) != len(prompts):
                raise ValueError(
                    f"per-request sampling needs one SamplingParams per prompt "
                    f"(got {len(per_req)} for {len(prompts)} prompts)"
                )
        return _Scheduler(
            self, prompts, per_req, max_new_tokens, return_logprobs, stop_tokens, on_token, admit, cancel
        ).run()

    def score(self, prompts, batch_size=None, adapter=None):
        raise NotImplementedError("not ported yet: score (teacher-forced prompt logprobs)")

    # -- device work ----------------------------------------------------------

    def prefill_group(self, cache: KVCache, tokens: np.ndarray, lengths: np.ndarray, slots: np.ndarray):
        """Prefill a group of prompts (each padded to the same bucket) into
        cache slots ``slots``; returns the last-token logits [G, V]
        (:func:`prefill_rows`, in segments of ``PREFILL_SEGMENT``)."""
        return prefill_rows(self.params, self.cfg, cache, tokens, lengths, slots, self.device,
                            segment=self.PREFILL_SEGMENT)

    def prefill_draft(self, cache: KVCache, tokens: np.ndarray, lengths: np.ndarray, slots: np.ndarray,
                      start: Optional[np.ndarray] = None):
        """The draft model's prefill of token rows into its cache's
        ``slots`` from positions ``start`` (default 0): a refill's prompts,
        or the continuation of slots whose draft cache fell behind."""
        dparams, dcfg = self._draft
        return prefill_rows(dparams, dcfg, cache, tokens, lengths, slots, self.device, start,
                            segment=self.PREFILL_SEGMENT)


class Decoder:
    """Decode chunks over one cache: ``n`` steps for every slot, inactive
    slots keeping their token and position.  Its graphs live as long as it
    does.

    The inputs live in static device buffers, ``inputs`` [4, B] int32
    (tokens, positions, active, tokens generated so far: a seeded row's
    step); a chunk writes its tokens [n, B] into ``toks`` (the per-request
    body also token logprobs ``lps`` and top logprobs ``top_v`` /
    ``top_i``) and its last token and advanced positions and counts back
    into the inputs, so the next chunk may start from them with no host
    copy.  The per-request body reads the slots' :class:`BatchedSampling`
    rows ``bp``, the emitted-token state (:meth:`mask`), the bias rows
    and the engine's key stream, each written at refill, never per step.
    :meth:`launch` enqueues a chunk and the copy of its outputs into one
    of two pinned host buffers, then records an event; :meth:`read` waits
    for that event only, so a chunk launched after it keeps running.  The
    host buffers alternate, so a later chunk's copy cannot overwrite
    outputs not yet read; the device's need no twin, as their copy is
    ordered before the next chunk on the stream.

    With the engine's ``spec_k``, :meth:`launch_spec` runs speculative
    chunks the same way (:meth:`run_spec`): from the same inputs (tokens,
    positions, active), over the prompt-lookup history ``hist`` [B,
    max_seq_len] or the draft model's cache ``dcache``, their targets,
    accept counts and logprobs into ``s_targets``, ``s_acc`` and ``s_lps``
    [n, B, ...]."""

    def __init__(self, engine: Engine, cache: KVCache, dcache: Optional[KVCache] = None):
        dev = engine.device
        b = cache.k.shape[1]
        n = max(engine.decode_chunk, 1)
        # The engine's parts, not the engine: it holds this Decoder.
        self.params, self.cfg, self.keys = engine.params, engine.cfg, engine.keys
        self.stats, self.stream = engine.graph_stats, engine.graph_stream
        self.cache, self.dcache, self.draft = cache, dcache, engine._draft
        self.spec_k, self.ngram = engine.spec_k, engine.spec_ngram
        self.inputs = torch.zeros((4, b), dtype=torch.int32, device=dev)
        self.toks = torch.zeros((n, b), dtype=torch.int32, device=dev)
        self.lps = torch.zeros((n, b), dtype=torch.float32, device=dev)
        self.top_v = torch.zeros((n, b, MAX_TOP_LOGPROBS), dtype=torch.float32, device=dev)
        self.top_i = torch.zeros((n, b, MAX_TOP_LOGPROBS), dtype=torch.int32, device=dev)
        self.bp = BatchedSampling.stack([GREEDY] * b, dev)
        self.masks = {}  # "bool" / "counts" -> [B, V], made by prepare()
        self.saved = {}  # their copies while a chunk runs ahead
        self.bias = None  # [B, V] fp32, made by prepare()
        outs = [("toks", self.toks), ("lps", self.lps), ("top_v", self.top_v), ("top_i", self.top_i)]
        if self.spec_k:
            kk = self.spec_k + 1
            self.hist = torch.zeros((b, self.cfg.max_seq_len), dtype=torch.int32, device=dev)
            self.s_targets = torch.zeros((n, b, kk), dtype=torch.int32, device=dev)
            self.s_acc = torch.zeros((n, b), dtype=torch.int32, device=dev)
            self.s_lps = torch.zeros((n, b, kk), dtype=torch.float32, device=dev)
            outs += [("targets", self.s_targets), ("acc", self.s_acc), ("s_lps", self.s_lps)]
        pinned = dev.type == "cuda"
        self.host = [{name: torch.zeros(t.shape, dtype=t.dtype, pin_memory=pinned) for name, t in outs}
                     for _ in range(2)]
        self.flip = 0
        self.graphs = {}  # (kv_len, n, ChunkKind | SpecKind | None) -> CountedGraph
        self.pool = torch.cuda.graph_pool_handle() if engine.graph_stream is not None else None

    # -- the per-request state -------------------------------------------------

    def prepare(self, kind: Optional[ChunkKind]) -> None:
        """Make the buffers ``kind`` reads, once (never under capture)."""
        if kind is None:
            return
        b, v, dev = self.inputs.shape[1], self.cfg.vocab_size, self.inputs.device
        if kind.mask is not None and kind.mask not in self.masks:
            dtype = torch.bool if kind.mask == "bool" else torch.int32
            self.masks[kind.mask] = torch.zeros((b, v), dtype=dtype, device=dev)
            self.saved[kind.mask] = torch.zeros((b, v), dtype=dtype, device=dev)
        if kind.bias and self.bias is None:
            self.bias = torch.zeros((b, v), dtype=torch.float32, device=dev)

    def set_sampling(self, params: Sequence[SamplingParams]) -> None:
        """Every slot's sampling parameters (one per slot)."""
        self.bp.copy_(BatchedSampling.stack(params, self.inputs.device))

    def reset_mask(self, kind: str, slots, first: torch.Tensor) -> None:
        """Clear the emitted-token rows of ``slots`` and record their first
        tokens (the JAX package's ``_mask_reset``)."""
        mask = self.masks[kind]
        idx = torch.as_tensor(np.asarray(slots), dtype=torch.int64, device=mask.device)
        mask[idx] = False if mask.dtype == torch.bool else 0
        mask[idx, first.to(torch.int64)] = True if mask.dtype == torch.bool else 1

    def set_bias(self, slots, rows: np.ndarray) -> None:
        """The dense bias rows [len(slots), V] of ``slots``."""
        idx = torch.as_tensor(np.asarray(slots), dtype=torch.int64, device=self.bias.device)
        self.bias[idx] = torch.from_numpy(rows).to(self.bias.device)

    def save_state(self, kind: Optional[ChunkKind]) -> None:
        """Copy the emitted-token state before a chunk is launched ahead
        (a device copy, ordered after the chunks already launched)."""
        if kind is not None and kind.mask is not None:
            self.saved[kind.mask].copy_(self.masks[kind.mask])

    def restore_state(self, kind: Optional[ChunkKind]) -> None:
        """Undo a dropped chunk's writes to the emitted-token state."""
        if kind is not None and kind.mask is not None:
            self.masks[kind.mask].copy_(self.saved[kind.mask])

    # -- chunks ----------------------------------------------------------------

    def launch(self, n: int, kv_len: int, tokens=None, positions=None, active=None, steps=None,
               kind: Optional[ChunkKind] = None):
        """Enqueue ``n`` steps at ``kv_len`` with body ``kind``; returns the
        handle :meth:`read` takes.  With host arrays ``tokens``,
        ``positions``, ``active`` and ``steps`` [B] the inputs are copied
        from them first; without, the chunk continues from the previous
        launch's device outputs.  On CUDA a chunk of ``n > 1`` steps is a
        graph replay."""
        self.prepare(kind)
        self._set_inputs(tokens, positions, active, steps)
        self._execute((kv_len, n, kind), n > 1, lambda: self.run_eager(n, kv_len, kind))
        pairs = [("toks", self.toks[:n])]
        if kind is not None:
            pairs.append(("lps", self.lps[:n]))
            if kind.top_lp_k:
                pairs += [("top_v", self.top_v), ("top_i", self.top_i)]
        return self._hand_off(pairs, n, kind)

    def _set_inputs(self, tokens, positions, active, steps) -> None:
        """Copy host inputs [B] into ``inputs`` (nothing when ``tokens`` is
        None: the chunk continues from the device outputs)."""
        if tokens is None:
            return
        steps = np.zeros(len(tokens), np.int32) if steps is None else steps
        host = np.stack([np.asarray(a, dtype=np.int32) for a in (tokens, positions, active, steps)])
        # A pageable copy, so the host waits for the stream: it is idle or
        # still runs a dropped chunk, which this one must follow.
        self.inputs.copy_(torch.from_numpy(host))

    def _execute(self, key, graphed: bool, run) -> None:
        """Run a chunk body: on CUDA (``graphed``) the replay of its graph,
        captured at first use, else ``run()`` eagerly."""
        if self.pool is not None and graphed:
            graph = self.graphs.get(key) or self._capture(key, run)
            graph.replay()
            self.stats["replayed"] += 1
        else:
            run()

    def _hand_off(self, pairs, n: int, kind):
        """Enqueue the copies of a chunk's outputs (host buffer name, device
        tensor) into the next pinned host buffers and record an event: the
        handle :meth:`read_all` / :meth:`read_spec` take."""
        out = self.host[self.flip]
        self.flip ^= 1
        for name, t in pairs:
            out[name][: t.shape[0]].copy_(t, non_blocking=True)
        done = None
        if self.toks.is_cuda:
            done = torch.cuda.Event()
            done.record()
        return out, n, kind, done

    @staticmethod
    def read(handle) -> np.ndarray:
        """The tokens [n, B] of a launched chunk, once its copy is done."""
        return Decoder.read_all(handle)[0]

    @staticmethod
    def read_all(handle):
        """(tokens [n, B], token logprobs [n, B] or None, (top values, top
        ids) [n, B, k] or None) of a launched chunk."""
        out, n, kind, done = handle
        if done is not None:
            done.synchronize()
        toks = out["toks"][:n].numpy().copy()
        if kind is None:
            return toks, None, None
        lps = out["lps"][:n].numpy().copy()
        k = kind.top_lp_k
        tops = (out["top_v"][:n, :, :k].numpy().copy(), out["top_i"][:n, :, :k].numpy().copy()) if k else None
        return toks, lps, tops

    def run_eager(self, n: int, kv_len: int, kind: Optional[ChunkKind] = None) -> torch.Tensor:
        """The chunk's body, eagerly (and what a graph captures): ``n``
        decode and sampling steps from ``inputs``, the outputs into
        ``toks[:n]`` (and ``lps``, ``top_v``, ``top_i``), the last token,
        the positions and the counts back into ``inputs``.  Nothing here
        touches the host.  Returns the last step's logits."""
        tok, pos, active, steps = self.inputs
        act = active != 0
        out = []
        if kind is None:  # plain greedy: fp32 argmax only
            for _ in range(n):
                logits, _ = decode_step(self.params, self.cfg, tok, self.cache, pos, kv_len=kv_len)
                tok = torch.where(act, sample(logits, GREEDY), tok)
                out.append(tok)
                pos = pos + active
            self.toks[:n] = torch.stack(out)
            self.inputs[:2] = torch.stack((tok, pos))
            return logits
        lps, tops = [], []
        for _ in range(n):
            logits, _ = decode_step(self.params, self.cfg, tok, self.cache, pos, kv_len=kv_len)
            tok, lp, top = self.sample_step(logits, tok, act, steps, kind)
            out.append(tok)
            lps.append(lp)
            tops.append(top)
            pos = pos + active
            steps = steps + 1
        self.toks[:n] = torch.stack(out)
        self.lps[:n] = torch.stack(lps)
        if kind.top_lp_k:
            self.top_v[:n, :, : kind.top_lp_k] = torch.stack([v for v, _ in tops])
            self.top_i[:n, :, : kind.top_lp_k] = torch.stack([i for _, i in tops])
        self.inputs[:2] = torch.stack((tok, pos))
        self.inputs[3] = steps
        return logits

    def sample_step(self, logits, tok, act, steps, kind: ChunkKind):
        """One per-request sampling step (the body of the JAX package's
        ``_decode_multi_impl_batched``): the next tokens [B] (inactive slots
        keep ``tok``), their raw logprobs and the top logprobs, recording
        the tokens in the emitted-token state of the active slots."""
        lg = logits.float()
        mask = self.masks[kind.mask] if kind.mask is not None else None
        nxt = sample_batched(lg, self.bp, self.keys.next(), mask, steps, self.bias if kind.bias else None)
        nxt = torch.where(act, nxt, tok)
        lpf = torch.log_softmax(lg, dim=-1)
        idx = nxt.to(torch.int64)[:, None]
        lp = lpf.gather(-1, idx)[:, 0]
        top = None
        if kind.top_lp_k:
            v, i = torch.topk(lpf, kind.top_lp_k)
            top = (v, i.to(torch.int32))
        if mask is not None:
            if mask.dtype == torch.bool:
                mask.scatter_(1, idx, mask.gather(1, idx) | act[:, None])
            else:
                mask.scatter_add_(1, idx, act[:, None].to(torch.int32))
        return nxt, lp, top

    # -- speculative chunks ------------------------------------------------------

    def write_history(self, slot: int, start: int, tokens: Sequence[int]) -> None:
        """Write ``tokens`` into the prompt-lookup history of ``slot`` from
        position ``start`` (a pageable copy, ordered after the chunks
        already launched)."""
        vals = torch.from_numpy(np.asarray(tokens, dtype=np.int32))
        self.hist[slot, start : start + len(vals)].copy_(vals)

    def launch_spec(self, n: int, kv_len: int, kind: SpecKind, tokens=None, positions=None, active=None):
        """Enqueue ``n`` speculative rounds at ``kv_len`` with body ``kind``
        (:meth:`run_spec`); inputs and chaining as :meth:`launch`.  On CUDA
        a graph replay.  Returns the handle :meth:`read_spec` takes."""
        self._set_inputs(tokens, positions, active, None)
        self._execute((kv_len, n, kind), True, lambda: self.run_spec(n, kv_len, kind))
        pairs = [("targets", self.s_targets[:n]), ("acc", self.s_acc[:n]), ("s_lps", self.s_lps[:n])]
        return self._hand_off(pairs, n, kind)

    @staticmethod
    def read_spec(handle):
        """(targets [n, B, k+1], accepted [n, B], logprobs [n, B, k+1]) of a
        launched speculative chunk, once its copy is done."""
        out, n, _, done = handle
        if done is not None:
            done.synchronize()
        return tuple(out[name][:n].numpy().copy() for name in ("targets", "acc", "s_lps"))

    def run_spec(self, n: int, kv_len: int, kind: SpecKind) -> None:
        """The speculative chunk's body, eagerly (and what a graph
        captures): ``n`` rounds of drafting (prompt lookup over ``hist``,
        or the draft model over ``dcache``), verify (greedy or rejection
        sampling with the rows' ``bp`` and the engine's key stream),
        history write and advance (``serve/speculative.py``), from
        ``inputs``; the outputs into ``s_targets``, ``s_acc`` and ``s_lps``,
        the next tokens and positions back into ``inputs``.  Nothing here
        touches the host."""
        tok, pos, active = self.inputs[0], self.inputs[1], self.inputs[2] != 0
        fwd = functools.partial(_verify_forward, cfg=self.cfg, kv_len=kv_len)
        common = dict(fwd=fwd, k=kind.k, n_steps=n)
        if kind.draft:
            dparams, dcfg = self.draft
            common["dfwd"] = functools.partial(_draft_step, cfg=dcfg, kv_len=kv_len)
            if kind.greedy:
                out = spec_chunk_draft(self.params, dparams, tok, self.dcache, self.cache, pos, active, **common)
            else:
                out = spec_chunk_draft_sampled(self.params, dparams, tok, self.dcache, self.cache, pos, self.keys,
                                               self.bp, active, **common)
        elif kind.greedy:
            out = spec_chunk(self.params, tok, self.hist, self.cache, pos, active, ngram=self.ngram, **common)
        else:
            out = spec_chunk_sampled(self.params, tok, self.hist, self.cache, pos, self.keys, self.bp, active,
                                     ngram=self.ngram, **common)
        targets, accepted, lps = out[:3]
        self.s_targets[:n] = targets
        self.s_acc[:n] = accepted
        self.s_lps[:n] = lps
        self.inputs[:2] = torch.stack(out[-2:])

    def _capture(self, key, run) -> CountedGraph:
        """Capture a chunk body ``run`` for ``key`` (kv_len, n, kind) on the
        engine's capture stream, into this decoder's memory pool."""
        t0 = time.perf_counter()
        graph = CountedGraph()
        with graph.capture(pool=self.pool, stream=self.stream):
            run()
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["captured"] += 1
        self.stats["pool_bytes"] = max(self.stats["pool_bytes"], self.pool_bytes())
        self.graphs[key] = graph
        return graph

    def pool_bytes(self) -> int:
        """Device bytes held by this decoder's graph memory pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s["segment_pool_id"]) == pool)


class _Scheduler:
    """The host-side state of one :meth:`Engine.generate` call: the
    requests, the queue, each slot's request, position, generated tokens,
    logprobs and next input token, and the bias rows of slots whose rows
    change with their progress (``choices``, ``min_new_tokens`` not yet
    reached: "dynamic" slots)."""

    def __init__(self, engine: Engine, prompts, sps, max_new_tokens: int, return_logprobs: bool, stop_tokens,
                 on_token, admit, cancel):
        self.eng = engine
        self.cfg = engine.cfg
        self.default_budget = max_new_tokens
        self.base_stops = frozenset({engine.eos_token} | set(stop_tokens or ()))
        self.return_logprobs = return_logprobs
        self.on_token, self.admit, self.cancel = on_token, admit, cancel
        self.admit_peek = getattr(admit, "peek", None) if admit is not None else None
        self.prompts, self.sps, self.stops, self.budgets, self.results = [], [], [], [], []
        self.queue = collections.deque()
        for p, sp in zip(prompts, sps):
            self.add_request(p, sp)
        # What this call's buffers and chunk bodies serve: the contract of
        # ``admit`` (Engine.admissible).
        use_mask = any(_uses_mask(p) for p in sps)
        use_counts = any(_uses_counts(p) for p in sps)
        use_bias = any(_uses_bias(p) for p in sps)
        top_lp_k = max((p.top_logprobs for p in sps), default=0)
        if not 0 <= top_lp_k <= MAX_TOP_LOGPROBS:
            raise ValueError(f"top_logprobs must be in [0, {MAX_TOP_LOGPROBS}]")
        self.features = {
            "use_mask": use_mask, "use_counts": use_counts, "use_bias": use_bias, "top_lp_k": top_lp_k,
            "return_logprobs": return_logprobs, "max_prompt_len": self.cfg.max_seq_len - 1,
        }
        self.kind = ChunkKind(top_lp_k, "counts" if use_counts else "bool" if use_mask else None, use_bias)
        # A plain call runs the greedy body while its active requests are
        # greedy (a stochastic admitted one switches its chunks to the
        # per-request body, with this call's plain kind).
        self.plain = not return_logprobs and all(_plain_greedy(p) for p in sps)
        self.cache, self.dec = engine.state()
        self.dec.prepare(self.kind)
        n = engine.batch_size
        self.slot_req = [-1] * n  # request index, or -1 when idle
        self.slot_sp = [GREEDY] * n
        self.slot_pos = np.zeros(n, dtype=np.int64)  # next position to write
        self.generated: List[List[int]] = [[] for _ in range(n)]
        self.logprobs: List[List[float]] = [[] for _ in range(n)]
        self.toplp: List[list] = [[] for _ in range(n)]
        self.cur = np.zeros(n, dtype=np.int32)  # next input token
        self.dynamic = [False] * n
        self.rowkey = [None] * n  # the key of each slot's uploaded bias row
        # Speculation: the entries of each slot's device history row that
        # hold its context, the positions its draft cache holds, and
        # whether the last round's mean acceptance cleared the threshold.
        self.hist_len = [0] * n
        self.draft_pos = np.zeros(n, dtype=np.int64)
        self.spec_confident = False

    def add_request(self, prompt, sp: SamplingParams) -> None:
        budget = sp.max_new_tokens if sp.max_new_tokens is not None else self.default_budget
        if sp.choices:
            budget = max(budget, max(len(c) for c in sp.choices))
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1 for every request")
        self.queue.append(len(self.prompts))
        self.prompts.append(list(prompt))
        self.sps.append(sp)
        self.stops.append(self.base_stops | set(sp.stop_tokens))
        self.budgets.append(budget)
        self.results.append(None)

    def active(self) -> np.ndarray:
        return np.asarray([r != -1 for r in self.slot_req])

    def run(self) -> List[GenerationResult]:
        while True:
            self.retire()
            self.refill()
            # A request whose prefill token already ends it (a budget of 1,
            # a stop token, a one-token choice) retires before any decode
            # step; its slot refills at once.  (The JAX package's loop
            # decodes such a request refilled mid-call once more.)
            self.retire()
            if self.queue and not self.active().all():
                continue
            if not self.active().any():
                break
            self.refresh_rows()
            self.decode()
        return [r for r in self.results if r is not None]

    def retire(self) -> None:
        for s, r in enumerate(self.slot_req):
            if r == -1:
                continue
            gen, sp = self.generated[s], self.sps[r]
            # A choice may contain a stop token: only a full match (or the
            # budget, the context, a cancel) ends a choices request.
            done_eos = bool(gen) and gen[-1] in self.stops[r] and not sp.choices
            done_len = len(gen) >= self.budgets[r]
            done_ctx = self.slot_pos[s] >= self.cfg.max_seq_len - 1
            done_choice = bool(sp.choices) and tuple(gen) in {tuple(c) for c in sp.choices}
            done_cancel = self.cancel is not None and bool(self.cancel(r))
            if done_eos or done_len or done_ctx or done_choice or done_cancel:
                out = gen[:-1] if done_eos else gen
                lps = self.logprobs[s][: len(out)] if self.return_logprobs else None
                k = sp.top_logprobs
                tops = [row[:k] for row in self.toplp[s][: len(out)]] if k else None
                self.results[r] = GenerationResult(list(self.prompts[r]), out, done_eos or done_choice, lps, tops)
                self.slot_req[s] = -1
                self.generated[s], self.logprobs[s], self.toplp[s] = [], [], []

    def refill(self) -> None:
        """Give queued (and admitted) requests the idle slots and prefill
        them in same-bucket groups of 4, 2 or 1."""
        cfg = self.cfg
        if self.admit is not None and not self.queue and any(r == -1 for r in self.slot_req):
            for tok, sp, ad in self.admit(self.features):
                sp = sp if sp is not None else self.eng.sampling
                if not Engine.admissible(self.features, tok, sp, adapter=ad):
                    raise ValueError(
                        "admit() returned a request this generate() call cannot serve (check Engine.admissible first)"
                    )
                self.add_request(tok, sp)
        pending = []  # (slot, request, bucket)
        for s in range(len(self.slot_req)):
            if self.slot_req[s] != -1:
                continue
            while self.queue:
                r = self.queue.popleft()
                prompt = self.prompts[r]
                if self.cancel is not None and self.cancel(r):
                    self.results[r] = GenerationResult(list(prompt), [], False)
                    continue
                if len(prompt) == 0 or len(prompt) >= cfg.max_seq_len:
                    self.results[r] = GenerationResult(list(prompt), [], True)
                    continue
                self.slot_req[s] = r
                self.slot_sp[s] = self.sps[r]
                pending.append((s, r, min(bucket_len(len(prompt)), cfg.max_seq_len)))
                break
        if pending and not self.greedy_body(self.slot_sp):
            self.dec.set_sampling(self.slot_sp)
        groups = collections.defaultdict(list)
        for item in pending:
            groups[item[2]].append(item)
        for bucket, items in groups.items():
            i = 0
            while i < len(items):
                g = next(gg for gg in (4, 2, 1) if len(items) - i >= gg)
                self._prefill(items[i : i + g], bucket)
                i += g

    def _prefill(self, chunk, bucket: int) -> None:
        """Prefill a group and take each request's first token through the
        sampler its decode uses (no emitted tokens yet: no penalties)."""
        g = len(chunk)
        toks = np.zeros((g, bucket), dtype=np.int32)
        lens = np.zeros(g, dtype=np.int32)
        slots = np.zeros(g, dtype=np.int64)
        for j, (s, r, _) in enumerate(chunk):
            prompt = self.prompts[r]
            toks[j, : len(prompt)] = prompt
            lens[j] = len(prompt)
            slots[j] = s
        logits = self.eng.prefill_group(self.cache, toks, lens, slots)
        sps = [self.sps[r] for _, r, _ in chunk]
        if self.greedy_body(sps):
            first_t = sample(logits, GREEDY)
        else:
            dev = logits.device
            bias = None
            if self.kind.bias:
                rows = np.stack([self._np_row(sp, r, []) for sp, (_, r, _) in zip(sps, chunk)])
                self.dec.set_bias(slots, rows)
                bias = torch.from_numpy(rows).to(dev)
                for sp, (s, _, _) in zip(sps, chunk):
                    self.dynamic[s] = self._still_dynamic(sp, [])
                    self.rowkey[s] = self._row_key(sp, [])
            key = self.eng.keys.next() if any(sp.temperature != 0.0 for sp in sps) else None
            first_t = sample_batched(logits, BatchedSampling.stack(sps, dev), key, None,
                                     torch.zeros(g, dtype=torch.int32, device=dev), bias)
        first = first_t.cpu().numpy()
        lps = _token_logprobs(logits, first_t).cpu().numpy() if self.return_logprobs else None
        k = self.kind.top_lp_k
        if k:
            tv, ti = (t.cpu().numpy() for t in _top_logprobs(logits, k))
        for j, (s, r, _) in enumerate(chunk):
            t = int(first[j])
            self.slot_pos[s] = len(self.prompts[r])
            self.generated[s] = [t]
            self.cur[s] = t
            self.logprobs[s] = [float(lps[j])] if self.return_logprobs else []
            self.toplp[s] = [list(zip(ti[j].tolist(), tv[j].tolist()))] if k else []
            if self.on_token is not None and (t not in self.stops[r] or self.sps[r].choices):
                self.on_token(r, t)
        if self.kind.mask is not None:
            self.dec.reset_mask(self.kind.mask, slots, first_t)
        if self.eng.spec_k:
            self._spec_refill(chunk, slots)

    def _spec_refill(self, chunk, slots) -> None:
        """A refilled slot's speculative state: its context in the device
        history, or its full prompt in the draft model's cache (prefilled
        from position 0, in one group)."""
        if self.eng._draft is None:
            for s, r, _ in chunk:
                ctx = self.prompts[r] + self.generated[s]
                self.dec.write_history(s, 0, ctx)
                self.hist_len[s] = len(ctx)
            return
        dcfg = self.eng._draft[1]
        full = [self.prompts[r] for _, r, _ in chunk]
        toks = np.zeros((len(full), min(bucket_len(max(map(len, full))), dcfg.max_seq_len)), dtype=np.int32)
        for j, p in enumerate(full):
            toks[j, : len(p)] = p
        self.eng.prefill_draft(self.dec.dcache, toks, np.asarray([len(p) for p in full], np.int32), slots)
        for (s, _, _), p in zip(chunk, full):
            self.draft_pos[s] = len(p)

    # -- the bias rows of progress-dependent slots -----------------------------

    @staticmethod
    def _row_key(p: SamplingParams, gen) -> tuple:
        """What a slot's bias row depends on: the min-token ban is constant
        until the crossing, a choice row changes with every token."""
        if p.choices:
            return ("choice", len(gen))
        return ("ban", p.min_new_tokens > len(gen))

    @staticmethod
    def _still_dynamic(p: SamplingParams, gen) -> bool:
        return bool(p.choices) or p.min_new_tokens > len(gen)

    def _np_row(self, p: SamplingParams, r: int, gen) -> np.ndarray:
        """One slot's dense logit-bias row given its progress (the JAX
        package's ``_np_row``)."""
        v = self.cfg.vocab_size
        row = np.zeros(v, np.float32)
        for t, bias in p.logit_bias:
            row[int(t)] = float(bias)
        if p.choices:
            # The choice mask subsumes the min-token ban: allowed
            # continuations keep their plain logit_bias even if they are
            # stop tokens.
            g = tuple(gen)
            allowed = {c[len(g)] for c in p.choices if len(c) > len(g) and tuple(c[: len(g)]) == g}
            new = np.full(v, -1e9, np.float32)
            for t in allowed:
                if 0 <= int(t) < v:
                    new[int(t)] = row[int(t)]
            return new
        if p.min_new_tokens > len(gen):
            for t in self.stops[r]:
                if 0 <= int(t) < v:
                    row[int(t)] = -1e9
        return row

    def refresh_rows(self) -> None:
        """Re-upload the bias rows of active dynamic slots whose content
        changed since the last upload."""
        if not self.kind.bias:
            return
        live = [s for s in range(len(self.slot_req)) if self.dynamic[s] and self.slot_req[s] != -1]
        upd = [s for s in live if self._row_key(self.slot_sp[s], self.generated[s]) != self.rowkey[s]]
        if upd:
            rows = np.stack([self._np_row(self.slot_sp[s], self.slot_req[s], self.generated[s]) for s in upd])
            self.dec.set_bias(upd, rows)
            for s in upd:
                self.rowkey[s] = self._row_key(self.slot_sp[s], self.generated[s])
        for s in live:
            self.dynamic[s] = self._still_dynamic(self.slot_sp[s], self.generated[s])

    # -- decode ----------------------------------------------------------------

    def greedy_body(self, sps) -> bool:
        """Do slots with these params run the plain greedy body (fp32
        argmax)?  Yes while a plain call's requests are greedy; a stochastic
        admitted one switches the call to the per-request body."""
        return self.plain and all(sp.temperature == 0.0 for sp in sps)

    def chunk_kind(self, idx) -> Optional[ChunkKind]:
        """The body of the next chunks: greedy while the active slots run
        the greedy body, else the per-request body of this call."""
        return None if self.greedy_body([self.slot_sp[s] for s in idx]) else self.kind

    def chunk_ok(self, idx, n: int, ahead: int) -> bool:
        """Is a chunk of ``n`` steps launched ``ahead`` whole chunks past the
        current host state sure to fit every active slot's budget and
        context, with every active slot's bias row constant across it?"""
        room = min(self.budgets[self.slot_req[s]] - len(self.generated[s]) for s in idx) - ahead * n
        ctx_room = self.cfg.max_seq_len - 1 - (int(self.slot_pos[idx].max()) + ahead * n)
        ban_static = all(
            not self.dynamic[s]
            or (not self.slot_sp[s].choices and len(self.generated[s]) + (ahead + 1) * n <= self.slot_sp[s].min_new_tokens)
            for s in idx
        )
        return room >= n and ctx_room >= n and ban_static

    def launch(self, act, n: int, kind, ahead: int = 0):
        """Launch ``n`` steps: from the host state, or (``ahead=1``) from the
        device outputs of the chunk launched just before."""
        kv_len = kv_bucket(int(self.slot_pos[act].max()) + (ahead + 1) * n, self.eng.KV_BUCKET,
                           self.cfg.max_seq_len)
        if ahead:
            return self.dec.launch(n, kv_len, kind=kind)
        steps = [len(g) for g in self.generated]
        return self.dec.launch(n, kv_len, self.cur, self.slot_pos, act, steps=steps, kind=kind)

    def consume(self, handle, act, n: int) -> bool:
        """Read a launched chunk back into the host state; True when a slot
        hit a stop or its budget, or its request was cancelled (it retires
        before it decodes again; a cancelled one takes none of the chunk's
        tokens)."""
        toks, lps, tops = self.dec.read_all(handle)
        self.slot_pos[act] += n
        finished = False
        for s in np.nonzero(act)[0]:
            r = self.slot_req[s]
            if self.cancel is not None and self.cancel(r):
                finished = True
                continue
            for i in range(n):
                t = int(toks[i, s])
                self.generated[s].append(t)
                if tops is not None:
                    self.toplp[s].append(list(zip(tops[1][i, s].tolist(), tops[0][i, s].tolist())))
                if self.return_logprobs:
                    self.logprobs[s].append(float(lps[i, s]))
                if self.on_token is not None and (t not in self.stops[r] or self.sps[r].choices):
                    self.on_token(r, t)
                # Tokens after a stop or past the budget are dropped.
                if t in self.stops[r] or len(self.generated[s]) >= self.budgets[r]:
                    finished = True
                    break
            self.cur[s] = toks[n - 1, s]
        return finished

    def cancel_hit(self) -> bool:
        """Is an active request cancelled?  Polled between pipelined chunks."""
        return self.cancel is not None and any(r != -1 and self.cancel(r) for r in self.slot_req)

    def admit_waiting(self) -> bool:
        """Is a request waiting (``admit.peek()``) while a slot is idle?"""
        return self.admit_peek is not None and any(r == -1 for r in self.slot_req) and bool(self.admit_peek())

    def decode(self) -> None:
        """One speculative round when the active requests allow it, else
        decode chunks while every active slot has room for one (budget,
        context, a constant bias row), else a single step.  Pipelined, each
        chunk's successor is launched before the chunk is read back, when
        the successor too is sure to fit and no admitted request waits; it
        is dropped when the chunk ended a request or a request was
        cancelled (the JAX package's multi-step branch of ``generate``).
        While speculation is paused, each plain chunk or step serves one
        unit of the cooldown, and the chunk loop ends when it expires."""
        act = self.active()
        idx = np.nonzero(act)[0]
        eng = self.eng
        if self.spec_eligible(idx):
            self.spec_round(act, idx)
            return
        n = eng.decode_chunk
        kind = self.chunk_kind(idx)
        if not (n > 1 and self.chunk_ok(idx, n, 0)):
            if eng._spec_pause > 0:
                eng._spec_pause -= 1
            self.consume(self.launch(act, 1, kind), act, 1)
            return
        stats = eng.pipeline_stats
        reprobe = eng.spec_k > 0 and eng._spec_pause > 0
        cur = self.launch(act, n, kind)
        while True:
            nxt = None
            # No successor when the cooldown expires at this chunk, so the
            # loop ends (to probe again) dropping nothing.
            expiring = reprobe and eng._spec_pause <= 1
            if eng.pipeline_decode and self.chunk_ok(idx, n, 1) and not expiring and not self.admit_waiting():
                self.dec.save_state(kind)
                nxt = self.launch(act, n, kind, ahead=1)
                stats["launched"] += 1
            finished = self.consume(cur, act, n)
            if reprobe:
                eng._spec_pause -= 1
            if nxt is None:
                return
            if finished or self.cancel_hit():
                stats["discarded"] += 1
                self.dec.restore_state(kind)
                return
            cur = nxt

    # -- speculation -------------------------------------------------------------

    def spec_eligible(self, idx) -> bool:
        """Speculate this round?  The engine speculates and is not paused;
        every active request allows it (:func:`_spec_ok`, no dynamic bias
        row), the call asks for no top logprobs, and a verify window fits
        every active slot's context (the JAX package's gate)."""
        eng = self.eng
        return (
            eng.spec_k > 0
            and eng._spec_pause == 0
            and all(_spec_ok(self.slot_sp[s]) and not self.dynamic[s] for s in idx)
            and self.kind.top_lp_k == 0
            and self.cfg.max_seq_len - 1 - int(self.slot_pos[idx].max()) >= eng.spec_k + 1
        )

    def spec_room(self, idx, n: int, ahead: int) -> bool:
        """Room for a chunk of ``n`` rounds launched ``ahead`` chunks past
        the host state: context for the worst case (every round advancing
        k + 1 positions) and budget for ``n`` more tokens (a chunk that
        overshoots a budget has its extra tokens dropped)."""
        span = self.eng.spec_k + 1
        ctx_ok = self.cfg.max_seq_len - 1 - int(self.slot_pos[idx].max()) >= (ahead + 1) * n * span
        rem = min(self.budgets[self.slot_req[s]] - len(self.generated[s]) for s in idx) - ahead * n
        return ctx_ok and rem >= n

    def successor_safe(self, idx, n: int) -> bool:
        """The chunk in flight cannot end a request on budget, so its
        successor is not dropped for that (worst case: every round emits
        k + 1 tokens; a stop token can still drop it)."""
        most = n * (self.eng.spec_k + 1)
        return all(self.budgets[self.slot_req[s]] - len(self.generated[s]) > most for s in idx)

    def spec_positions(self, act) -> np.ndarray:
        """Verify positions: idle slots verify frozen at position 0."""
        return np.where(act, self.slot_pos, 0)

    def spec_kv_len(self, act, end: int) -> int:
        """The kv bucket of a round or chunk ending ``end`` positions past
        the active slots' furthest position."""
        return kv_bucket(int(self.slot_pos[act].max()) + end, self.eng.KV_BUCKET, self.cfg.max_seq_len)

    def sync_history(self, idx) -> None:
        """Write into the device history what the active slots generated
        since it last held their context (plain decode writes none)."""
        for s in idx:
            ctx_len = int(self.slot_pos[s]) + 1
            if self.hist_len[s] < ctx_len:
                ctx = self.prompts[self.slot_req[s]] + self.generated[s]
                self.dec.write_history(s, self.hist_len[s], ctx[self.hist_len[s] : ctx_len])
                self.hist_len[s] = ctx_len

    def draft_catchup(self, idx) -> None:
        """Bring the draft cache of active slots whose draft positions lag
        their target positions (plain decode during a pause, a fully
        accepted host-stepped round) up to them: grouped continuation
        prefills of the gap tokens, from each slot's draft position (the
        JAX package's ``_draft_catchup``)."""
        dcfg = self.eng._draft[1]
        lag = [s for s in idx if self.draft_pos[s] < self.slot_pos[s]]
        i = 0
        while i < len(lag):
            g = next(gg for gg in (4, 2, 1) if len(lag) - i >= gg)
            grp = lag[i : i + g]
            i += g
            gaps = [int(self.slot_pos[s] - self.draft_pos[s]) for s in grp]
            toks = np.zeros((g, min(bucket_len(max(gaps)), dcfg.max_seq_len)), dtype=np.int32)
            for j, s in enumerate(grp):
                ctx = self.prompts[self.slot_req[s]] + self.generated[s]
                toks[j, : gaps[j]] = ctx[int(self.draft_pos[s]) : int(self.slot_pos[s])]
            self.eng.prefill_draft(self.dec.dcache, toks, np.asarray(gaps, np.int32), np.asarray(grp),
                                   start=self.draft_pos[grp].astype(np.int32))
            self.draft_pos[grp] = self.slot_pos[grp]

    def spec_round(self, act, idx) -> None:
        """One speculative round of the scheduler (the JAX package's spec
        branch of ``generate``): chunks of verify rounds, pipelined, while
        they fit, else one host-stepped verify; then the controller's
        verdict on the round's mean acceptance.

        After a failed probe (and from a wave's start with a draft model,
        until a round clears the threshold) the chunks are short (n = 2)
        and unpipelined, with one grace chunk; a running mean below the
        threshold after two chunks ends the round at once."""
        eng = self.eng
        k, n = eng.spec_k, eng.decode_chunk
        draft_mode = eng._draft is not None
        probing = eng._spec_backoff > 0 or (draft_mode and not self.spec_confident and eng.spec_min_accept > 0.0)
        if probing and n > 2 and (draft_mode or min(len(self.generated[s]) for s in idx) >= 2 * n):
            n = 2
        if draft_mode:
            self.draft_catchup(idx)
        kind = SpecKind(k, draft_mode, all(self.slot_sp[s].temperature == 0.0 for s in idx))
        samples: List[float] = []
        if n > 1 and self.spec_room(idx, n, 0):
            self.spec_chunks(act, idx, n, kind, probing, samples)
        else:
            self.spec_single(act, idx, kind, samples)
        self.spec_adapt(samples)

    def spec_chunks(self, act, idx, n: int, kind: SpecKind, probing: bool, samples: List[float]) -> None:
        """Speculative chunks of ``n`` rounds, each successor launched from
        its predecessor's device outputs before that is read back, when it
        fits, cannot be dropped on budget and the round is not probing."""
        eng, stats = self.eng, self.eng.pipeline_stats
        span = kind.k + 1

        def launch(ahead: int):
            kv_len = self.spec_kv_len(act, (ahead + 1) * n * span)
            if ahead:
                return self.dec.launch_spec(n, kv_len, kind)
            if not kind.draft:
                self.sync_history(idx)
            return self.dec.launch_spec(n, kv_len, kind, self.cur, self.spec_positions(act), act)

        def low_acc() -> bool:
            return eng.spec_min_accept > 0.0 and len(samples) >= 2 and sum(samples) / len(samples) < eng.spec_min_accept

        cur = launch(0)
        while True:
            nxt = None
            waiting = self.admit_waiting()
            if (eng.pipeline_decode and self.spec_room(idx, n, 1) and self.successor_safe(idx, n)
                    and not probing and not waiting):
                nxt = launch(1)
                stats["launched"] += 1
            finished = self.spec_consume(self.dec.read_spec(cur), idx, kind, samples)
            if nxt is None:
                # Probe grace: one more unpipelined chunk before the running
                # mean decides (acceptance develops with the history).
                if (probing and not waiting and not finished and not low_acc() and len(samples) < 2
                        and self.spec_room(idx, n, 0) and not self.cancel_hit()):
                    cur = launch(0)
                    continue
                return
            if finished or low_acc() or self.cancel_hit():
                stats["discarded"] += 1
                return
            cur = nxt

    def spec_consume(self, outs, idx, kind: SpecKind, samples: List[float]) -> bool:
        """Fold a speculative chunk's rounds into the host state; True when
        a slot hit a stop or its budget, or its request was cancelled (it
        takes none of the chunk's tokens).  A slot's position and token
        follow the device through every round, past a stop too: the slot
        retires before it decodes again."""
        targets, acc, lps = outs
        n = acc.shape[0]
        samples.append(float(acc[:, idx].mean()))
        self.eng.spec_stats["steps"] += n
        finished = False
        for s in idx:
            r = self.slot_req[s]
            if self.cancel is not None and self.cancel(r):
                finished = True
                continue
            for i in range(n):
                if self.emit(s, r, targets[i, s, : acc[i, s] + 1], lps[i, s]):
                    finished = True
                    break
            self.slot_pos[s] += int((acc[:, s] + 1).sum())
            self.cur[s] = targets[n - 1, s, acc[n - 1, s]]
            self.hist_len[s] = int(self.slot_pos[s]) + 1
            self.draft_pos[s] = self.slot_pos[s]  # the k+1 proposal steps cover every position below
        return finished

    def emit(self, s: int, r: int, tokens, lps) -> bool:
        """Append a round's emitted tokens to slot ``s``; True at a stop
        token or the budget (the rest are dropped)."""
        for j, t in enumerate(tokens):
            t = int(t)
            self.generated[s].append(t)
            self.eng.spec_stats["emitted"] += 1
            if self.return_logprobs:
                self.logprobs[s].append(float(lps[j]))
            if self.on_token is not None and t not in self.stops[r]:
                self.on_token(r, t)
            if t in self.stops[r] or len(self.generated[s]) >= self.budgets[r]:
                return True
        return False

    def spec_single(self, act, idx, kind: SpecKind, samples: List[float]) -> None:
        """One host-stepped verify round, eager: drafts by prompt lookup on
        the host (or k greedy steps of the draft model), one verify
        forward, the read-back."""
        eng, dec, k = self.eng, self.dec, kind.k
        dev = eng.device
        kv_len = self.spec_kv_len(act, k + 1)
        tok = torch.as_tensor(self.cur, dtype=torch.int32, device=dev)
        pos = torch.as_tensor(self.spec_positions(act), dtype=torch.int32, device=dev)
        if kind.draft:
            dparams, dcfg = eng._draft
            dfwd = functools.partial(_draft_step, cfg=dcfg, kv_len=kv_len)
            drafts, _ = draft_propose(dparams, tok, dec.dcache, pos, dfwd=dfwd, steps=k)
        else:
            host = np.zeros((len(self.cur), k), dtype=np.int32)
            for s in idx:
                host[s] = propose_ngram(self.prompts[self.slot_req[s]] + self.generated[s], k, eng.spec_ngram)
            drafts = torch.from_numpy(host).to(dev)
        fwd = functools.partial(_verify_forward, cfg=self.cfg, kv_len=kv_len)
        if kind.greedy:
            targets, acc, lps, _ = spec_verify(eng.params, tok, drafts, self.cache, pos, fwd=fwd, k=k)
        else:
            targets, acc, lps, _ = spec_verify_sampled(eng.params, tok, drafts, self.cache, pos, eng.keys.next(),
                                                       dec.bp, fwd=fwd, k=k)
        targets, acc, lps = targets.cpu().numpy(), acc.cpu().numpy(), lps.cpu().numpy()
        samples.append(float(acc[idx].mean()))
        eng.spec_stats["steps"] += 1
        for s in idx:
            r = self.slot_req[s]
            if self.cancel is not None and self.cancel(r):
                continue
            n_emit = int(acc[s]) + 1
            self.emit(s, r, targets[s, :n_emit], lps[s])
            self.slot_pos[s] += n_emit
            self.cur[s] = targets[s, n_emit - 1]
            # k proposal steps wrote draft K/V below pos + k: a fully
            # accepted round leaves one position for the catch-up.
            self.draft_pos[s] = min(self.slot_pos[s], self.slot_pos[s] - n_emit + k)

    def spec_adapt(self, samples: List[float]) -> None:
        """The controller's verdict on a round: below ``spec_min_accept``
        mean accepted drafts, pause for the cooldown (doubled on a repeated
        failure, up to ``spec_cooldown_max``); else reset the back-off."""
        if not samples:
            return
        eng = self.eng
        mean = sum(samples) / len(samples)
        self.spec_confident = mean >= eng.spec_min_accept
        if mean < eng.spec_min_accept:
            eng._spec_backoff = min(eng.spec_cooldown_max, (eng._spec_backoff * 2) or eng.spec_cooldown)
            eng._spec_pause = eng._spec_backoff
            eng.spec_stats["pauses"] += 1
        else:
            eng._spec_backoff = 0
