"""Greedy serving engine: continuous batching over a fixed slot count.

The counterpart of the JAX package's ``serve/engine.py`` for greedy
requests.  A fixed batch of slots decodes together; finished requests
retire and their slots refill from the queue; prompts are bucketed to
powers of two and same-bucket groups (of 4, 2 or 1) prefill together into
their slots, in segments of ``PREFILL_SEGMENT`` tokens above that length;
decode runs ``decode_chunk`` steps per host read-back, with idle slots
riding along frozen under an active-slot mask.  Params may be packed 4-bit
or int8-recoded (``recode_params_int8``), and the cache bf16 or int8
(``cfg.kv_quant``).

Decode chunks (the JAX package's ``_decode_multi_impl``, one compiled
``lax.scan`` per chunk length): a :class:`Decoder` runs ``n`` decode and
argmax steps over one cache from static device buffers (tokens, positions
and the active mask in; the chunk's tokens out).  Every step of a chunk
reads the same ``kv_len``, :func:`kv_bucket` of the chunk's end, so the
shapes repeat.  On CUDA every chunk of ``decode_chunk`` steps is one CUDA
graph, captured once per (kv bucket, n) and replayed on the current
stream; the graphs of a :class:`Decoder` share one memory pool.  Single
steps (the budget's tail), prefill and the CPU run eagerly, with the same
kv buckets, so graphed and eager decode give the same bits.  A failed
capture or replay raises: nothing falls back to the eager loop
(``cuda_graphs=False`` asks for eager chunks).

Pipelined decode (``pipeline_decode=True``, the JAX package's default):
chunk c+1 is launched from chunk c's device outputs (its last token and
advanced positions) before chunk c is read back, so the host's read-back
and bookkeeping overlap the device's next chunk; if chunk c ended a
request, chunk c+1 is dropped (``pipeline_stats``).  The cache is written
in place, unlike the JAX package's functional buffers, and a dropped chunk
is still harmless: it wrote K/V only at positions past each slot's
consumed position; the re-run, or a new request's prefill, rewrites each
such position before any query can see it, because a query sees no slot
past its own position, and a decode step writes its position before it
attends.  So no second cache buffer is held (the JAX package holds one
while a chunk is in flight).  On the CPU the same launch and read-back
logic runs synchronously.

:meth:`Engine.generate` hands one call to a :class:`_Scheduler`, which
owns the per-call state: the cache, its :class:`Decoder` and its graphs.
Speculation, prefix caching, admission, cancellation, LoRA, tensor
parallelism and non-greedy sampling are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.llama import KVCache, LlamaConfig, LlamaParams, check_supported, decode_step, forward, init_kv_cache
from ..ops._cuda import CountedGraph
from ..utils.device import resolve_device
from ..utils.shapes import bucket_len
from .sampling import SamplingParams, check_greedy, sample

__all__ = ["Engine", "Decoder", "GenerationResult", "kv_bucket"]


@dataclasses.dataclass
class GenerationResult:
    prompt: List[int]
    tokens: List[int]  # generated tokens, without the prompt or the stop token
    finished: bool  # True if a stop token ended it (False: budget or context)


def kv_bucket(end: int, granularity: int, max_seq_len: int) -> int:
    """The ``kv_len`` of a decode chunk whose last step writes position
    ``end - 1``: ``end`` rounded up to a multiple of ``granularity``, at
    most ``max_seq_len``.  One value for the whole chunk."""
    return min(-(-end // granularity) * granularity, max_seq_len)


class Engine:
    """Greedy continuous-batching engine on ``device`` (default ``cuda``);
    ``params`` must already live there.  On CUDA, decode chunks are CUDA
    graph replays unless ``cuda_graphs=False``; ``pipeline_decode`` launches
    each chunk's successor before reading the chunk back.

    ``pipeline_stats`` counts the chunks launched ahead of a read-back and
    those dropped because the chunk before them ended a request;
    ``graph_stats`` the decode graphs captured, the seconds their captures
    took, their replays and the largest memory pool they held (bytes)."""

    # Prompts longer than this prefill in segments: bounded activation
    # memory (the JAX package's value).
    PREFILL_SEGMENT = 2048
    # The granularity of a decode chunk's kv_len (kv_bucket): a multiple of
    # it bounds the cache slots the naive decode attention reads; each
    # bucket is a graph of its own, captured in ~1 s per generate.  From
    # position 1024, 256 / 512 / 1024 gave 17.1 / 18.7 / 22.8 ms per 4-bit
    # Llama-3-8B step at batch 4 (chip_smoke.py phase 5b, NVIDIA H100 80GB
    # HBM3, 700.00 W); 256 would capture twice as often.
    KV_BUCKET = 512

    def __init__(
        self,
        params: LlamaParams,
        cfg: LlamaConfig,
        batch_size: int = 8,
        eos_token: int = 2,
        sampling: SamplingParams = SamplingParams(),
        decode_chunk: int = 8,
        device=None,
        pipeline_decode: bool = True,
        cuda_graphs: bool = True,
    ):
        check_supported(cfg)
        check_greedy(sampling)
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
        self.graph_stream = None
        if cuda_graphs and self.device.type == "cuda":
            self.graph_stream = torch.cuda.Stream(self.device)
            self._warm_up()

    def _warm_up(self) -> None:
        """One eager decode step on the capture stream over a throwaway
        cache, before any capture: whatever the decode path makes at first
        use (the byte tables, the occupancy queries, the tile counters,
        cuBLAS's workspace for that stream, the kernels' shared-memory
        opt-in) then exists when a graph is captured.  Its launches count
        as eager ones."""
        width = min(16, self.cfg.max_seq_len)
        cache = init_kv_cache(dataclasses.replace(self.cfg, max_seq_len=width), self.batch_size, self.device)
        dec = Decoder(self, cache)
        self.graph_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.graph_stream):
            dec.run_eager(1, width)
        torch.cuda.synchronize(self.device)

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 64,
        sampling: Optional[SamplingParams] = None,
        stop_tokens: Optional[Sequence[int]] = None,
    ) -> List[GenerationResult]:
        """Greedy completions for all prompts, in prompt order.  Generation
        ends at ``eos_token``, a stop token (``stop_tokens`` plus the
        sampling params' own), the budget (``max_new_tokens`` unless the
        sampling params override it) or the context limit."""
        sp = sampling if sampling is not None else self.sampling
        check_greedy(sp)
        budget = sp.max_new_tokens if sp.max_new_tokens is not None else max_new_tokens
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        stops = frozenset({self.eos_token} | set(stop_tokens or ()) | set(sp.stop_tokens))
        return _Scheduler(self, prompts, budget, stops).run()

    # -- device work ----------------------------------------------------------

    def prefill_group(self, cache: KVCache, tokens: np.ndarray, lengths: np.ndarray, slots: np.ndarray):
        """Prefill a group of prompts (each padded to the same bucket) into
        cache slots ``slots``; returns the last-token logits [G, V].

        The slots' cache rows (the int8 scale planes' too) are gathered,
        run through the model and scattered back (the JAX package's
        ``_prefill_impl``).  Buckets above
        ``PREFILL_SEGMENT`` run segment by segment, each attending to the
        cache the earlier ones wrote; each row's logits come from the
        segment holding its last token."""
        dev = self.device
        g, bucket = tokens.shape
        slots_t = torch.as_tensor(slots, dtype=torch.long, device=dev)
        slot_cache = KVCache(**{name: t[:, slots_t] for name, t in cache.planes().items()})
        toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        seg = self.PREFILL_SEGMENT
        last = None
        for t0 in range(0, bucket, seg):
            width = min(seg, bucket - t0)
            positions = (t0 + torch.arange(width, dtype=torch.int32, device=dev)).expand(g, width)
            logits, _ = forward(
                self.params, self.cfg, toks[:, t0 : t0 + width], slot_cache, positions,
                torch.clamp(lens, max=t0 + width), last_only=True, kv_len=t0 + width,
            )
            here = torch.as_tensor((lengths - 1) // seg == t0 // seg, device=dev)
            last = logits if last is None else torch.where(here[:, None], logits, last)
        for name, t in slot_cache.planes().items():
            getattr(cache, name)[:, slots_t] = t
        return last


class Decoder:
    """Decode chunks over one cache: ``n`` greedy steps for every slot,
    inactive slots keeping their token and position.  Its graphs live as
    long as it does.

    The inputs live in static device buffers, ``inputs`` [3, B] int32
    (tokens, positions, active); a chunk writes its tokens [n, B] into
    ``toks`` and its last token and advanced positions back into the
    inputs, so the next chunk may start from them with no host copy.
    :meth:`launch` enqueues a chunk and the copy of its tokens into one of
    two pinned host buffers, then records an event; :meth:`read` waits for
    that event only, so a chunk launched after it keeps running.  The host
    buffers alternate, so a later chunk's copy cannot overwrite tokens not
    yet read; the device's ``toks`` needs no twin, as its copy is ordered
    before the next chunk on the stream."""

    def __init__(self, engine: Engine, cache: KVCache):
        dev = engine.device
        b = cache.k.shape[1]
        n = max(engine.decode_chunk, 1)
        self.eng, self.cache = engine, cache
        self.inputs = torch.zeros((3, b), dtype=torch.int32, device=dev)
        self.toks = torch.zeros((n, b), dtype=torch.int32, device=dev)
        pinned = dev.type == "cuda"
        self.host = [torch.zeros((n, b), dtype=torch.int32, pin_memory=pinned) for _ in range(2)]
        self.flip = 0
        self.graphs = {}  # (kv_len, n) -> CountedGraph
        self.pool = torch.cuda.graph_pool_handle() if engine.graph_stream is not None else None

    def launch(self, n: int, kv_len: int, tokens=None, positions=None, active=None):
        """Enqueue ``n`` steps at ``kv_len``; returns the handle
        :meth:`read` takes.  With host arrays ``tokens``, ``positions`` and
        ``active`` [B] the inputs are copied from them first; without, the
        chunk continues from the previous launch's device outputs.  On CUDA
        a chunk of ``n > 1`` steps is a graph replay."""
        if tokens is not None:
            host = np.stack([np.asarray(a, dtype=np.int32) for a in (tokens, positions, active)])
            # A pageable copy, so the host waits for the stream: it is idle
            # or still runs a dropped chunk, which this one must follow.
            self.inputs.copy_(torch.from_numpy(host))
        if self.pool is not None and n > 1:
            graph = self.graphs.get((kv_len, n)) or self._capture(n, kv_len)
            graph.replay()
            self.eng.graph_stats["replayed"] += 1
        else:
            self.run_eager(n, kv_len)
        out = self.host[self.flip][:n]
        self.flip ^= 1
        out.copy_(self.toks[:n], non_blocking=True)
        done = None
        if self.toks.is_cuda:
            done = torch.cuda.Event()
            done.record()
        return out, done

    @staticmethod
    def read(handle) -> np.ndarray:
        """The tokens [n, B] of a launched chunk, once its copy is done."""
        out, done = handle
        if done is not None:
            done.synchronize()
        return out.numpy().copy()

    def run_eager(self, n: int, kv_len: int) -> torch.Tensor:
        """The chunk's body, eagerly (and what a graph captures): ``n``
        decode steps and fp32 argmax from ``inputs``, the tokens into
        ``toks[:n]``, the last token and the positions back into
        ``inputs``.  Nothing here touches the host.  Returns the last
        step's logits."""
        eng = self.eng
        tok, pos, active = self.inputs
        act = active != 0
        out = []
        for _ in range(n):
            logits, _ = decode_step(eng.params, eng.cfg, tok, self.cache, pos, kv_len=kv_len)
            tok = torch.where(act, sample(logits, eng.sampling), tok)
            out.append(tok)
            pos = pos + active
        self.toks[:n] = torch.stack(out)
        self.inputs[:2] = torch.stack((tok, pos))
        return logits

    def _capture(self, n: int, kv_len: int) -> CountedGraph:
        """Capture the chunk body for (kv_len, n) on the engine's capture
        stream, into this decoder's memory pool."""
        stats = self.eng.graph_stats
        t0 = time.perf_counter()
        graph = CountedGraph()
        with graph.capture(pool=self.pool, stream=self.eng.graph_stream):
            self.run_eager(n, kv_len)
        stats["capture_s"] += time.perf_counter() - t0
        stats["captured"] += 1
        stats["pool_bytes"] = max(stats["pool_bytes"], self.pool_bytes())
        self.graphs[(kv_len, n)] = graph
        return graph

    def pool_bytes(self) -> int:
        """Device bytes held by this decoder's graph memory pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s["segment_pool_id"]) == pool)


class _Scheduler:
    """The host-side state of one :meth:`Engine.generate` call: the queue,
    each slot's request, position, generated tokens and next input token."""

    def __init__(self, engine: Engine, prompts, budget: int, stops: frozenset):
        self.eng = engine
        self.cfg = engine.cfg
        self.prompts = [list(p) for p in prompts]
        self.budget = budget
        self.stops = stops
        self.queue = collections.deque(range(len(self.prompts)))
        self.results: List[Optional[GenerationResult]] = [None] * len(self.prompts)
        n = engine.batch_size
        self.cache = init_kv_cache(self.cfg, n, device=engine.device)
        self.dec = Decoder(engine, self.cache)
        self.slot_req = [-1] * n  # request index, or -1 when idle
        self.slot_pos = np.zeros(n, dtype=np.int64)  # next position to write
        self.generated: List[List[int]] = [[] for _ in range(n)]
        self.cur = np.zeros(n, dtype=np.int32)  # next input token

    def active(self) -> np.ndarray:
        return np.asarray([r != -1 for r in self.slot_req])

    def run(self) -> List[GenerationResult]:
        self.refill()
        while self.active().any() or self.queue:
            self.retire()
            self.refill()
            if not self.active().any():
                break
            self.decode()
        return [r for r in self.results if r is not None]

    def retire(self) -> None:
        for s, r in enumerate(self.slot_req):
            if r == -1:
                continue
            gen = self.generated[s]
            done_eos = bool(gen) and gen[-1] in self.stops
            done_len = len(gen) >= self.budget
            done_ctx = self.slot_pos[s] >= self.cfg.max_seq_len - 1
            if done_eos or done_len or done_ctx:
                out = gen[:-1] if done_eos else gen
                self.results[r] = GenerationResult(list(self.prompts[r]), out, done_eos)
                self.slot_req[s] = -1
                self.generated[s] = []

    def refill(self) -> None:
        """Give queued requests the idle slots and prefill them in
        same-bucket groups of 4, 2 or 1."""
        cfg = self.cfg
        pending = []  # (slot, request, bucket)
        for s in range(len(self.slot_req)):
            if self.slot_req[s] != -1:
                continue
            while self.queue:
                r = self.queue.popleft()
                prompt = self.prompts[r]
                if len(prompt) == 0 or len(prompt) >= cfg.max_seq_len:
                    self.results[r] = GenerationResult(list(prompt), [], True)
                    continue
                self.slot_req[s] = r
                pending.append((s, r, min(bucket_len(len(prompt)), cfg.max_seq_len)))
                break
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
        first = sample(logits, self.eng.sampling).cpu().numpy()
        for j, (s, r, _) in enumerate(chunk):
            self.slot_pos[s] = len(self.prompts[r])
            self.generated[s] = [int(first[j])]
            self.cur[s] = first[j]

    def chunk_ok(self, idx, n: int, ahead: int) -> bool:
        """Is a chunk of ``n`` steps launched ``ahead`` whole chunks past the
        current host state sure to fit every active slot's budget and
        context?"""
        room = min(self.budget - len(self.generated[s]) for s in idx) - ahead * n
        ctx_room = self.cfg.max_seq_len - 1 - (int(self.slot_pos[idx].max()) + ahead * n)
        return room >= n and ctx_room >= n

    def launch(self, act, n: int, ahead: int = 0):
        """Launch ``n`` steps: from the host state, or (``ahead=1``) from the
        device outputs of the chunk launched just before."""
        kv_len = kv_bucket(int(self.slot_pos[act].max()) + (ahead + 1) * n, self.eng.KV_BUCKET,
                           self.cfg.max_seq_len)
        if ahead:
            return self.dec.launch(n, kv_len)
        return self.dec.launch(n, kv_len, self.cur, self.slot_pos, act)

    def consume(self, handle, act, n: int) -> bool:
        """Read a launched chunk back into the host state; True when a slot
        hit a stop or its budget (it retires before it decodes again)."""
        toks = self.dec.read(handle)
        self.slot_pos[act] += n
        finished = False
        for s in np.nonzero(act)[0]:
            for i in range(n):
                t = int(toks[i, s])
                self.generated[s].append(t)
                # Tokens after a stop or past the budget are dropped.
                if t in self.stops or len(self.generated[s]) >= self.budget:
                    finished = True
                    break
            self.cur[s] = toks[n - 1, s]
        return finished

    def decode(self) -> None:
        """Decode chunks while every active slot has room for one (budget
        and context), else a single step.  Pipelined, each chunk's
        successor is launched before the chunk is read back, when the
        successor too is sure to fit; it is dropped when the chunk ended a
        request (the JAX package's multi-step branch of ``generate``)."""
        act = self.active()
        idx = np.nonzero(act)[0]
        n = self.eng.decode_chunk
        if not (n > 1 and self.chunk_ok(idx, n, 0)):
            self.consume(self.launch(act, 1), act, 1)
            return
        stats = self.eng.pipeline_stats
        cur = self.launch(act, n)
        while True:
            nxt = None
            if self.eng.pipeline_decode and self.chunk_ok(idx, n, 1):
                nxt = self.launch(act, n, ahead=1)
                stats["launched"] += 1
            finished = self.consume(cur, act, n)
            if nxt is None:
                return
            if finished:
                stats["discarded"] += 1
                return
            cur = nxt
