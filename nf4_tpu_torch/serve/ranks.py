"""The serving CLI over ranks: ``python -m nf4_tpu_torch.serve --tp N --dp M``.

The JAX CLI serves a mesh from one process.  Here every rank of the
``dp x tp`` mesh is a process of its own running ``Engine(mesh=)``, and
every rank must run the same ``generate`` and take the same decisions
(``serve/engine.py``, tensor and data parallelism).  Rank 0 is the CLI
process: it holds the HTTP front (:class:`~nf4_tpu_torch.serve.api.
CompletionServer`) and starts ranks 1 .. N*M-1 (``parallel.launch.Ranks``
with ``lead=True``), each running :func:`follow_rank` on the same
arguments.

What the dispatcher decides at run time, in rank 0's threads, reaches the
other ranks over one control channel (:class:`Channel`, gloo groups on the
CPU beside the mesh's own): each wave's requests (prompts, per-request
``SamplingParams``, ``max_new_tokens``, ``return_logprobs``, adapters), and
the answer to EVERY poll of a callback at the moment the engine polls it
(``admit(features)`` -> the admitted requests, ``admit.peek()`` and
``cancel(r)`` -> a flag).  The followers run the same ``generate`` with
callbacks that return those answers and never evaluate one themselves, so
a cancel that only rank 0's handler thread saw, or a request that reached
the queue between two chunks, lands at the same step on every rank.
:class:`LeadEngine` wraps rank 0's Engine so that ``CompletionServer``
takes it unchanged.

After each wave every rank contributes a digest of its outcome (the
results, or the error it raised) to one ``all_gather``; a mismatch raises
on every rank (:class:`RankDivergence`): the dispatcher reports it to the
wave's waiters, the followers exit, and the CLI ends non-zero.  A rank
that dies ends the server the same way (``Ranks.poll``); a rank whose
caller died exits (``parallel/launch.py``).  ``Engine.score`` over a mesh
raises, so ``echo`` + ``logprobs`` requests get that error, as the JAX
server's would.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import signal
import sys
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Channel", "LeadEngine", "RankDivergence", "follow", "follow_rank", "serve_ranks"]

# The control channel waits as long as the server is idle; a wave's digest
# comes within moments of its last collective on every rank.
_IDLE_TIMEOUT = datetime.timedelta(days=365)
_DIGEST_TIMEOUT = datetime.timedelta(seconds=120)


class RankDivergence(RuntimeError):
    """The ranks' outcomes of one wave differ."""


def digest(outcome) -> int:
    """A 63-bit digest of a wave's outcome: the results' ``repr`` (every
    token, finish flag and logprob; floats as their shortest round-trip
    text), or the error's type and message."""
    return int.from_bytes(hashlib.blake2b(repr(outcome).encode(), digest_size=8).digest(), "little") >> 1


class Channel:
    """Rank 0's decisions sent to every rank of the job: broadcasts over a
    gloo group on the CPU (it works beside an NCCL mesh), and the digest
    check over another, with a short timeout.  Every rank must make it, in
    the same order among the job's groups.  ``stats`` (rank 0): waves,
    polls answered, and the seconds spent in the channel."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.group = dist.new_group(backend="gloo", timeout=_IDLE_TIMEOUT)
        self.check_group = dist.new_group(backend="gloo", timeout=_DIGEST_TIMEOUT)
        self.stats = {"waves": 0, "polls": 0, "seconds": 0.0}

    def send(self, obj=None):
        """Rank 0: broadcast ``obj``; the others: receive and return it."""
        t0 = time.perf_counter()
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        self.stats["seconds"] += time.perf_counter() - t0
        return box[0]

    def flag(self, value: bool = False) -> bool:
        """Rank 0: broadcast the answer to one poll; the others: receive it."""
        t0 = time.perf_counter()
        t = torch.tensor([int(bool(value))], dtype=torch.uint8)
        dist.broadcast(t, src=0, group=self.group)
        self.stats["polls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return bool(t.item())

    def agree(self, outcome) -> None:
        """Every rank's digest of ``outcome`` in one ``all_gather``; raises
        :class:`RankDivergence` on every rank when they differ."""
        t0 = time.perf_counter()
        mine = torch.tensor([digest(outcome)], dtype=torch.int64)
        every = [torch.zeros_like(mine) for _ in range(dist.get_world_size(self.check_group))]
        dist.all_gather(every, mine, group=self.check_group)
        self.stats["waves"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        if any(int(d) != int(mine) for d in every):
            raise RankDivergence(f"the ranks' outcomes of wave {self.stats['waves']} differ (digests "
                                 f"{[int(d) for d in every]}): rank {self.rank} had {_summary(outcome)}")


def _summary(outcome) -> str:
    if isinstance(outcome, tuple):
        return f"{outcome[1]}: {outcome[2]}"
    return f"{len(outcome)} results, tokens {[r.tokens for r in outcome]}"


def _outcome(e: BaseException) -> tuple:
    return ("error", type(e).__name__, str(e))


class LeadEngine:
    """Rank 0's :class:`~nf4_tpu_torch.serve.engine.Engine` as the HTTP
    front sees it: :meth:`generate` sends the wave and every callback's
    answer down the :class:`Channel`, then checks the ranks' digests;
    everything else is the Engine's.  ``channel_stats`` is the channel's
    ``stats`` with the seconds the waves took (``generate_seconds``)."""

    def __init__(self, engine, channel: Channel):
        self.engine, self.channel = engine, channel
        self.generate_seconds = 0.0
        self.broken: Optional[str] = None

    def __getattr__(self, name):
        return getattr(self.engine, name)

    @property
    def channel_stats(self) -> dict:
        return dict(self.channel.stats, generate_seconds=self.generate_seconds)

    def generate(self, prompts, max_new_tokens: int = 64, sampling=None, return_logprobs: bool = False,
                 stop_tokens=None, on_token=None, adapter=None, admit=None, cancel=None):
        if self.broken is not None:
            raise RuntimeError(f"the ranks are out of step: {self.broken}")
        ch = self.channel
        t0 = time.perf_counter()
        peek = getattr(admit, "peek", None)
        ch.send(("wave", dict(prompts=[list(p) for p in prompts], max_new_tokens=max_new_tokens, sampling=sampling,
                              return_logprobs=return_logprobs, stop_tokens=stop_tokens, adapter=adapter,
                              admit=admit is not None, peek=peek is not None, cancel=cancel is not None)))
        admit_ = cancel_ = None
        if admit is not None:
            def admit_(features):
                return ch.send([(list(t), sp, ad) for t, sp, ad in admit(features)])

            if peek is not None:
                admit_.peek = lambda: ch.flag(peek())
        if cancel is not None:
            def cancel_(r):
                return ch.flag(cancel(r))

        try:
            results = self.engine.generate(prompts, max_new_tokens, sampling, return_logprobs, stop_tokens,
                                           on_token, adapter, admit_, cancel_)
        except Exception as e:
            self._agree(_outcome(e))
            raise
        finally:
            self.generate_seconds += time.perf_counter() - t0
        self._agree(results)
        return results

    def _agree(self, outcome) -> None:
        try:
            self.channel.agree(outcome)
        except Exception as e:
            self.broken = f"{type(e).__name__}: {e}"
            raise

    def close(self) -> None:
        """Tell the other ranks to stop (after the last wave)."""
        if self.broken is None:
            self.channel.send(("stop", None))


def follow(engine, channel: Channel) -> int:
    """A rank's serving loop: run each wave rank 0 sends on ``engine``, every
    callback answered from the channel, until rank 0 says stop; returns the
    waves served.  An error that rank 0's Engine raised too (the same
    digest) is the wave's outcome and the loop goes on; any other raises."""
    waves = 0
    while True:
        kind, wave = channel.send()
        if kind == "stop":
            return waves
        admit = cancel = None
        if wave["admit"]:
            def admit(features):
                return channel.send()

            if wave["peek"]:
                admit.peek = channel.flag
        if wave["cancel"]:
            def cancel(r):
                return channel.flag()

        try:
            outcome = engine.generate(wave["prompts"], wave["max_new_tokens"], wave["sampling"],
                                      wave["return_logprobs"], wave["stop_tokens"], lambda r, t: None,
                                      wave["adapter"], admit, cancel)
        except Exception as e:
            outcome = _outcome(e)
        channel.agree(outcome)
        waves += 1


def follow_rank(mesh, args) -> int:
    """The body of ranks 1 .. N*M-1: the channel, the Engine of ``args``
    over ``mesh`` (``serve.__main__.build_engine``), then :func:`follow`."""
    from .__main__ import build_engine

    channel = Channel()
    engine, _ = build_engine(args, mesh)
    return follow(engine, channel)


def serve_ranks(args, block: bool = True):
    """Rank 0 of the CLI over ``args.tp x args.dp`` ranks: start the others
    (the same ``args``), build its Engine and the HTTP front, serve until
    interrupted (``SIGINT`` or ``SIGTERM``) or until a rank fails.  Returns
    0, or 1 when a rank failed; with ``block=False`` the running
    :class:`~nf4_tpu_torch.serve.api.CompletionServer`, whose ``stop``
    also stops the ranks."""
    from ..parallel.launch import Ranks
    from .__main__ import build_engine
    from .api import CompletionServer

    world = args.tp * args.dp
    device = args.device or "cuda"
    # The host's cores split over the ranks (at most torch's own count, which
    # OMP_NUM_THREADS sets).
    threads = max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // world))
    ranks = Ranks(world, backend=args.dist_backend, device=device, threads=threads, lead=True)
    try:
        ranks.start(follow_rank, args, tp=args.tp, dp=args.dp)
        mesh = ranks.mesh(args.tp, args.dp)
        channel = Channel()
        engine, tokenizer = build_engine(args, mesh)
        front = LeadEngine(engine, channel)
        server = CompletionServer(front, tokenizer, model_name=args.model_name, batch_window=args.batch_window)
        port = server.start(args.host, args.port)
    except BaseException:
        ranks.close(kill=True)
        raise
    print(f"serving on http://{args.host}:{port} (model={args.model_name}, slots={args.batch_size}, ranks {world}: "
          f"dp {args.dp} x tp {args.tp} over {args.dist_backend} on {mesh.device})", file=sys.stderr, flush=True)
    stop_server = server.stop

    def stop() -> None:
        """Stop the front (after its wave), then the ranks."""
        stop_server()
        front.close()
        ranks.join()
        ranks.close()

    if not block:
        server.stop = stop
        return server
    stopping = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stopping.set())
    while not stopping.is_set() and not ranks.poll(0.5):
        pass
    if stopping.is_set():
        stop()
        return 0
    # A rank answered while serving: it failed or exited.  The dispatcher may
    # be waiting in a collective with it, so nothing waits for the dispatcher.
    try:
        ranks.join()
        error = "a rank returned while serving"
    except Exception as e:
        error = str(e)
    print(f"a rank failed; the server stops:\n{error}", file=sys.stderr, flush=True)
    ranks.close(kill=True)
    os._exit(1)
