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

:meth:`Engine.generate` hands one call to a :class:`_Scheduler`, which
owns the per-call state.  Pipelined chunks, speculation, prefix caching,
admission, cancellation, LoRA, tensor parallelism and non-greedy sampling
are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.llama import KVCache, LlamaConfig, LlamaParams, check_supported, decode_step, forward, init_kv_cache
from ..utils.device import resolve_device
from ..utils.shapes import bucket_len
from .sampling import SamplingParams, check_greedy, sample

__all__ = ["Engine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    prompt: List[int]
    tokens: List[int]  # generated tokens, without the prompt or the stop token
    finished: bool  # True if a stop token ended it (False: budget or context)


class Engine:
    """Greedy continuous-batching engine on ``device`` (default ``cuda``);
    ``params`` must already live there."""

    # Prompts longer than this prefill in segments: bounded activation
    # memory (the JAX package's value).
    PREFILL_SEGMENT = 2048

    def __init__(
        self,
        params: LlamaParams,
        cfg: LlamaConfig,
        batch_size: int = 8,
        eos_token: int = 2,
        sampling: SamplingParams = SamplingParams(),
        decode_chunk: int = 8,
        device=None,
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

    def decode_steps(self, cache: KVCache, tokens: np.ndarray, positions: np.ndarray, active: np.ndarray, n: int):
        """``n`` greedy decode steps for every slot with one read-back at the
        end; inactive slots keep their token and position.  Returns the
        sampled tokens [n, B] on the host."""
        dev = self.device
        tok = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
        pos = torch.as_tensor(positions, dtype=torch.int32, device=dev)
        act = torch.as_tensor(active, device=dev)
        step = act.to(torch.int32)
        top = int(positions[active].max())  # host-side bound for the live cache
        out = []
        for i in range(n):
            logits, _ = decode_step(self.params, self.cfg, tok, cache, pos, kv_len=top + i + 1)
            tok = torch.where(act, sample(logits, self.sampling), tok)
            out.append(tok)
            pos = pos + step
        return torch.stack(out).cpu().numpy()


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

    def decode(self) -> None:
        """One decode chunk when every active slot has room for it (budget
        and context), else a single step."""
        act = self.active()
        idx = np.nonzero(act)[0]
        n = self.eng.decode_chunk
        room = min(self.budget - len(self.generated[s]) for s in idx)
        ctx_room = self.cfg.max_seq_len - 1 - int(self.slot_pos[act].max())
        if not (n > 1 and room >= n and ctx_room >= n):
            n = 1
        toks = self.eng.decode_steps(self.cache, self.cur, self.slot_pos, act, n)
        self.slot_pos[act] += n
        for s in idx:
            for i in range(n):
                t = int(toks[i, s])
                self.generated[s].append(t)
                # Tokens after a stop or past the budget are dropped; the
                # slot retires before it decodes again.
                if t in self.stops or len(self.generated[s]) >= self.budget:
                    break
            self.cur[s] = toks[n - 1, s]
