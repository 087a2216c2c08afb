"""Rank bodies that drive the multi-rank paths on the card and report
what ran: the work of ``chip_smoke.py``'s multi-rank phases on each rank
(run there through :class:`~nf4_tpu_torch.parallel.launch.Ranks`; a rank
imports this module, never the script): tensor-parallel serving
(:func:`serve_rank`), data-parallel serving (:func:`dp_serve_rank`), the
sequence-parallel ring prefill (:func:`sp_rank`) and QLoRA training over a
mesh (:func:`train_rank`).  Each fails on any error; the caller holds the
numbers it returns to their expected values."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.llama import decode_step, init_kv_cache, recode_params_int8
from ..models.loader import load_packed_sharded
from ..ops import _cuda
from ..serve.engine import Decoder, Engine, kv_bucket, prefill_rows
from ..utils.held import kernels_held_to_plain

__all__ = ["serve_rank", "dp_serve_rank", "sp_rank", "train_rank", "every_rank"]


def _sync(dev: torch.device) -> float:
    """The host clock once ``dev``'s queued work is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _decode_ms(eng: Engine, cache, steps: int, pos0: int) -> float:
    """ms per eager decode step at batch 4 from position ``pos0``: chunks of
    8 steps after one untimed chunk, as ``chip_smoke.py`` times decode."""
    n, chunks = 8, steps // 8
    cur, pos, act = np.zeros(4, np.int32), np.full(4, pos0, np.int64), np.ones(4, bool)
    dec = Decoder(eng, cache)
    kv = kv_bucket(pos0 + (chunks + 1) * n, eng.KV_BUCKET, eng.cfg.max_seq_len)
    dec.read(dec.launch(n, kv, cur, pos, act))
    t0 = _sync(eng.device)
    for _ in range(chunks):
        out = dec.read(dec.launch(n, kv))
    ms = (_sync(eng.device) - t0) * 1e3 / (chunks * n)
    if not ((out >= 0) & (out < eng.cfg.vocab_size)).all():
        raise RuntimeError("decode tokens out of the vocabulary")
    return ms


def serve_rank(mesh, path: str, prompts, new_tokens: int, int8: bool = False, label: str = "tp",
               pos0: int = 1024) -> list:
    """On one rank: load its slice of the packed checkpoint at ``path``
    (``load_packed_sharded``; ``int8``: an int8 KV cache and the weights
    recoded to int8), serve ``prompts`` greedily for ``new_tokens`` tokens
    at batch 4 on ``Engine(mesh=)`` (eager, pipelined) with every launch
    count set to 0 just before and read just after, then the prompts for 2
    tokens with every kernel B, C and D call held to its plain version
    (``utils.held``); then time eager decode at batch 4 from position
    ``pos0`` (32 steps), again with each collective timed (the device
    synchronized around it), and one prefill of ``prompts[0]``.  Returns
    every rank's report (on every rank), in rank order."""
    dev = mesh.device
    t0 = time.perf_counter()
    params, cfg = load_packed_sharded(path, mesh, kv_quant=int8)
    if int8:
        params = recode_params_int8(params)
    load_s = _sync(dev) - t0
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, cuda_graphs=False, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    comm0 = dict(mesh.stats)
    t0 = time.perf_counter()
    results = eng.generate(prompts, max_new_tokens=new_tokens)
    gen_s = _sync(dev) - t0
    counts = _cuda.launch_counts()
    comm = {k: mesh.stats[k] - comm0[k] for k in ("calls", "bytes")}
    with kernels_held_to_plain(f"{label} rank {mesh.tp_rank}", report=False) as held:
        eng.generate(prompts, max_new_tokens=2)
    cache = init_kv_cache(eng.cfg, 4, device=dev)
    step_ms = _decode_ms(eng, cache, 32, pos0)
    mesh.timed, seconds0 = True, mesh.stats["seconds"]
    timed_ms = _decode_ms(eng, cache, 32, pos0)
    comm_ms = (mesh.stats["seconds"] - seconds0) * 1e3 / 32
    mesh.timed = False
    toks, lens, slots = np.asarray([prompts[0]], np.int32), np.asarray([len(prompts[0])], np.int32), np.asarray([0])
    runs = []
    for _ in range(3):
        t0 = _sync(dev)
        logits = eng.prefill_group(cache, toks, lens, slots)
        runs.append((_sync(dev) - t0) * 1e3)
    if not (bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab_size)):
        raise RuntimeError("prefill logits not finite or not full rows")
    report = dict(rank=mesh.tp_rank, device=str(mesh.device), backend=mesh.backend, tp=mesh.tp,
                  tokens=[r.tokens for r in results], counts=counts, held=held, comm=comm, load_s=load_s,
                  generate_s=gen_s, decode_ms_step=step_ms, decode_timed_ms_step=timed_ms,
                  comm_ms_step=comm_ms, prefill_ms=sorted(runs)[1],
                  peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None,
                  local_heads=eng.cfg.num_heads, local_kv_heads=eng.cfg.num_kv_heads)
    every = [None] * mesh.tp
    dist.all_gather_object(every, report, group=mesh.tp_group)
    return every


def every_rank(mesh, value) -> list:
    """``value`` of every rank of the mesh, in mesh rank order (dp-major),
    on every rank: gathered over the tensor-parallel group, then over the
    data-parallel one."""
    per_tp = [None] * mesh.tp
    dist.all_gather_object(per_tp, value, group=mesh.tp_group)
    per_dp = [None] * mesh.dp
    dist.all_gather_object(per_dp, per_tp, group=mesh.dp_group)
    return [v for group in per_dp for v in group]


def _peak_gb(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


@contextlib.contextmanager
def _serving_tally(eng: Engine):
    """Within it, count what this rank's Engine launched: decode forwards
    (a chunk of n steps is n) and the prefill groups it ran over its own
    rows, as (rows, bucket) per segment of ``Engine.PREFILL_SEGMENT``."""
    tally = {"decode": 0, "groups": []}
    _, dec = eng.state()
    launch, local = dec.launch, eng.prefill_local
    seg = eng.PREFILL_SEGMENT

    def on_launch(n, *a, **kw):
        tally["decode"] += n
        return launch(n, *a, **kw)

    def on_prefill(cache, tokens, *a, **kw):
        g, bucket = tokens.shape
        tally["groups"] += [(g, min(seg, bucket - t0)) for t0 in range(0, bucket, seg)]
        return local(cache, tokens, *a, **kw)

    dec.launch, eng.prefill_local = on_launch, on_prefill
    try:
        yield tally
    finally:
        del dec.launch, eng.prefill_local


def dp_serve_rank(mesh, path, prompts, new_tokens: int, int8: bool = False, label: str = "dp",
                  pos0: int = 1024) -> list:
    """On one rank of a dp x tp mesh: load its slice of the packed
    checkpoint at ``path`` (``int8``: an int8 KV cache, the weights recoded
    to int8), serve ``prompts`` greedily for ``new_tokens`` tokens at batch
    4 on ``Engine(mesh=)`` (eager, pipelined; each rank's cache holds its dp
    group's ``4 / dp`` slots) with every launch count set to 0 just before
    and read just after, and the decode forwards and local prefill groups
    that ran; then the prompts for 2 tokens with every kernel call held to
    its plain version; then eager decode at batch 4 from position ``pos0``
    (32 steps) timed, with the collectives of each step counted, and again
    with each collective timed.  Returns every rank's report, in mesh rank
    order."""
    dev = mesh.device
    t0 = time.perf_counter()
    params, cfg = load_packed_sharded(path, mesh, kv_quant=int8)
    if int8:
        params = recode_params_int8(params)
    load_s = _sync(dev) - t0
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, cuda_graphs=False, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with _serving_tally(eng) as tally:
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        results = eng.generate(prompts, max_new_tokens=new_tokens)
        gen_s = _sync(dev) - t0
        counts = _cuda.launch_counts()
    cache_rows = eng.state()[0].k.shape[1]
    with kernels_held_to_plain(f"{label} rank {mesh.rank}", report=False) as held:
        eng.generate(prompts, max_new_tokens=2)
    cache = init_kv_cache(eng.cfg, eng.local_batch, device=dev)
    comm0 = dict(mesh.stats)
    step_ms = _decode_ms(eng, cache, 32, pos0)
    # One untimed chunk and 4 timed chunks of 8: 40 steps.
    comm = {k: (mesh.stats[k] - comm0[k]) / 40 for k in ("calls", "bytes")}
    mesh.timed, seconds0 = True, mesh.stats["seconds"]
    timed_ms = _decode_ms(eng, cache, 32, pos0)
    comm_ms = (mesh.stats["seconds"] - seconds0) * 1e3 / 40
    mesh.timed = False
    report = dict(rank=mesh.rank, dp_rank=mesh.dp_rank, tp_rank=mesh.tp_rank, device=str(dev), backend=mesh.backend,
                  tp=mesh.tp, dp=mesh.dp, rows=list(eng.rows[:2]) if eng.rows else [0, 4], cache_rows=cache_rows,
                  tokens=[r.tokens for r in results], counts=counts, tally=tally, held=held, comm_step=comm,
                  load_s=load_s, generate_s=gen_s, decode_ms_step=step_ms, decode_timed_ms_step=timed_ms,
                  comm_ms_step=comm_ms, peak_gb=_peak_gb(dev), local_heads=eng.cfg.num_heads,
                  local_kv_heads=eng.cfg.num_kv_heads)
    return every_rank(mesh, report)


def _near_tie_ok(got: torch.Tensor, want: torch.Tensor, rel: float) -> bool:
    """Each row's argmax of ``got`` equals ``want``'s, or ``want``'s top-2
    gap is at most ``rel`` times its largest |logit| (a near-tie)."""
    top2 = want.float().topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= rel * want.float().abs().amax()
    return bool(((got.argmax(-1) == want.argmax(-1)) | tie).all())


def _one_process_prefill(params, cfg, prompt, dev, plain: bool):
    """The prompt prefilled in one process (the Engine's ``prefill_rows``):
    (last-token logits [1, V], cache); with ``plain``, kernel C's wrapper
    runs its plain version on fp32 q, k and v (``ops.attention.
    _flash_plain``: the streaming softmax with fp32 probabilities, the
    ring's own math), as ``tests/test_sp.py`` holds the ring to
    ``prefill_chunked``."""
    from ..ops import attention

    saved = attention._flash_kernel
    if plain:
        attention._flash_kernel = lambda q, k, v, *a: attention._flash_plain(q.float(), k.float(), v.float(),
                                                                             *a).to(q.dtype)
    try:
        cache = init_kv_cache(cfg, 1, device=dev)
        logits = prefill_rows(params, cfg, cache, np.asarray([prompt], np.int32), np.asarray([len(prompt)], np.int32),
                              np.zeros(1, np.int64), dev, segment=Engine.PREFILL_SEGMENT)
    finally:
        attention._flash_kernel = saved
    return logits, cache


def _held_to(logits, cache, want, one, s: int, cfg, params, lens, steps: int, near_tie: float, tol: float) -> dict:
    """How the ring's (logits, cache) agree with a one-process (want, one):
    layer 0's K/V (and scales) bit for bit, the largest |a - b| of each
    plane and layer and ``max(|a - b| - tol (1 + |b|))`` (bf16 planes),
    the logits' error over their largest value, the next token and
    ``steps`` greedy decode steps (teacher-forced on the one-process
    tokens, the caches written as they go) under the near-tie rule."""
    names = list(cache.planes())
    diff = {n: [(getattr(cache, n)[i, ..., :s, :].float() - getattr(one, n)[i, ..., :s, :].float()).abs().max().item()
                if n in ("k", "v") else
                (getattr(cache, n)[i, ..., :s] - getattr(one, n)[i, ..., :s]).abs().max().item()
                for i in range(cfg.num_layers)] for n in names}
    excess = None
    if not cfg.kv_quant:
        excess = max(((getattr(cache, n)[..., :s, :].float() - getattr(one, n)[..., :s, :].float()).abs()
                      - tol * (1 + getattr(one, n)[..., :s, :].float().abs())).max().item() for n in ("k", "v"))
    out = dict(layer0_identical=all(torch.equal(getattr(cache, n)[0, ..., :s, :] if n in ("k", "v") else
                                                getattr(cache, n)[0, ..., :s],
                                                getattr(one, n)[0, ..., :s, :] if n in ("k", "v") else
                                                getattr(one, n)[0, ..., :s]) for n in names),
               max_diff=diff, cache_excess=excess, logit_err=((logits - want).abs().max() / want.abs().max()).item(),
               next_token_ok=_near_tie_ok(logits, want, near_tie))
    tok, pos, ok, fed = want.argmax(-1).to(torch.int32), lens.clone(), [], []
    for _ in range(steps):
        fed.append(int(tok[0]))
        got, cache = decode_step(params, cfg, tok, cache, pos)
        ref, one = decode_step(params, cfg, tok, one, pos)
        ok.append(_near_tie_ok(got, ref, near_tie))
        tok, pos = ref.argmax(-1).to(torch.int32), pos + 1
    return dict(out, decode_ok=ok, decode_tokens=fed)


def sp_rank(mesh, path, prompt, int8: bool = False, steps: int = 8, label: str = "sp", near_tie: float = 2e-2,
            cache_tol: float = 5e-2) -> list:
    """On one rank of a sequence-parallel ring (the dp axis of a tp = 1
    mesh): load the whole packed model at ``path`` (``int8``: an int8 KV
    cache), prefill the one prompt over the ring (``parallel.sp.
    sp_prefill``; the launches counted, the median of 3 timed), once more
    with every kernel call held to its plain version, and the same prompt
    in one process (the Engine's ``prefill_rows``; 3 timed): on kernel C,
    the serving path, and on its plain version in fp32, the ring's own
    streaming softmax.  Reports how the ring's result agrees with each
    (:func:`_held_to`: ``steps`` decode steps, ``cache_tol`` for the
    cache); the caller gates on the plain one.  Returns every rank's
    report."""
    from .sp import ring_of, sp_prefill

    dev = mesh.device
    params, cfg = load_packed_sharded(path, mesh, kv_quant=int8)
    ring = ring_of(mesh)
    s = len(prompt)
    toks = torch.as_tensor(np.asarray([prompt], np.int32), device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for i in range(3):
        comm0 = dict(mesh.stats)
        _cuda.reset_launch_counts()
        t0 = _sync(dev)
        logits, cache, lens = sp_prefill(params, cfg, toks, ring)
        runs.append((_sync(dev) - t0) * 1e3)
        if i == 0:
            counts = _cuda.launch_counts()
            comm = {k: mesh.stats[k] - comm0[k] for k in ("calls", "bytes")}
        del logits, cache
    with kernels_held_to_plain(f"{label} rank {mesh.rank}", report=False) as held:
        logits, cache, lens = sp_prefill(params, cfg, toks, ring)
    peak = _peak_gb(dev)
    one_runs = []
    for _ in range(3):
        t0 = _sync(dev)
        want_c, one_c = _one_process_prefill(params, cfg, prompt, dev, plain=False)
        one_runs.append((_sync(dev) - t0) * 1e3)
    want_p, one_p = _one_process_prefill(params, cfg, prompt, dev, plain=True)
    plain = _held_to(logits, _clone(cache), want_p, one_p, s, cfg, params, lens, steps, near_tie, cache_tol)
    kernel_c = _held_to(logits, cache, want_c, one_c, s, cfg, params, lens, steps, near_tie, cache_tol)
    report = dict(rank=mesh.rank, sp=ring.size, device=str(dev), backend=mesh.backend, int8=int8, prompt_len=s,
                  counts=counts, held=held, comm=comm, ring_ms=sorted(runs)[1], ring_runs_ms=runs,
                  one_process_ms=sorted(one_runs)[1], plain=plain, kernel_c=kernel_c, cache_tol=cache_tol,
                  peak_gb=peak, finite=bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab_size))
    return every_rank(mesh, report)


def _clone(cache):
    """A copy of a KV cache (every plane)."""
    return type(cache)(**{n: t.clone() for n, t in cache.planes().items()})


def train_rank(mesh, path, batch, num_layers: int, b_seed: int, steps: int = 3, accum_steps: int = 1,
               label: str = "train") -> list:
    """On one rank of a dp x tp mesh: QLoRA training of the first
    ``num_layers`` layers of the packed checkpoint at ``path`` (its slice;
    bf16, rank 16, AdamW, remat) over the mesh: the adapters of
    ``init_lora`` (seed 0) with B drawn from ``b_seed`` on the host (the
    same on every rank and in the caller), the rank's slice of them;
    ``steps`` steps of ``make_train_step(mesh=, accum_steps=)`` on
    ``batch`` (tokens, loss mask, positions, segment ids, numpy) with every
    launch count set to 0 before each step and read after; step 0's
    adapter gradients gathered whole; one more step with every kernel call
    held to its plain version.  Returns every rank's report, rank 0's with
    the gradients."""
    from ..train import LoraConfig, make_train_step
    from ..train.lora import gather_lora, shard_lora

    dev = mesh.device
    params, cfg = load_packed_sharded(path, mesh)
    params = dataclasses.replace(params, layers=params.layers[:num_layers])
    cfg = dataclasses.replace(cfg, num_layers=num_layers)
    lora = shard_lora(seeded_lora(cfg, LoraConfig(rank=16, alpha=32.0), b_seed, dev), cfg, mesh)
    opt = torch.optim.AdamW(lora.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(cfg, opt, remat=True, mesh=mesh, accum_steps=accum_steps)
    tok, mask, pos, seg = (torch.as_tensor(a, device=dev) for a in batch)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, secs, counts, grads = [], [], [], None
    for i in range(steps):
        _cuda.reset_launch_counts()
        t0 = _sync(dev)
        losses.append(float(step(params, lora, tok, mask, pos, seg)))
        secs.append(_sync(dev) - t0)
        counts.append(_cuda.launch_counts())
        if i == 0:
            carrier = shard_lora(seeded_lora(cfg, LoraConfig(rank=16, alpha=32.0), b_seed, dev), cfg, mesh)
            for (_, c), (_, p) in zip(carrier.named_parameters(), lora.named_parameters()):
                c.data = p.grad.detach().clone()
            whole = gather_lora(carrier, mesh)
            grads = {n: p.detach().float().cpu().numpy() for n, p in whole.named_parameters()}
    with kernels_held_to_plain(f"{label} rank {mesh.rank}", report=False) as held:
        step(params, lora, tok, mask, pos, seg)
    report = dict(rank=mesh.rank, tp=mesh.tp, dp=mesh.dp, device=str(dev), backend=mesh.backend, losses=losses,
                  step_ms=[v * 1e3 for v in secs], counts=counts, held=held, peak_gb=_peak_gb(dev),
                  local_heads=cfg.num_heads // mesh.tp if cfg.tp_shards > 1 else cfg.num_heads)
    every = every_rank(mesh, report)
    every[0]["grads"] = grads if mesh.rank == 0 else None
    return every


def seeded_lora(cfg, lcfg, b_seed: int, device):
    """``init_lora`` (seed 0) with every B drawn from ``b_seed`` (normal,
    std 0.01, on the host, so every rank and a one-process run draw the
    same), so every A has a gradient too."""
    from ..train import init_lora

    lora = init_lora(cfg, lcfg, seed=0, device=device)
    gen = torch.Generator().manual_seed(b_seed)
    for name, p in lora.named_parameters():
        if name.endswith(".b"):
            p.data = (torch.randn(tuple(p.shape), generator=gen) * 0.01).to(device)
    return lora
