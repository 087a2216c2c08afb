"""A rank's body that drives tensor-parallel serving on the card and
reports what ran: the work of ``chip_smoke.py``'s tensor-parallel phase on
each rank (run there through :class:`~nf4_tpu_torch.parallel.launch.Ranks`;
a rank imports this module, never the script).  It fails on any error;
the caller holds the numbers it returns to their expected values."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.llama import init_kv_cache, recode_params_int8
from ..models.loader import load_packed_sharded
from ..ops import _cuda
from ..serve.engine import Decoder, Engine, kv_bucket
from ..utils.held import kernels_held_to_plain

__all__ = ["serve_rank"]


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
