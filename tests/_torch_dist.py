"""Rank bodies for the port's tensor-parallel tests, run on the ranks of
``nf4_tpu_torch.parallel.launch.Ranks`` (gloo over the CPU).  Imports no
JAX: a rank imports this module to find the function it runs.  Each body
builds the model from its seed (``init_params`` is the same bits on every
rank), so no weights travel, and returns numpy arrays; what every rank
holds comes back from rank 0 through ``all_gather_object``."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from nf4_tpu_torch.models.llama import init_params, recode_params_int8
from nf4_tpu_torch.parallel.drive import every_rank
from nf4_tpu_torch.parallel.tp import localize_params, tp_decode_step, tp_prefill

CPU = torch.device("cpu")
# The most seconds a test's Ranks.run may take: a run is a few seconds, so
# ranks whose collectives do not meet fail the test fast instead of after
# the launcher's default.
RUN_TIMEOUT_S = 120


def gathered(mesh, value) -> list:
    """``value`` of every rank of the mesh's tensor-parallel group, in rank
    order (on each rank)."""
    out = [None] * mesh.tp
    dist.all_gather_object(out, value, group=mesh.tp_group)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def model(cfg, seed: int, int8: bool = False):
    """The whole model of ``cfg`` from ``seed`` on the CPU (int8-recoded
    with ``int8``)."""
    params = init_params(cfg, seed, device=CPU)
    return recode_params_int8(params) if int8 else params


def prefill_decode(mesh, cfg, seed, tokens, tok, pos, int8=False, env=None):
    """``tp_prefill`` of ``tokens`` [B, S], then ``tp_decode_step`` of
    ``tok`` at ``pos``, over the rank's slice; returns (prefill logits,
    decode logits, every rank's cache K and V planes), the logits as rank 0
    has them, and whether every rank's logits are the same bits.  ``env``
    sets environment variables for the call (``NF4TPU_COLLECTIVE_MATMUL``)."""
    old = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        params = localize_params(model(cfg, seed, int8), cfg, mesh.tp, mesh.tp_rank)
        logits, cache = tp_prefill(params, cfg, mesh, torch.as_tensor(tokens, dtype=torch.int32))
        dec, cache = tp_decode_step(params, cfg, mesh, torch.as_tensor(tok, dtype=torch.int32), cache,
                                    torch.as_tensor(pos, dtype=torch.int32), kv_len=cfg.max_seq_len)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    planes = {name: _np(t) for name, t in cache.planes().items()}
    every = gathered(mesh, (_np(logits), _np(dec), planes))
    same = all(np.array_equal(e[0], every[0][0]) and np.array_equal(e[1], every[0][1]) for e in every)
    return every[0][0], every[0][1], [e[2] for e in every], same, dict(mesh.stats)


def generate(mesh, cfg, seed, prompts, max_new_tokens, int8=False, engine_kw=None, gen_kw=None, local=False):
    """``Engine(mesh=)`` greedy ``generate`` on every rank (from the whole
    params, or with ``local`` from the rank's slice); returns every rank's
    tokens and the Engine's stats."""
    from nf4_tpu_torch.serve.engine import Engine

    params = model(cfg, seed, int8)
    if local:
        params = localize_params(params, cfg, mesh.tp, mesh.tp_rank)
    eng = Engine(params, cfg, batch_size=2, eos_token=-1, device=CPU, cuda_graphs=False, mesh=mesh,
                 **(engine_kw or {}))
    out = eng.generate(prompts, max_new_tokens=max_new_tokens, **(gen_kw or {}))
    stats = dict(spec=dict(eng.spec_stats), prefix=dict(eng.prefix_stats), comm=dict(mesh.stats))
    return gathered(mesh, [r.tokens for r in out]), stats


def load_serve(mesh, path, prompts, max_new_tokens):
    """``load_packed_sharded`` of ``path`` on the rank, then ``Engine(mesh=)``
    on the slice: every rank's tokens."""
    from nf4_tpu_torch.models.loader import load_packed_sharded
    from nf4_tpu_torch.serve.engine import Engine

    params, cfg = load_packed_sharded(path, mesh, device=CPU)
    eng = Engine(params, cfg, batch_size=2, eos_token=-1, device=CPU, cuda_graphs=False, mesh=mesh)
    return gathered(mesh, [r.tokens for r in eng.generate(prompts, max_new_tokens=max_new_tokens)])


# --- data parallelism, training over a mesh, sequence parallelism -----------


def generate_mesh(mesh, cfg, seed, prompts, max_new_tokens, int8=False, batch_size=4, engine_kw=None,
                  gen_kw=None):
    """``Engine(mesh=)`` ``generate`` over a dp x tp mesh; returns every
    rank's (tokens, the rows its cache holds and their K plane, the
    Engine's stats)."""
    from nf4_tpu_torch.serve.engine import Engine

    eng = Engine(model(cfg, seed, int8), cfg, batch_size=batch_size, eos_token=-1, device=CPU, cuda_graphs=False,
                 mesh=mesh, **(engine_kw or {}))
    out = eng.generate(prompts, max_new_tokens=max_new_tokens, **(gen_kw or {}))
    cache, _ = eng.state()
    rows = (0, batch_size) if eng.rows is None else eng.rows[:2]
    stats = dict(spec=dict(eng.spec_stats), prefix=dict(eng.prefix_stats), comm=dict(mesh.stats))
    return every_rank(mesh, ([r.tokens for r in out], rows, _np(cache.k), stats))


def tp_model(cfg, seed, tp_shards, dtype=None):
    """The whole model of ``cfg`` (its dtype, or ``dtype``) from ``seed``,
    packed for ``tp_shards`` (``repack_tp`` of the tp_shards = 1 pack, bit
    for bit the JAX package's); returns (params, cfg)."""
    import dataclasses

    from nf4_tpu_torch.parallel.tp import repack_tp

    base = dataclasses.replace(cfg, tp_shards=1, **({} if dtype is None else dict(dtype=dtype)))
    return repack_tp(init_params(base, seed, device=CPU), base, tp_shards)


def adapters(cfg, rank, alpha, b_seed=None, b_scale=0.05):
    """``init_lora`` (seed 0) of ``cfg``, with B drawn from ``b_seed`` by
    numpy when given (so A gets a gradient), as numpy arrays by parameter
    name when ``b_seed`` is given; the LoraParams."""
    from nf4_tpu_torch.train import LoraConfig, init_lora

    lora = init_lora(cfg, LoraConfig(rank=rank, alpha=alpha), seed=0, device=CPU)
    if b_seed is not None:
        rng = np.random.default_rng(b_seed)
        for name, p in lora.named_parameters():
            if name.endswith(".b"):
                p.data = torch.from_numpy((rng.standard_normal(tuple(p.shape)) * b_scale).astype(np.float32))
    return lora


def train_steps(mesh, cfg, seed, tokens, steps=1, opt="sgd", lr=1.0, accum_steps=1, remat=False, loss_mask=None,
                rank=4, alpha=8.0, b_seed=None, tp_shards=None, dtype=None):
    """``steps`` of ``make_train_step`` on the model of ``cfg`` packed for
    ``tp_shards`` (default the mesh's tp), over ``mesh`` (None: one process)
    from the same adapters on every rank (their slices under tp); returns
    (the losses, every adapter's first update (before - after, gathered
    whole) by parameter name, the whole adapters after the last step)."""
    from nf4_tpu_torch.train import make_train_step
    from nf4_tpu_torch.train.lora import gather_lora, shard_lora

    params, tcfg = tp_model(cfg, seed, tp_shards or (1 if mesh is None else mesh.tp), dtype)
    lora = adapters(tcfg, rank, alpha, b_seed)
    if mesh is not None:
        lora = shard_lora(lora, tcfg, mesh)
    if opt == "sgd":
        optimizer = torch.optim.SGD(lora.parameters(), lr=lr)
    else:
        optimizer = torch.optim.AdamW(lora.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(tcfg, optimizer, remat=remat, mesh=mesh, accum_steps=accum_steps)
    toks = torch.as_tensor(tokens, dtype=torch.int32)
    mask = None if loss_mask is None else torch.as_tensor(loss_mask, dtype=torch.float32)
    losses, first = [], None
    for i in range(steps):
        before = {n: p.detach().clone() for n, p in lora.named_parameters()}
        losses.append(float(step(params, lora, toks, mask)))
        if i == 0:
            first = {n: before[n] - p.detach() for n, p in lora.named_parameters()}
    whole = lora if mesh is None else gather_lora(lora, mesh)
    if mesh is not None:
        upd = shard_lora(whole, tcfg, mesh)  # the same structure, to carry the update
        for n, p in upd.named_parameters():
            p.data = first[n]
        first = {n: p.detach() for n, p in gather_lora(upd, mesh).named_parameters()}
    return losses, {n: _np(t) for n, t in first.items()}, {n: _np(p) for n, p in whole.named_parameters()}


def train_merge_serve(mesh, cfg, seed, tokens, prompts, max_new_tokens):
    """Two SGD steps at the mesh's tp, the adapters gathered whole and merged
    into the rank's copy of the whole checkpoint (``merge_lora``, oracle
    quantizer), the merged model served over the mesh; returns (every
    rank's tokens, the merged weights' shard counts)."""
    from nf4_tpu_torch.serve.engine import Engine
    from nf4_tpu_torch.train import make_train_step, merge_lora
    from nf4_tpu_torch.train.lora import gather_lora, shard_lora

    params, tcfg = tp_model(cfg, seed, mesh.tp)
    lora = shard_lora(adapters(tcfg, 4, 8.0, b_seed=5), tcfg, mesh)
    step = make_train_step(tcfg, torch.optim.SGD(lora.parameters(), lr=1.0), mesh=mesh)
    for _ in range(2):
        step(params, lora, torch.as_tensor(tokens, dtype=torch.int32))
    merged = merge_lora(params, gather_lora(lora, mesh), tcfg, method="oracle")
    shards = {name: getattr(merged.layers[0], name).shards for name in ("wqkv", "wo", "w_gateup", "w_down")}
    eng = Engine(merged, tcfg, batch_size=2, eos_token=-1, device=CPU, cuda_graphs=False, mesh=mesh)
    toks = [r.tokens for r in eng.generate(prompts, max_new_tokens=max_new_tokens)]
    return every_rank(mesh, toks), shards, {n: _np(p) for n, p in gather_lora(lora, mesh).named_parameters()}


def sp_prefill_rank(mesh, cfg, seed, tokens, seq_lens=None, decode_tokens=None):
    """``sp_prefill`` of ``tokens`` over the ring of the mesh's dp axis, then
    a decode step of each row of ``decode_tokens`` [steps, B] (teacher
    forced) on the whole cache it returns; returns (logits, the cache's
    planes, seq_lens, the decode steps' logits) as rank 0 has them, and
    whether every rank's are the same bits."""
    from nf4_tpu_torch.models.llama import decode_step
    from nf4_tpu_torch.parallel.sp import ring_of, sp_prefill

    params = init_params(cfg, seed, device=CPU)
    lens = None if seq_lens is None else torch.as_tensor(seq_lens, dtype=torch.int32)
    logits, cache, out_lens = sp_prefill(params, cfg, torch.as_tensor(tokens, dtype=torch.int32), ring_of(mesh), lens)
    steps, pos = [], out_lens.clone()
    for tok in [] if decode_tokens is None else decode_tokens:
        lg, cache = decode_step(params, cfg, torch.as_tensor(tok, dtype=torch.int32), cache, pos)
        steps.append(_np(lg))
        pos = pos + 1
    planes = {name: t.numpy() if t.dtype == torch.int8 else _np(t) for name, t in cache.planes().items()}
    mine = (_np(logits), planes, out_lens.numpy(), np.asarray(steps))
    every = every_rank(mesh, mine)
    same = all(np.array_equal(e[0], mine[0]) and all(np.array_equal(e[1][k], mine[1][k]) for k in mine[1])
               for e in every)
    return every[0], same
