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
from nf4_tpu_torch.parallel.tp import localize_params, tp_decode_step, tp_prefill

CPU = torch.device("cpu")


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
