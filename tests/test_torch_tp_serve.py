"""``Engine(mesh=)``: tensor-parallel serving over gloo ranks on the CPU
(one group of 4 for the module; tp = 2 on ranks 0 and 1).  Greedy tokens
are the same on every rank and agree with the JAX package's Engine on the
same weights under the near-tie rule; prompt-lookup speculation
(``spec_k=3``) and the prefix cache give the plain Engine's tokens over
the mesh too; what the JAX Engine refuses over a mesh, the port refuses
(a data-parallel axis serves: ``tests/test_torch_dp_serve.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models import configs, llama
from nf4_tpu_torch.parallel.launch import Ranks
from nf4_tpu_torch.parallel.mesh import Mesh
from nf4_tpu_torch.serve.engine import Engine
from _torch_threads import _one_thread  # noqa: F401

PROMPTS = [[3, 5, 7], [11, 13], [1, 2, 3, 4, 5, 6, 7, 8, 9], [200, 100, 50, 25]]
NEW = 6
LOGIT_TOL = 2e-2


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, backend="gloo", device="cpu", threads=1) as r:
        yield r


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX Engine's greedy tokens on TINY_TP (tp_shards = 4) and its
    params, one device."""
    params = jllama.init_params(jconfigs.TINY_TP, seed=0)
    out = JaxEngine(params, jconfigs.TINY_TP, batch_size=2, eos_token=-1).generate(PROMPTS, max_new_tokens=NEW)
    return params, [r.tokens for r in out]


def _agree_until_near_tie(params, got, want):
    """Each request's tokens equal the JAX Engine's, or first differ where
    the JAX logits' top-2 gap after the common tokens is at most LOGIT_TOL."""
    for prompt, g, w in zip(PROMPTS, got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                seq = jnp.asarray([list(prompt) + list(w[:i])], jnp.int32)
                row = np.asarray(jllama.prefill(params, jconfigs.TINY_TP, seq)[0], np.float32)[0, -1]
                top2 = np.sort(row)[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL, "diverged where the JAX Engine's choice was clear"
                break
        else:
            assert len(g) == len(w) == NEW


@pytest.mark.parametrize("tp_deg", [2, 4])
def test_engine_over_mesh_matches_jax_engine(ranks, jax_tokens, tp_deg):
    """tp = 4 serves TINY_TP's pack; tp = 2 the same weights packed for 2
    (the JAX Engine's are held on TINY_TP's, the same dense draws)."""
    params, want = jax_tokens
    cfg = dataclasses.replace(configs.TINY_TP, tp_shards=tp_deg)
    every, stats = ranks.run(td.generate, cfg, 0, PROMPTS, NEW, tp=tp_deg)
    assert all(toks == every[0] for toks in every), "ranks sampled different tokens"
    _agree_until_near_tie(params, every[0], want)
    assert stats["comm"]["calls"] > 0


def test_engine_over_mesh_from_the_rank_slice(ranks):
    """Params already localized (as ``load_packed_sharded`` gives them) serve
    as the whole model's do."""
    whole, _ = ranks.run(td.generate, configs.TINY_TP, 0, PROMPTS[:2], NEW, tp=4)
    local, _ = ranks.run(td.generate, configs.TINY_TP, 0, PROMPTS[:2], NEW, tp=4, local=True)
    assert local == whole


@pytest.mark.parametrize("extra", [dict(spec_k=3), dict(prefix_cache=True)], ids=["spec_k3", "prefix_cache"])
def test_spec_and_prefix_cache_over_mesh(ranks, extra):
    """Greedy speculation and the prefix cache go through ``forward`` and
    give the plain tensor-parallel Engine's tokens on every rank."""
    prompts = [[9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8, 7, 6, 5, 4, 3] + p for p in PROMPTS[:3]]
    plain, _ = ranks.run(td.generate, configs.TINY_TP, 0, prompts, NEW, tp=4)
    got, stats = ranks.run(td.generate, configs.TINY_TP, 0, prompts, NEW, tp=4, engine_kw=extra)
    assert got == plain
    if "spec_k" in extra:
        assert stats["spec"]["steps"] > 0
    else:
        assert stats["prefix"]["prefix_len"] == 16


def _mesh(tp=1, dp=1):
    return Mesh(tp=tp, dp=dp, rank=0, tp_rank=0, dp_rank=0, tp_group=None, dp_group=None,
                device=torch.device("cpu"), backend="gloo")


def test_refusals():
    cfg = dataclasses.replace(configs.TINY_TP, tp_shards=1, num_layers=1)
    params = llama.init_params(cfg, 0, device="cpu")
    kw = dict(batch_size=2, eos_token=-1, device="cpu", cuda_graphs=False)
    with pytest.raises(ValueError, match="must be a multiple of the data-parallel degree"):
        Engine(params, cfg, mesh=_mesh(dp=4), **kw)  # 2 slots over dp = 4 (dp itself: test_torch_dp_serve.py)
    with pytest.raises(NotImplementedError, match="not ported yet: CUDA graphs over a process group"):
        Engine(params, cfg, mesh=_mesh(), **dict(kw, cuda_graphs=True))
    with pytest.raises(ValueError, match="draft-model speculation is single-device"):
        Engine(params, cfg, mesh=_mesh(), spec_k=3, draft=(params, cfg), **kw)
    from nf4_tpu_torch.train import LoraConfig, init_lora

    lora = init_lora(cfg, LoraConfig(rank=4), seed=0, device="cpu")
    with pytest.raises(ValueError, match="multi-LoRA serving is single-device"):
        Engine(params, cfg, mesh=_mesh(), lora_bank=[lora, lora], **kw)
    eng = Engine(params, cfg, mesh=_mesh(), **kw)
    with pytest.raises(ValueError, match="score\\(\\) is single-device"):
        eng.score([[1, 2, 3]])
    with pytest.raises(ValueError, match="unmerged LoRA"):
        llama.forward(params, cfg, torch.zeros((1, 2), dtype=torch.int32), llama.init_kv_cache(cfg, 1, "cpu"),
                      torch.zeros((1, 2), dtype=torch.int32), torch.full((1,), 2, dtype=torch.int32), lora=lora,
                      reduce_fn=lambda t: t)
