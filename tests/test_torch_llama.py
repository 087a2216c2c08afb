"""The port's Llama forward against nf4_tpu through the weight bridge.

JAX ``init_params(TINY_TEST)`` (quantized) goes through
``params_from_numpy``; prefill and decode logits must agree within
LOGIT_TOL.  Why a tolerance and not equality: the port's bf16 projections
round every weight value to bf16 (kernel B's contract, within 2e-2) while
the JAX package's CPU path multiplies by the exact fp32 weights, and bf16
activations round at slightly different points.  Measured on this config:
max abs difference 0.06-0.09 with logit std ~1.0; the tolerance is 0.2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu_torch.models import configs, llama
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy

LOGIT_TOL = 0.2


@pytest.fixture(scope="module")
def models():
    cfg = jconfigs.TINY_TEST
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def test_config_bridge_and_registry(models):
    cfg, _, tcfg, _ = models
    assert tcfg == configs.TINY_TEST
    assert configs.get_config("llama3-8b") == config_from_dict(config_to_dict(jconfigs.LLAMA3_8B))
    assert configs.get_config("tinyllama-1.1b") == config_from_dict(config_to_dict(jconfigs.TINYLLAMA_1_1B))
    with pytest.raises(KeyError):
        configs.get_config("no-such-model")


def test_prefill_then_decode_logits_match(models):
    cfg, params, tcfg, tparams = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    lj, cj = jllama.prefill(params, cfg, jnp.asarray(toks))
    lt, ct = llama.prefill(tparams, tcfg, torch.from_numpy(toks))
    assert lt.shape == (3, 24, cfg.vocab_size) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)
    # The KV caches agree too (bf16 values of the same projections).
    np.testing.assert_allclose(
        ct.k[:, :, :, :24].float().numpy(), np.asarray(cj.k[:, :, :, :24], np.float32), atol=0.1, rtol=0.05
    )

    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    pos = np.full(3, 24, np.int32)
    for _ in range(4):
        a, cj = jllama.decode_step(params, cfg, jnp.asarray(tok), cj, jnp.asarray(pos))
        b, ct = llama.decode_step(tparams, tcfg, torch.from_numpy(tok), ct, torch.from_numpy(pos))
        assert b.shape == (3, cfg.vocab_size)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jnp.argmax(a, -1)).astype(np.int32)
        pos = pos + 1


def test_last_only_and_ragged_lengths(models):
    """``last_only`` picks each row's last valid token, as the JAX forward."""
    cfg, params, tcfg, tparams = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 9], np.int32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    want, _ = jllama.forward(
        params, cfg, jnp.asarray(toks), jllama.init_kv_cache(cfg, 2), jnp.asarray(pos),
        jnp.asarray(lens), last_only=True,
    )
    got, _ = llama.forward(
        tparams, tcfg, torch.from_numpy(toks), llama.init_kv_cache(tcfg, 2, device="cpu"),
        torch.from_numpy(pos), torch.from_numpy(lens), last_only=True,
    )
    assert got.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize(
    "field,value",
    [("quantize", False), ("kv_quant", True), ("num_experts", 4), ("attn_bias", True), ("qk_norm", True),
     ("final_logit_softcapping", 30.0), ("rope_scaling", ("linear", 2.0)), ("tp_shards", 2),
     ("rmsnorm_one_plus", True), ("activation", "gelu_tanh")],
)
def test_unported_config_fields_raise(models, field, value):
    import dataclasses

    _, _, tcfg, tparams = models
    cfg = dataclasses.replace(tcfg, **{field: value})
    toks = torch.zeros((1, 4), dtype=torch.int32)
    cache = llama.KVCache(k=torch.zeros(2, 1, 2, 64, 32, dtype=torch.bfloat16),
                          v=torch.zeros(2, 1, 2, 64, 32, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        llama.forward(tparams, cfg, toks, cache, torch.zeros((1, 4), dtype=torch.int32),
                      torch.full((1,), 4, dtype=torch.int32))
