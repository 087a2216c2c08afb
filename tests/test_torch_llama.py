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


@pytest.fixture(scope="module")
def int8_models(models):
    """The same model recoded to int8 weights, served with an int8 KV cache."""
    import dataclasses

    cfg, params, tcfg, tparams = models
    return (dataclasses.replace(cfg, kv_quant=True), jllama.recode_params_int8(params),
            dataclasses.replace(tcfg, kv_quant=True), llama.recode_params_int8(tparams))


def test_recode_params_int8_matches_jax(models, int8_models):
    """The port's recode of the bridged params is the JAX recode bridged:
    int8 values and scales identical, every projection and a packed
    lm_head recoded, a dense lm_head untouched."""
    from nf4_tpu_torch.ops.int8_serve import PackedInt8

    _, p8, tcfg, t8 = int8_models
    bridged = params_from_numpy(jax.tree.map(np.asarray, p8), tcfg, device="cpu")
    for lt, lb in zip(t8.layers, bridged.layers):
        for name in ("wqkv", "wo", "w_gateup", "w_down"):
            a, b = getattr(lt, name), getattr(lb, name)
            assert isinstance(a, PackedInt8) and isinstance(b, PackedInt8)
            assert torch.equal(a.values, b.values) and torch.equal(a.scales.view(torch.int32), b.scales.view(torch.int32))
            assert (a.shape, a.padded_shape, a.shards) == (b.shape, b.padded_shape, b.shards)
    assert torch.equal(t8.lm_head, models[3].lm_head)


def test_int8_kv_cache_layout(int8_models):
    _, _, tcfg, _ = int8_models
    cache = llama.init_kv_cache(tcfg, 3, device="cpu")
    shape = (tcfg.num_layers, 3, tcfg.num_kv_heads, tcfg.max_seq_len, tcfg.head_dim)
    assert cache.k.dtype == cache.v.dtype == torch.int8 and cache.k.shape == shape
    assert cache.k_scale.dtype == torch.float32 and cache.k_scale.shape == shape[:-1]
    assert set(cache.planes()) == {"k", "v", "k_scale", "v_scale"}
    assert cache.nbytes == 2 * np.prod(shape) + 2 * 4 * np.prod(shape[:-1])


def test_int8_kv8_prefill_then_decode_logits_match(int8_models):
    """int8 weights and an int8 KV cache, the JAX model's against the port's:
    logits within LOGIT_TOL (the reason is the 4-bit model's: the port's
    bf16 path rounds each weight to bf16, JAX's CPU path keeps fp32), and
    the int8 caches' dequantized keys close."""
    cfg, p8, tcfg, t8 = int8_models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    lj, cj = jllama.prefill(p8, cfg, jnp.asarray(toks))
    lt, ct = llama.prefill(t8, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)
    assert ct.k.dtype == torch.int8
    kj = np.asarray(cj.k[..., :24, :], np.float32) * np.asarray(cj.k_scale[..., :24, None]) / 127
    kt = ct.k[..., :24, :].float() * ct.k_scale[..., :24, None] / 127
    np.testing.assert_allclose(kt.numpy(), kj, atol=0.1, rtol=0.05)

    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    pos = np.full(3, 24, np.int32)
    for _ in range(4):
        a, cj = jllama.decode_step(p8, cfg, jnp.asarray(tok), cj, jnp.asarray(pos))
        b, ct = llama.decode_step(t8, tcfg, torch.from_numpy(tok), ct, torch.from_numpy(pos))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jnp.argmax(a, -1)).astype(np.int32)
        pos = pos + 1


def test_quantize_kv_identical(rng):
    """``_quantize_kv``: int8 values identical and absmax scales bit-identical
    to the JAX package's, an all-zero slot included."""
    t = rng.standard_normal((2, 3, 37, 64)).astype(np.float32) * 3
    t[0, 1, 5] = 0
    j8, js = jllama._quantize_kv(jnp.asarray(t, jnp.bfloat16))
    t8, ts = llama._quantize_kv(torch.from_numpy(t).to(torch.bfloat16))
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32 and ts[0, 1, 5] == 0
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def _forward_with(tcfg, tparams, **fields):
    import dataclasses

    cfg = dataclasses.replace(tcfg, **fields)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    cache = llama.KVCache(k=torch.zeros(2, 1, 2, 64, 32, dtype=torch.bfloat16),
                          v=torch.zeros(2, 1, 2, 64, 32, dtype=torch.bfloat16))
    llama.forward(tparams, cfg, toks, cache, torch.zeros((1, 4), dtype=torch.int32),
                  torch.full((1,), 4, dtype=torch.int32))


# What each config field needs beside it to act in TINY_TEST: a window for
# the alternating pattern and the local RoPE, fp32 activations for MoE (a
# route is a discrete choice that bf16 rounding noise can flip, so the two
# packages agree on every route only in fp32; tests/test_torch_moe.py).
_FIELD_COMPANIONS = {
    "num_experts": dict(dtype=jnp.float32),
    "rope_local_theta": dict(sliding_window=8, sliding_window_pattern=2),
    "sliding_window_pattern": dict(sliding_window=8),
}


@pytest.mark.parametrize(
    "field,value",
    [("quantize", False), ("num_experts", 4), ("attn_logit_softcapping", 50.0),
     ("final_logit_softcapping", 30.0), ("rope_local_theta", 10000.0), ("tp_shards", 2),
     ("sliding_window_pattern", 2)],
)
def test_unported_config_fields_raise(models, field, value):
    """Every field of the JAX package's config: ``tp_shards > 1`` (multi-GPU)
    still raises; each other one serves, its prefill logits held to
    nf4_tpu's on TINY_TEST with that field (and what it needs beside it)
    set, the norms redrawn, within LOGIT_TOL."""
    import dataclasses

    from test_torch_variants import _redraw

    _, _, tcfg, tparams = models
    if field == "tp_shards":
        with pytest.raises(NotImplementedError, match="not ported yet: tp_shards"):
            _forward_with(tcfg, tparams, **{field: value})
        return
    cfg = dataclasses.replace(jconfigs.TINY_TEST, **{field: value}, **_FIELD_COMPANIONS.get(field, {}))
    params = _redraw(jllama.init_params(cfg, seed=0), cfg, np.random.default_rng(100))
    fcfg = config_from_dict(config_to_dict(cfg))
    fparams = params_from_numpy(jax.tree.map(np.asarray, params), fcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jllama.prefill(params, cfg, jnp.asarray(toks))
    got, _ = llama.prefill(fparams, fcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("field,value", [("activation", "relu"), ("rope_scaling", ("yarn", 4.0))])
def test_unknown_config_values_raise(models, field, value):
    """An activation or a RoPE scaling the JAX package does not know either."""
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="unknown"):
        _forward_with(tcfg, tparams, **{field: value})
