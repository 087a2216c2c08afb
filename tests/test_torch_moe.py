"""The mixture-of-experts MLP and the dense projections (``quantize=False``)
in the port against nf4_tpu.

Why the model-level MoE cases run in fp32 activations (``dtype=float32``):
a token's route is a discrete choice among router logits, and in bf16 the
two packages' activations differ by a rounding here and there (the port's
4-bit projections also round each weight to bf16), so a token whose k-th
and (k+1)-th router logits are within that noise takes another expert in
one package than in the other, and its logits then differ by O(1). In fp32
the two forwards agree to ~1e-5 and every route is the same.  The bf16 MoE
path is held at module level instead: ``_moe_mlp`` of both packages on the
same bf16 input and weights (4-bit, int8 and dense), where the router's
fp32 logits agree to fp32 rounding, within 2e-2 of the largest output.

Every model is built by ``nf4_tpu.models.llama.init_params`` from a seed
with its norms redrawn (``init_params`` draws ones, which would hide an
ignored field); its routers are ``init_params``'s, normal with std
hidden^-0.5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_variants import LOGIT_TOL, PROMPT, _check_greedy, _prefill_and_decode, _redraw

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models import loader as jloader
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models import configs, llama, loader
from nf4_tpu_torch.models.convert import _tensor, config_from_dict, params_from_numpy
from nf4_tpu_torch.ops.int8_serve import PackedInt8
from nf4_tpu_torch.serve.engine import Engine

MODULE_TOL = 2e-2

# A tiny Qwen3-MoE: 16 experts, top-8 renormalized, q/k head norms, an
# expert width whose K pads (192 -> 1024).
TINY_QWEN3_MOE = dataclasses.replace(jconfigs.TINY_MOE, num_experts=16, experts_per_token=8, intermediate_size=192,
                                     qk_norm=True, rms_norm_eps=1e-6)
MOE_CONFIGS = {
    "tiny-moe": jconfigs.TINY_MOE,
    "tiny-moe, moe_norm_topk=False": dataclasses.replace(jconfigs.TINY_MOE, moe_norm_topk=False),
    "tiny qwen3-moe": TINY_QWEN3_MOE,
}


def _models(cfg, seed=0):
    params = _redraw(jllama.init_params(cfg, seed=seed), cfg, np.random.default_rng(seed + 100))
    tcfg = config_from_dict(config_to_dict(cfg))
    return cfg, params, tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype=jnp.float32)


@pytest.mark.parametrize("name", list(MOE_CONFIGS))
def test_moe_prefill_and_decode_match_jax(name):
    """Prefill and 4 greedy decode steps in fp32 activations (module
    docstring) against the JAX model."""
    cfg, params, tcfg, tparams = _models(_fp32(MOE_CONFIGS[name]))
    assert tparams.layers[0].w_gateup.packed.shape[0] == cfg.num_experts
    prefill, tokens, decode, want = _prefill_and_decode(cfg, params, tcfg, tparams, seed=1)
    np.testing.assert_allclose(prefill, want[:, :PROMPT], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(decode, want[:, PROMPT:], atol=LOGIT_TOL, rtol=0)
    _check_greedy(tokens, want[:, PROMPT - 1:])


def test_moe_norm_topk_matters():
    """The same weights with the other ``moe_norm_topk`` miss the JAX
    logits by more than LOGIT_TOL; a port that ignored the router (one
    expert's weights for every token) would too."""
    cfg, params, tcfg, tparams = _models(_fp32(jconfigs.TINY_MOE), seed=3)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(jllama.prefill(params, cfg, jnp.asarray(toks))[0])
    got, _ = llama.prefill(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)
    other, _ = llama.prefill(tparams, dataclasses.replace(tcfg, moe_norm_topk=False), torch.from_numpy(toks))
    assert np.abs(other.numpy() - want).max() > LOGIT_TOL
    flat = dataclasses.replace(tparams, layers=[
        dataclasses.replace(lp, router=torch.zeros_like(lp.router)) for lp in tparams.layers])
    miss, _ = llama.prefill(flat, tcfg, torch.from_numpy(toks))
    assert np.abs(miss.numpy() - want).max() > LOGIT_TOL


def _layer0(jparams):
    return jax.tree.map(lambda a: a[0] if hasattr(a, "ndim") else a, jparams.layers, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("mode", ["4-bit", "int8", "dense"])
@pytest.mark.parametrize("name", list(MOE_CONFIGS))
def test_moe_mlp_matches_jax_in_bf16(name, mode):
    """``_moe_mlp`` of both packages on the same bf16 input (2 x 50 tokens)
    and the same layer weights: the port's routes (a stable descending
    sort) equal ``lax.top_k``'s, and the outputs agree within 2e-2 of the
    largest."""
    cfg = MOE_CONFIGS[name]
    if mode == "dense":
        cfg = dataclasses.replace(cfg, quantize=False)
    cfg, params, tcfg, tparams = _models(cfg, seed=4)
    if mode == "int8":
        params, tparams = jllama.recode_params_int8(params), llama.recode_params_int8(tparams)
        assert isinstance(tparams.layers[0].w_down, PackedInt8)
    lp, tlp = _layer0(params), tparams.layers[0]
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 50, cfg.hidden_size)), jnp.bfloat16)
    want = np.asarray(jllama._moe_mlp(cfg, x, lp, jax.nn.silu, lambda t: t), np.float32)
    got = llama._moe_mlp(tcfg, _tensor(x, "cpu"), tlp).numpy()
    assert np.abs(got - want).max() <= MODULE_TOL * np.abs(want).max()
    logits = jnp.dot(x.astype(jnp.float32), lp.router.T, precision=jax.lax.Precision.HIGHEST)
    want_routes = np.asarray(jax.lax.top_k(logits, cfg.experts_per_token)[1])
    order = torch.sort(torch.tensor(np.asarray(logits)), dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(order.indices[..., : cfg.experts_per_token].numpy(), want_routes)


def test_moe_routes_break_ties_to_the_lower_index():
    """Router rows 0 = 2 and 1 = 3: every token's logits tie in pairs, and
    the port picks both experts of the leading pair, the lower first, as
    ``lax.top_k`` does (its output then matches the JAX ``_moe_mlp`` on the
    same weights)."""
    cfg, params, tcfg, tparams = _models(jconfigs.TINY_MOE, seed=6)
    r = np.array(params.layers.router)
    r[:, 2], r[:, 3] = r[:, 0], r[:, 1]
    params = params.replace(layers=params.layers.replace(router=jnp.asarray(r)))
    tlp = dataclasses.replace(tparams.layers[0], router=torch.from_numpy(r[0].copy()))
    x = jnp.asarray(np.random.default_rng(7).standard_normal((1, 30, cfg.hidden_size)), jnp.bfloat16)
    want = np.asarray(jllama._moe_mlp(cfg, x, _layer0(params), jax.nn.silu, lambda t: t), np.float32)
    got = llama._moe_mlp(tcfg, _tensor(x, "cpu"), tlp).numpy()
    assert np.abs(got - want).max() <= MODULE_TOL * np.abs(want).max()
    logits = torch.from_numpy(np.asarray(x, np.float32)) @ torch.from_numpy(r[0]).t()
    picks = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :2].numpy()
    np.testing.assert_array_equal(picks, np.asarray(jax.lax.top_k(jnp.asarray(logits.numpy()), 2)[1]))
    assert {tuple(p) for p in picks[0]} <= {(0, 2), (1, 3)}


def test_moe_int8_mode_matches_jax():
    """MoE in the int8 mode: ``recode_params_int8`` recodes every expert,
    byte-identical to nf4_tpu's recode; an int8 KV cache; prefill and
    decode logits in fp32 activations against the JAX model."""
    cfg, params, tcfg, tparams = _models(_fp32(dataclasses.replace(jconfigs.TINY_MOE, kv_quant=True)))
    p8, t8 = jllama.recode_params_int8(params), llama.recode_params_int8(tparams)
    for i, lp in enumerate(t8.layers):
        for name in ("w_gateup", "w_down"):
            w, jw = getattr(lp, name), getattr(p8.layers, name)
            assert w.values.shape[0] == cfg.num_experts
            np.testing.assert_array_equal(w.values.numpy(), np.asarray(jw.values[i]))
            np.testing.assert_array_equal(w.scales.numpy().view(np.uint32), np.asarray(jw.scales[i]).view(np.uint32))
    prefill, tokens, decode, want = _prefill_and_decode(cfg, p8, tcfg, t8, seed=3)
    np.testing.assert_allclose(prefill, want[:, :PROMPT], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(decode, want[:, PROMPT:], atol=LOGIT_TOL, rtol=0)
    _check_greedy(tokens, want[:, PROMPT - 1:])


@pytest.mark.parametrize("name", ["tiny-test", "tiny-gemma2"])
def test_dense_projections_match_jax(name):
    """``quantize=False``: dense bf16 projections, products with fp32
    accumulation, against the JAX model's ``jnp.dot`` path."""
    cfg = dataclasses.replace(jconfigs.get_config(name), quantize=False)
    cfg, params, tcfg, tparams = _models(cfg)
    assert tparams.layers[0].wqkv.dtype == torch.bfloat16
    prefill, tokens, decode, want = _prefill_and_decode(cfg, params, tcfg, tparams, seed=1)
    np.testing.assert_allclose(prefill, want[:, :PROMPT], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(decode, want[:, PROMPT:], atol=LOGIT_TOL, rtol=0)
    _check_greedy(tokens, want[:, PROMPT - 1:])


def test_moe_prefill_chunked_matches_jax():
    cfg, params, tcfg, tparams = _models(_fp32(jconfigs.TINY_MOE), seed=5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _ = jllama.prefill_chunked(params, cfg, jnp.asarray(toks), chunk=16)
    got, _ = llama.prefill_chunked(tparams, tcfg, torch.from_numpy(toks), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


def test_moe_engine_matches_jax_engine():
    """Greedy tokens of the port's Engine and the JAX Engine for tiny-moe
    (fp32 activations, module docstring): six prompts through two slots,
    decode chunks of 4, under the near-tie rule of ``test_torch_engine.py``."""
    from test_torch_engine import _agree_until_near_tie, _teacher_forced

    cfg, params, tcfg, tparams = _models(_fp32(jconfigs.TINY_MOE))
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(3, 256, size=n))) for n in (3, 30, 9, 20, 1, 12)]
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4).generate(prompts, max_new_tokens=8)
    got = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu").generate(
        prompts, max_new_tokens=8)
    for g, w in zip(got, want):
        assert len(g.tokens) == 8
        _teacher_forced(cfg, params, g, {-1})
        _agree_until_near_tie(cfg, params, g, w)


@pytest.mark.parametrize("ext", ["npz", "safetensors"])
def test_moe_checkpoint_round_trip(tmp_path, ext):
    """An MoE checkpoint (expert-stacked ``[L, E, ...]`` packed leaves, the
    router) saved by nf4_tpu and loaded by the port, and the port's saved
    and loaded by nf4_tpu: identical leaves both ways."""
    cfg, params, tcfg, tparams = _models(TINY_QWEN3_MOE, seed=8)
    path = str(tmp_path / f"moe.{ext}")
    jloader.save_packed(path, params, cfg)
    got, got_cfg = loader.load_packed_auto(path, device="cpu")
    assert got_cfg == tcfg
    for i, lp in enumerate(got.layers):
        for name in ("w_gateup", "w_down"):
            w, jw = getattr(lp, name), getattr(params.layers, name)
            assert w.shape == tuple(jw.shape) and w.packed.shape == jw.packed.shape[1:]
            np.testing.assert_array_equal(w.packed.numpy(), np.asarray(jw.packed[i]))
            np.testing.assert_array_equal(w.scales.numpy(), np.asarray(jw.scales[i]))
        np.testing.assert_array_equal(lp.router.numpy(), np.asarray(params.layers.router[i]))
    back = str(tmp_path / f"back.{ext}")
    loader.save_packed(back, got, got_cfg)
    jp, jcfg = jloader.load_packed_auto(back)
    assert jcfg == cfg
    for name in ("w_gateup", "w_down", "wqkv"):
        for leaf in ("packed", "scales"):
            np.testing.assert_array_equal(np.asarray(getattr(getattr(jp.layers, name), leaf)),
                                          np.asarray(getattr(getattr(params.layers, name), leaf)))
    for name in ("router", "q_norm", "k_norm"):
        np.testing.assert_array_equal(np.asarray(getattr(jp.layers, name)), np.asarray(getattr(params.layers, name)))


def test_dense_checkpoint_round_trip(tmp_path):
    """Dense projections (``quantize=False``) and a dense expert stack
    through a checkpoint, both ways, bit for bit."""
    cfg, params, tcfg, tparams = _models(dataclasses.replace(jconfigs.TINY_MOE, quantize=False), seed=9)
    path = str(tmp_path / "dense.npz")
    jloader.save_packed(path, params, cfg)
    got, _ = loader.load_packed_auto(path, device="cpu")
    for i, lp in enumerate(got.layers):
        for name in ("wqkv", "w_gateup"):
            want = np.asarray(getattr(params.layers, name)[i])
            np.testing.assert_array_equal(getattr(lp, name).view(torch.int16).numpy(), want.view(np.int16))
    back = str(tmp_path / "back.npz")
    loader.save_packed(back, got, tcfg)
    jp, _ = jloader.load_packed_auto(back)
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        np.testing.assert_array_equal(np.asarray(getattr(jp.layers, name)).view(np.int16),
                                      np.asarray(getattr(params.layers, name)).view(np.int16))


def test_registry_holds_the_new_configs():
    """The six configurations and Phi-3-mini, field for field."""
    for name in ("tiny-gemma2", "gemma2-9b", "gemma3-4b", "tiny-moe", "mixtral-8x7b", "qwen3-30b-a3b", "phi3-mini"):
        assert configs.get_config(name) == config_from_dict(config_to_dict(jconfigs.get_config(name))), name


def test_synthetic_params_draw_experts_router_and_norms():
    """Expert-stacked packed weights, a router, output norms and a final
    norm from the seed; dense projections with ``quantize=False``."""
    from nf4_tpu_torch.models.synthetic import synthetic_params

    cfg = configs.TINY_MOE
    a, b = synthetic_params(cfg, seed=5, device="cpu"), synthetic_params(cfg, seed=5, device="cpu")
    lp = a.layers[0]
    assert lp.w_gateup.packed.shape == (4, 512, 512) and lp.w_down.scales.shape == (4, 16, 128)
    assert lp.router.shape == (4, 128) and lp.router.dtype == torch.float32
    assert torch.equal(lp.router, b.layers[0].router) and lp.post_ffw_norm is None
    assert not torch.equal(a.final_norm, torch.ones_like(a.final_norm))
    g = synthetic_params(configs.TINY_GEMMA2, seed=5, device="cpu").layers[0]
    assert g.post_attn_out_norm.shape == (128,) and not torch.equal(g.post_attn_out_norm, g.post_ffw_norm)
    d = synthetic_params(dataclasses.replace(cfg, quantize=False), seed=5, device="cpu").layers[0]
    assert d.w_gateup.shape == (4, 512, 128) and d.w_gateup.dtype == torch.bfloat16
    logits, _ = llama.prefill(a, cfg, torch.zeros((1, 8), dtype=torch.int32))
    assert bool(torch.isfinite(logits).all())


def test_training_moe_and_dense_raise():
    from nf4_tpu_torch.train import make_train_step

    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    for cfg in (configs.TINY_MOE, dataclasses.replace(configs.TINY_TEST, quantize=False)):
        with pytest.raises(NotImplementedError, match="not ported yet: training with"):
            make_train_step(cfg, opt)
