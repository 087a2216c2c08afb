"""Packed checkpoints (``models/loader.py``) across the two packages.

Each package reads what the other wrote, ``.npz`` and ``.safetensors``,
with every tensor bit-identical and the config the same; a loaded
checkpoint serves in the int8/kv8 mode within the forward tolerance of
``test_torch_llama.py`` (LOGIT_TOL, for the reason given there).
Checkpoints are written by the tests themselves from seeded weights.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models import loader as jloader
from nf4_tpu_torch.models import llama, loader
from nf4_tpu_torch.models.convert import config_from_dict, config_to_dict, params_from_numpy
from nf4_tpu_torch.nf4.format import PackedNF4

LOGIT_TOL = 0.2

CONFIGS = {
    "nf4": jconfigs.TINY_TEST,
    # FP4 codes and a packed lm_head: the "quant_types" metadata and the
    # top-level ``lm_head.packed`` / ``.scales`` keys.
    "fp4-packed-head": dataclasses.replace(jconfigs.TINY_TEST, quant_type="fp4", quantize_lm_head=True),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    cfg = CONFIGS[request.param]
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(jloader.config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) if t.is_floating_point() else t


def _leaves(p) -> dict:
    """Every tensor and packed-weight field of the port's params, by name."""
    out = {"embed": p.embed, "final_norm": p.final_norm}

    def put(key, w):
        if isinstance(w, PackedNF4):
            out[f"{key}.packed"], out[f"{key}.scales"] = w.packed, w.scales
            out[f"{key}.meta"] = (w.shape, w.padded_shape, w.shards, w.quant_type, w.dtype)
        else:
            out[key] = w

    put("lm_head", p.lm_head)
    for i, lp in enumerate(p.layers):
        for f in dataclasses.fields(lp):
            put(f"layers.{i}.{f.name}", getattr(lp, f.name))
    return out


def _assert_same(got, want):
    a, b = _leaves(got), _leaves(want)
    assert sorted(a) == sorted(b)
    for key in a:
        if key.endswith(".meta") or a[key] is None:
            assert a[key] == b[key], key
        else:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            assert torch.equal(_bits(a[key]), _bits(b[key])), key


def _ext(fmt):
    if fmt == "safetensors":
        pytest.importorskip("safetensors")
    return f"ckpt.{fmt}"


def test_round_trip_in_the_port(models, tmp_path):
    _, _, tcfg, tparams = models
    path = str(tmp_path / "ckpt.npz")
    loader.save_packed(path, tparams, tcfg)
    got, cfg = loader.load_packed_auto(path, device="cpu")
    assert cfg == tcfg
    _assert_same(got, tparams)
    _assert_same(loader.load_packed(path, tcfg, device="cpu"), tparams)


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_port_writes_jax_reads(models, tmp_path, fmt):
    cfg, _, tcfg, tparams = models
    path = str(tmp_path / _ext(fmt))
    loader.save_packed(path, tparams, tcfg)
    jparams, jcfg = jloader.load_packed_auto(path)
    assert jcfg == cfg
    _assert_same(params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu"), tparams)


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_jax_writes_port_reads(models, tmp_path, fmt):
    cfg, params, tcfg, tparams = models
    path = str(tmp_path / _ext(fmt))
    jloader.save_packed(path, params, cfg)
    got, gcfg = loader.load_packed_auto(path, device="cpu", max_seq_len=48)
    assert gcfg == dataclasses.replace(tcfg, max_seq_len=48)
    _assert_same(got, tparams)


def test_loaded_checkpoint_serves_int8_kv8(models, tmp_path):
    """A JAX-written checkpoint, loaded with ``kv_quant=True`` and recoded to
    int8, against the JAX package doing the same."""
    _, params, _, _ = models
    cfg = models[0]
    path = str(tmp_path / "ckpt.npz")
    jloader.save_packed(path, params, cfg)
    jp, jcfg = jloader.load_packed_auto(path, kv_quant=True)
    tp, tcfg = loader.load_packed_auto(path, device="cpu", kv_quant=True)
    assert tcfg.kv_quant and jcfg.kv_quant
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jllama.prefill(jllama.recode_params_int8(jp), jcfg, jnp.asarray(toks))
    got, cache = llama.prefill(llama.recode_params_int8(tp), tcfg, torch.from_numpy(toks))
    assert cache.k.dtype == torch.int8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


def test_unported_layer_fields_raise(tmp_path):
    """The layer fields of MoE and Gemma-2 (``router``, expert-stacked
    ``[L, E, ...]`` projections, ``post_attn_out_norm``, ``post_ffw_norm``)
    load: a JAX-written checkpoint with all of them, read by the port and
    written back, gives nf4_tpu the same leaves, bit for bit."""
    cfg = dataclasses.replace(jconfigs.TINY_TEST, num_experts=4, sliding_window=8, sliding_window_pattern=2)
    params = jllama.init_params(cfg, seed=0)
    assert params.layers.router is not None and params.layers.post_ffw_norm is not None
    path, back = str(tmp_path / "moe.npz"), str(tmp_path / "back.npz")
    jloader.save_packed(path, params, cfg)
    got, tcfg = loader.load_packed_auto(path, device="cpu")
    assert got.layers[0].w_gateup.packed.shape[0] == 4 and got.layers[1].router.shape == (4, cfg.hidden_size)
    loader.save_packed(back, got, tcfg)
    jp, jcfg = jloader.load_packed_auto(back)
    assert jcfg == cfg
    want, have = jax.tree.leaves(params), jax.tree.leaves(jp)
    assert len(want) == len(have)
    for a, b in zip(want, have):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_int8_params_and_missing_safetensors_raise(models, tmp_path, monkeypatch):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="serving format"):
        loader.save_packed(str(tmp_path / "x.npz"), llama.recode_params_int8(tparams), tcfg)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="use a .npz path"):
        loader.save_packed(str(tmp_path / "x.safetensors"), tparams, tcfg)
    with pytest.raises(ImportError, match="use a .npz path"):
        loader.load_packed_auto(str(tmp_path / "x.safetensors"), device="cpu")


def test_config_dict_round_trip(models):
    """The port's config dict is the JAX package's, key for key."""
    cfg, _, tcfg, _ = models
    assert config_to_dict(tcfg) == {k: v for k, v in jloader.config_to_dict(cfg).items() if k in config_to_dict(tcfg)}
    assert jloader.config_from_dict(config_to_dict(tcfg)) == cfg
