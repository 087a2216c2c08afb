"""The Llama-family variants' fields, the port's forward against nf4_tpu's.

Each case is a tiny model (``TINY_TEST`` and one field or a family's
fields on; a Gemma-7B-style model with head_dim 256) built by
``nf4_tpu.models.llama.init_params`` from a seed, with its norms and
biases redrawn from a numpy seed (``init_params`` makes the norms 1 and
the biases small, which would hide a field that is ignored), brought over
with ``params_from_numpy``.  The port prefills 3 prompts of 24 tokens and
decodes 4 greedy steps; one forward of the JAX package over the same
prompts and the port's tokens gives the reference logits of both.

Tolerances, as ``test_torch_llama.py`` and ``test_torch_engine.py`` state
them: logits within LOGIT_TOL (the port's projections round each weight to
bf16, the JAX package's CPU path keeps fp32); greedy tokens under the
teacher-forced rule: each token within LOGIT_TOL of the JAX top logit at
its step, and the JAX argmax wherever the JAX top-2 gap exceeds LOGIT_TOL
(a near-tie has no canonical winner across programs, ``PARITY.md``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models import loader as jloader
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu_torch.models import configs, llama, loader
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy

LOGIT_TOL = 0.2
PROMPT, STEPS = 24, 4

_HALF = jconfigs.TINY_TEST.head_dim // 2
VARIANTS = {
    "qwen2 attn_bias": dict(attn_bias=True),
    "qwen3 qk_norm": dict(qk_norm=True),
    "rope linear": dict(rope_scaling=("linear", 4.0)),
    # Wavelengths from 6.3 to ~4e4 against a band of 8..32: all three regimes.
    "rope llama3": dict(rope_scaling=("llama3", 8.0, 1.0, 4.0, 32)),
    # max_seq_len 64 > 32: the long factors and the derived cos/sin factor.
    "rope longrope": dict(rope_scaling=("longrope", tuple(1.0 + 0.1 * i for i in range(_HALF)),
                                        tuple(1.0 + 0.5 * i for i in range(_HALF)), 32)),
    "rope longrope, factor given": dict(rope_scaling=("longrope", (1.0,) * _HALF, (2.0,) * _HALF, 32, 1.3)),
    "gemma flags": dict(activation="gelu_tanh", rmsnorm_one_plus=True, scale_embeddings=True),
    "gelu": dict(activation="gelu"),
    "gemma-7b style, head_dim 256": dict(num_heads=2, num_kv_heads=2, head_dim=256, activation="gelu_tanh",
                                         rmsnorm_one_plus=True, scale_embeddings=True, rms_norm_eps=1e-6),
    # Mistral: a window shorter than the prompt, at prefill and decode.
    "mistral sliding_window": dict(sliding_window=8),
}


def _redraw(params, cfg, rng):
    """The JAX params with every norm's scale 1 + N(0, 0.3) (the weight
    itself with ``rmsnorm_one_plus``; Gemma-2/3's output norms too) and the
    q/k/v biases N(0, 0.5)."""
    base = 0.0 if cfg.rmsnorm_one_plus else 1.0

    def norm(shape):
        return jnp.asarray(base + rng.standard_normal(shape).astype(np.float32) * 0.3)

    lay = params.layers
    names = ("input_norm", "post_attn_norm", "q_norm", "k_norm", "post_attn_out_norm", "post_ffw_norm")
    new = {name: norm(getattr(lay, name).shape) for name in names if getattr(lay, name) is not None}
    if lay.qkv_bias is not None:
        new["qkv_bias"] = jnp.asarray(rng.standard_normal(lay.qkv_bias.shape).astype(np.float32) * 0.5)
    return params.replace(layers=lay.replace(**new), final_norm=norm(params.final_norm.shape))


def _models(fields, seed=0):
    cfg = dataclasses.replace(jconfigs.TINY_TEST, **fields)
    params = _redraw(jllama.init_params(cfg, seed=seed), cfg, np.random.default_rng(seed + 100))
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _check_greedy(got_tokens, want_logits):
    """The teacher-forced rule (module docstring) for each row's tokens."""
    for row_toks, row_logits in zip(got_tokens, want_logits):
        for tok, lg in zip(row_toks, row_logits):
            top2 = np.sort(lg)[-2:]
            assert lg[tok] >= top2[1] - LOGIT_TOL, (tok, lg[tok], top2[1])
            if top2[1] - top2[0] > LOGIT_TOL:
                assert tok == int(np.argmax(lg))


def _prefill_and_decode(cfg, params, tcfg, tparams, seed):
    """The port's prefill logits, greedy tokens and decode logits, and the
    JAX forward's logits over the prompts and those tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    lt, cache = llama.prefill(tparams, tcfg, torch.from_numpy(toks))
    tok = lt[:, -1].argmax(-1).to(torch.int32)
    gen, dec = [tok], []
    pos = torch.full((3,), PROMPT, dtype=torch.int32)
    for i in range(STEPS):
        logits, cache = llama.decode_step(tparams, tcfg, tok, cache, pos + i)
        dec.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
        gen.append(tok)
    seq = np.concatenate([toks, torch.stack(gen[:STEPS], 1).numpy()], axis=1)
    want, _ = jllama.prefill(params, cfg, jnp.asarray(seq))
    return lt.numpy(), torch.stack(gen, 1).numpy(), torch.stack(dec, 1).numpy(), np.asarray(want, np.float32)


# Fields that shape the model rather than switch a variant on.
_SHAPE_FIELDS = ("num_heads", "num_kv_heads", "head_dim", "rms_norm_eps")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_prefill_and_decode_match_jax(name):
    """Prefill and decode logits and greedy tokens against the JAX model;
    and a port that ignored any one of the variant's fields (the same
    weights, that field off, the bias or head norms dropped) would miss
    the JAX prefill logits by more than LOGIT_TOL."""
    cfg, params, tcfg, tparams = _models(VARIANTS[name])
    prefill, tokens, decode, want = _prefill_and_decode(cfg, params, tcfg, tparams, seed=1)
    np.testing.assert_allclose(prefill, want[:, :PROMPT], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(decode, want[:, PROMPT:], atol=LOGIT_TOL, rtol=0)
    _check_greedy(tokens, want[:, PROMPT - 1:])

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, PROMPT)).astype(np.int32))
    for field in VARIANTS[name]:
        if field in _SHAPE_FIELDS:
            continue
        off_cfg = dataclasses.replace(tcfg, **{field: getattr(configs.TINY_TEST, field)})
        drop = {"attn_bias": ("qkv_bias",), "qk_norm": ("q_norm", "k_norm")}.get(field, ())
        off_params = dataclasses.replace(
            tparams, layers=[dataclasses.replace(lp, **{n: None for n in drop}) for lp in tparams.layers])
        off, _ = llama.prefill(off_params, off_cfg, toks)
        assert np.abs(off.numpy() - want[:, :PROMPT]).max() > LOGIT_TOL, field


@pytest.mark.parametrize("kv_quant", [False, True])
def test_variants_in_int8_mode_match_jax(kv_quant):
    """Qwen2's biases and Qwen3's norms with int8-recoded weights (the bias
    a bf16 add after the int8 projection), bf16 or int8 KV."""
    cfg, params, tcfg, tparams = _models(dict(attn_bias=True, qk_norm=True, kv_quant=kv_quant))
    p8, t8 = jllama.recode_params_int8(params), llama.recode_params_int8(tparams)
    assert torch.equal(t8.layers[0].qkv_bias, tparams.layers[0].qkv_bias)
    prefill, tokens, decode, want = _prefill_and_decode(cfg, p8, tcfg, t8, seed=3)
    np.testing.assert_allclose(prefill, want[:, :PROMPT], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(decode, want[:, PROMPT:], atol=LOGIT_TOL, rtol=0)
    _check_greedy(tokens, want[:, PROMPT - 1:])


@pytest.mark.parametrize("ext", ["npz", "safetensors"])
def test_packed_checkpoint_with_bias_and_qk_norms(tmp_path, ext):
    """A checkpoint with q/k/v biases and q/k head norms, saved by nf4_tpu
    and loaded by the port (and back): the same leaves, bit for bit, and
    the same logits as the JAX model."""
    cfg, params, tcfg, tparams = _models(dict(attn_bias=True, qk_norm=True))
    path = str(tmp_path / f"variant.{ext}")
    jloader.save_packed(path, params, cfg)
    got, got_cfg = loader.load_packed_auto(path, device="cpu")
    assert got_cfg == tcfg
    for a, b in zip(got.layers, tparams.layers):
        for name in ("qkv_bias", "q_norm", "k_norm"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    back = str(tmp_path / f"back.{ext}")
    loader.save_packed(back, got, got_cfg)
    jp, _ = jloader.load_packed_auto(back)
    for name in ("qkv_bias", "q_norm", "k_norm"):
        np.testing.assert_array_equal(np.asarray(getattr(jp.layers, name)), np.asarray(getattr(params.layers, name)))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jllama.prefill(params, cfg, jnp.asarray(toks))
    lt, _ = llama.prefill(got, got_cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


def test_registry_holds_the_variants():
    """The port's configs are the JAX package's, field for field."""
    for name in ("qwen2-7b", "qwen3-8b", "llama3.1-8b", "gemma-7b", "mistral-7b"):
        assert configs.get_config(name) == config_from_dict(config_to_dict(jconfigs.get_config(name))), name


def test_synthetic_params_draw_the_variant_vectors():
    from nf4_tpu_torch.models.synthetic import synthetic_params

    cfg = dataclasses.replace(configs.TINY_TEST, attn_bias=True, qk_norm=True)
    a, b = synthetic_params(cfg, seed=5, device="cpu"), synthetic_params(cfg, seed=5, device="cpu")
    lp = a.layers[0]
    assert lp.qkv_bias.shape == (cfg.q_dim + 2 * cfg.kv_dim,) and lp.q_norm.shape == (cfg.head_dim,)
    assert lp.qkv_bias.dtype == lp.q_norm.dtype == torch.float32
    assert torch.equal(lp.k_norm, b.layers[0].k_norm) and not torch.equal(lp.q_norm, lp.k_norm)
    plain = synthetic_params(configs.TINY_TEST, seed=5, device="cpu")
    assert plain.layers[0].qkv_bias is None
    # The vectors are drawn after each layer's weights: a model without them
    # keeps its weights.
    assert torch.equal(plain.layers[0].wqkv.packed, a.layers[0].wqkv.packed)
