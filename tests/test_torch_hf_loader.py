"""Loading HF checkpoint directories with the port (``nf4_tpu_torch``'s
``models/loader.py``: ``hf_config_to_llama``, ``load_hf_llama``) against
the JAX package on the CPU.

``hf_config_to_llama`` on an HF config dict per family (llama3, qwen2,
qwen3, qwen3_moe, mixtral, gemma, gemma2, gemma3, phi3), rope scalings and
every error: the configs equal the JAX package's (through its
``config_to_dict``) and the errors are the same.  ``load_hf_llama`` on tiny
directories written here (dense fp32 and fp16, bnb NF4 and FP4 with
double-quantized and raw statistics, tied and untied embeddings, Qwen2
biases, Gemma-2 norms, both MoE namings, Phi-3's fused projections, two
shard files with a layer and a bnb group across them): the params equal
``nf4_tpu``'s ``load_hf_llama`` passed through ``params_from_numpy``
(packed bytes, scales, norms, embeddings, bit for bit), the ``stats`` are
equal, and prefill logits agree within ``tests/test_torch_llama.py``'s
LOGIT_TOL.  The tensors are drawn with numpy from a seed."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("safetensors")
from safetensors.numpy import save_file  # noqa: E402
from test_bnb_checkpoint import bnb_tensors  # noqa: E402

from nf4_tpu.models import llama as jllama  # noqa: E402
from nf4_tpu.models import loader as jloader  # noqa: E402
from nf4_tpu.nf4.reference import quantize_nf4  # noqa: E402
from nf4_tpu_torch.models import llama  # noqa: E402
from nf4_tpu_torch.models import loader  # noqa: E402
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy  # noqa: E402
from nf4_tpu_torch.nf4.format import PackedNF4  # noqa: E402

LOGIT_TOL = 0.2  # tests/test_torch_llama.py's

# A tiny model's HF config (TINY_TEST's widths).
_BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, rope_theta=10000.0, rms_norm_eps=1e-5, max_position_embeddings=64)
_BNB = {"quant_method": "bitsandbytes", "load_in_4bit": True, "load_in_8bit": False,
        "bnb_4bit_use_double_quant": True, "bnb_4bit_compute_dtype": "bfloat16"}

# Per family: the HF config fields beyond _BASE.
FAMILIES = {
    "llama3": dict(model_type="llama", rope_theta=500000.0,
                   rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0, "original_max_position_embeddings": 32}),
    "qwen2": dict(model_type="qwen2", sliding_window=None),
    "qwen3": dict(model_type="qwen3"),
    "qwen3_moe": dict(model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
                      norm_topk_prob=False),
    "mixtral": dict(model_type="mixtral", num_local_experts=4, num_experts_per_tok=2, sliding_window=32),
    "gemma": dict(model_type="gemma", hidden_act="gelu"),
    "gemma2": dict(model_type="gemma2", hidden_activation="gelu_pytorch_tanh", sliding_window=16,
                   query_pre_attn_scalar=32, attn_logit_softcapping=50.0, final_logit_softcapping=None),
    "gemma3": dict(model_type="gemma3_text", sliding_window=16, sliding_window_pattern=6, rope_local_base_freq=1e4,
                   query_pre_attn_scalar=32, rope_scaling={"rope_type": "linear", "factor": 8.0}),
    "phi3": dict(model_type="phi3", hidden_act="silu",
                 rope_scaling={"type": "longrope", "short_factor": [1.0] * 16, "long_factor": [2.0] * 16,
                               "original_max_position_embeddings": 32}),
    "gelu_exact": dict(model_type="llama", hidden_act="gelu_python"),
    "bnb_fp4_default": dict(model_type="llama", quantization_config={**_BNB}),
}

ERRORS = {
    "yarn": dict(rope_scaling={"rope_type": "yarn", "factor": 4.0}),
    "gelu_unknown": dict(hidden_act="gelu_10"),
    "shared_experts": dict(num_experts=4, shared_expert_intermediate_size=64),
    "mlp_only_layers": dict(num_experts=4, mlp_only_layers=[0]),
    "sparse_step": dict(num_experts=4, decoder_sparse_step=2),
    "gptq": dict(quantization_config={"quant_method": "gptq"}),
    "int8": dict(quantization_config={**_BNB, "load_in_8bit": True}),
    "no_4bit": dict(quantization_config={**_BNB, "load_in_4bit": False}),
}


def _write_config(path, hf):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf))
    return str(path / "config.json")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_config_equals_the_jax_package(tmp_path, family):
    cfg_path = _write_config(tmp_path, {**_BASE, **FAMILIES[family]})
    want = jloader.hf_config_to_llama(cfg_path, max_seq_len=48)
    got = loader.hf_config_to_llama(cfg_path, max_seq_len=48)
    assert got == config_from_dict(jloader.config_to_dict(want))
    assert got.max_seq_len == 48


@pytest.mark.parametrize("case", list(ERRORS))
def test_hf_config_errors_equal_the_jax_package(tmp_path, case):
    cfg_path = _write_config(tmp_path, {**_BASE, "model_type": "llama", **ERRORS[case]})
    with pytest.raises(ValueError) as want:
        jloader.hf_config_to_llama(cfg_path)
    with pytest.raises(ValueError) as got:
        loader.hf_config_to_llama(cfg_path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Checkpoint directories


def _layer_tensors(family, rng, cfg):
    """One layer's HF tensors (fp32) for ``family``."""
    h, inter, q, kv = cfg["hidden_size"], cfg["intermediate_size"], 128, 64
    w = lambda m, n: (rng.standard_normal((m, n)) * 0.05).astype(np.float32)  # noqa: E731
    norm = lambda: (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)  # noqa: E731
    out = {"input_layernorm.weight": norm(), "post_attention_layernorm.weight": norm()}
    if family == "phi3":
        out["self_attn.qkv_proj.weight"] = w(q + 2 * kv, h)
        out["mlp.gate_up_proj.weight"] = w(2 * inter, h)
    else:
        out.update({"self_attn.q_proj.weight": w(q, h), "self_attn.k_proj.weight": w(kv, h),
                    "self_attn.v_proj.weight": w(kv, h)})
    out["self_attn.o_proj.weight"] = w(h, q)
    if family == "mixtral":
        out["block_sparse_moe.gate.weight"] = w(4, h)
        for e in range(4):
            out.update({f"block_sparse_moe.experts.{e}.w1.weight": w(inter, h),
                        f"block_sparse_moe.experts.{e}.w3.weight": w(inter, h),
                        f"block_sparse_moe.experts.{e}.w2.weight": w(h, inter)})
    elif family == "qwen3_moe":
        out["mlp.gate.weight"] = w(4, h)
        for e in range(4):
            out.update({f"mlp.experts.{e}.gate_proj.weight": w(64, h), f"mlp.experts.{e}.up_proj.weight": w(64, h),
                        f"mlp.experts.{e}.down_proj.weight": w(h, 64)})
    elif family == "phi3":
        out["mlp.down_proj.weight"] = w(h, inter)
    else:
        out.update({"mlp.gate_proj.weight": w(inter, h), "mlp.up_proj.weight": w(inter, h),
                    "mlp.down_proj.weight": w(h, inter)})
    if family == "qwen2":
        for p, n in (("q", q), ("k", kv), ("v", kv)):
            out[f"self_attn.{p}_proj.bias"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
    if family == "qwen3_moe":
        out["self_attn.q_norm.weight"] = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
        out["self_attn.k_norm.weight"] = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    if family == "gemma2":
        out["pre_feedforward_layernorm.weight"] = norm()
        out["post_feedforward_layernorm.weight"] = norm()
    out["mlp.unused_tensor"] = np.zeros(4, np.float32)  # ignored by both loaders
    return out


def write_checkpoint(path, family="llama3", dtype=np.float32, bnb=None, tied=False, shards=1, seed=0, drop=None):
    """A tiny HF checkpoint directory: ``config.json`` and ``shards``
    safetensors files (keys split in sorted order, so with 2 a layer and
    its bnb groups straddle the files).  ``bnb``: None (dense), or
    (quant_type, compress_statistics): every projection bnb-serialized
    (the MoE router and the lm_head too).  ``drop``: a key left out."""
    path.mkdir(parents=True, exist_ok=True)
    hf = {**_BASE, **FAMILIES[family]}
    hf.pop("quantization_config", None)
    if bnb is not None:
        hf["quantization_config"] = {**_BNB, "bnb_4bit_quant_type": bnb[0]}
    rng = np.random.default_rng(seed)
    tensors = {"model.embed_tokens.weight": (rng.standard_normal((256, 128)) * 0.05).astype(np.float32),
               "model.norm.weight": (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)}
    if not tied:
        tensors["lm_head.weight"] = (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)
    for i in range(hf["num_hidden_layers"]):
        for k, t in _layer_tensors(family, rng, hf).items():
            tensors[f"model.layers.{i}.{k}"] = t
    out = {}
    for key, t in tensors.items():
        quantized = bnb is not None and t.ndim == 2 and key != "model.embed_tokens.weight"
        if quantized:
            out.update(bnb_tensors(key, quantize_nf4(t, dtype=np.float16, compress_statistics=bnb[1],
                                                    quant_type=bnb[0])))
        else:
            out[key] = t.astype(dtype)
    if drop is not None:
        out.pop(drop)
    keys = sorted(out)
    per = -(-len(keys) // shards)
    for s in range(shards):
        save_file({k: out[k] for k in keys[s * per:(s + 1) * per]},
                  str(path / f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))
    _write_config(path, hf)
    return str(path)


def _equal(a, b, where):
    if isinstance(a, PackedNF4):
        assert isinstance(b, PackedNF4), where
        assert (a.shape, a.padded_shape, a.quant_type, a.dtype) == (b.shape, b.padded_shape, b.quant_type, b.dtype)
        a, b = (a.packed, a.scales), (b.packed, b.scales)
    else:
        a, b = (a,), (b,)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert torch.equal(x.view(torch.uint8) if x.dtype != torch.uint8 else x,
                           y.view(torch.uint8) if y.dtype != torch.uint8 else y), where


def _params_equal(got, want):
    _equal(got.embed, want.embed, "embed")
    _equal(got.final_norm, want.final_norm, "final_norm")
    _equal(got.lm_head, want.lm_head, "lm_head")
    assert len(got.layers) == len(want.layers)
    for i, (g, w) in enumerate(zip(got.layers, want.layers)):
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert (a is None) == (b is None), (i, f.name)
            if a is not None:
                _equal(a, b, (i, f.name))


def _load_both(path, **overrides):
    """(port params, port cfg, JAX params, JAX cfg, port stats, JAX stats)."""
    jstats, tstats = {}, {}
    jcfg = jloader.hf_config_to_llama(f"{path}/config.json", **overrides)
    jparams, jcfg = jloader.load_hf_llama(path, jcfg, stats=jstats)
    tcfg = config_from_dict(jloader.config_to_dict(jcfg))
    tparams, tcfg2 = loader.load_hf_llama(path, tcfg, stats=tstats, device="cpu")
    assert tcfg2 == tcfg
    return tparams, tcfg, jparams, jcfg, tstats, jstats


# (family, checkpoint dtype, bnb, tied, shards, logits checked)
CASES = {
    "dense-fp32-two-shards": ("llama3", np.float32, None, False, 2, True),
    "dense-fp16-tied": ("llama3", np.float16, None, True, 1, False),
    "bnb-nf4-double-quant-two-shards": ("llama3", np.float32, ("nf4", True), False, 2, True),
    "bnb-fp4-double-quant": ("llama3", np.float32, ("fp4", True), True, 1, False),
    "bnb-nf4-raw-stats": ("llama3", np.float32, ("nf4", False), False, 1, False),
    "qwen2-biases": ("qwen2", np.float32, None, False, 1, False),
    "gemma2-norms": ("gemma2", np.float16, None, True, 1, True),
    "mixtral": ("mixtral", np.float32, None, False, 2, True),
    "qwen3-moe-bnb": ("qwen3_moe", np.float32, ("nf4", True), False, 1, False),
    "phi3-fused": ("phi3", np.float32, None, False, 1, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_hf_llama_equals_the_jax_package(tmp_path, case):
    family, dtype, bnb, tied, shards, logits = CASES[case]
    path = write_checkpoint(tmp_path, family, dtype, bnb, tied, shards)
    moe = family in ("mixtral", "qwen3_moe")
    # MoE in fp32 activations: a bf16 route can flip between two programs
    # (tests/test_torch_moe.py's reason).
    overrides = dict(dtype=jnp.float32) if moe else {}
    tparams, tcfg, jparams, jcfg, tstats, jstats = _load_both(path, **overrides)
    want = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    _params_equal(tparams, want)
    assert tstats == jstats and tstats["peak_dense_bytes"] > 0
    if tied and not jcfg.quantize_lm_head and bnb is None:
        assert tparams.lm_head is tparams.embed
    if logits:
        toks = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
        lj, _ = jllama.prefill(jparams, jcfg, jnp.asarray(toks))
        lt, _ = llama.prefill(tparams, tcfg, torch.from_numpy(toks))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=0)


def test_streaming_holds_one_layer(tmp_path):
    """peak_dense_bytes is one layer's dense bytes (the two files split
    layer 0), not the model's."""
    path = write_checkpoint(tmp_path, "llama3", np.float16, shards=2)
    stats = {}
    loader.load_hf_llama(path, stats=stats, device="cpu")
    layer = sum(t.nbytes for k, t in _layer_tensors("llama3", np.random.default_rng(0), _BASE).items()
                if k != "mlp.unused_tensor") // 2  # fp16
    assert stats["total_dense_bytes"] == 2 * layer and stats["peak_dense_bytes"] == layer


@pytest.mark.parametrize("drop", ["model.layers.1.self_attn.q_proj.weight.absmax",
                                  "model.layers.1.mlp.down_proj.weight", "model.norm.weight"])
def test_load_errors_equal_the_jax_package(tmp_path, drop):
    """An incomplete bnb group, a layer missing a tensor and a missing
    final norm raise the JAX package's errors."""
    path = write_checkpoint(tmp_path, "llama3", bnb=("nf4", True) if "absmax" in drop else None, drop=drop)
    with pytest.raises(ValueError) as want:
        jloader.load_hf_llama(path)
    with pytest.raises(ValueError) as got:
        loader.load_hf_llama(path, device="cpu")
    assert str(got.value) == str(want.value)


def test_load_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path = write_checkpoint(tmp_path, "llama3")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_hf_llama(path)
