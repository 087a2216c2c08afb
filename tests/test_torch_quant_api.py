"""The port's last single-card public API and config against nf4_tpu's:
``nf4_code``, ``to_quant_state`` (the inverse of the packing, over the
logical region), the package's ``__all__``, and the ``llama3-70b``
config, from the registry and from an HF ``config.json`` written here."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import _one_thread  # noqa: F401

import nf4_tpu
import nf4_tpu_torch
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import loader as jloader
from nf4_tpu.nf4 import format as jformat
from nf4_tpu_torch.models import configs, loader
from nf4_tpu_torch.models.convert import config_from_dict, config_to_dict
from nf4_tpu_torch.models.llama import check_supported
from nf4_tpu_torch.nf4 import format as tformat
from nf4_tpu_torch.nf4.reference import dequantize_nf4
from nf4_tpu_torch.ops.dequant import dequantize


def test_nf4_code_is_the_jax_packages():
    got = nf4_tpu_torch.nf4_code()
    want = nf4_tpu.nf4_code()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    got[0] = 5.0  # a copy: the table itself is untouched
    assert nf4_tpu_torch.nf4_code()[0] == -1.0 and nf4_tpu_torch.NF4_CODE[0] == -1.0


def test_all_is_the_jax_packages_plus_init_params():
    assert set(nf4_tpu_torch.__all__) == set(nf4_tpu.__all__) | {"init_params"}
    for name in nf4_tpu_torch.__all__:
        assert hasattr(nf4_tpu_torch, name), name


def _jax_packed(pw):
    """The JAX package's PackedNF4 over the same bytes as the port's."""
    return jformat.PackedNF4(packed=jnp.asarray(pw.packed.numpy()), scales=jnp.asarray(pw.scales.numpy()),
                             shape=pw.shape, padded_shape=pw.padded_shape, dtype=jnp.bfloat16, shards=pw.shards,
                             quant_type=pw.quant_type)


def _from_jax(jpw):
    return tformat.PackedNF4(packed=torch.from_numpy(np.array(jpw.packed)),
                             scales=torch.from_numpy(np.array(jpw.scales)), shape=tuple(jpw.shape),
                             padded_shape=tuple(jpw.padded_shape), dtype=torch.bfloat16, shards=jpw.shards,
                             quant_type=jpw.quant_type)


def _states_equal(got, want):
    np.testing.assert_array_equal(got.packed, want.packed)
    np.testing.assert_array_equal(got.absmax_u8, want.absmax_u8)
    np.testing.assert_array_equal(got.absmax32.view(np.uint32), want.absmax32.view(np.uint32))
    assert got.offset.tobytes() == np.float32(want.offset).tobytes()
    assert (got.shape, got.blocksize, got.blocksize2, got.quant_type, got.code2) == (
        tuple(want.shape), want.blocksize, want.blocksize2, want.quant_type, want.code2)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("shape", [(100, 320), (256, 2048), (8, 64)])
def test_to_quant_state_against_jax(shape, quant_type):
    """``to_quant_state`` of the port's packed weight equals the JAX
    package's of the same bytes, field by field, and ``dequantize_nf4`` of
    it is bit for bit the port's ``dequantize`` on the CPU (fp16 and fp32)."""
    w = (np.random.default_rng(sum(shape)).standard_normal(shape) * 0.05).astype(np.float32)
    pw = tformat.quantize_for_tpu(w, method="oracle", quant_type=quant_type, device="cpu")
    got = nf4_tpu_torch.to_quant_state(pw)
    want = nf4_tpu.to_quant_state(_jax_packed(pw))
    _states_equal(got, want)
    assert got.dtype == want.dtype == np.dtype(np.float16)
    np.testing.assert_array_equal(dequantize_nf4(got).view(np.uint16),
                                  dequantize(pw, torch.float16).numpy().view(np.uint16))
    np.testing.assert_array_equal(dequantize_nf4(got, np.float32).view(np.uint32),
                                  dequantize(pw, torch.float32).numpy().view(np.uint32))
    # and back: packing the state again gives the same bytes
    again = tformat.pack_for_tpu(got, device="cpu")
    assert torch.equal(again.packed, pw.packed) and torch.equal(again.scales, pw.scales)
    assert nf4_tpu_torch.to_quant_state(pw, torch.float32).dtype == np.dtype(np.float32)


def test_to_quant_state_of_a_sharded_weight():
    """Each K chunk of a ``shards=2`` weight (packed by the JAX package: the
    port does not pack for tensor parallelism yet) unpacks in order."""
    w = (np.random.default_rng(5).standard_normal((200, 2048)) * 0.05).astype(np.float32)
    jpw = jformat.quantize_for_tpu(w, shards=2, method="oracle")
    pw = _from_jax(jpw)
    got = tformat.to_quant_state(pw)
    _states_equal(got, jformat.to_quant_state(jpw))
    single = tformat.to_quant_state(tformat.quantize_for_tpu(w, method="oracle", device="cpu"))
    np.testing.assert_array_equal(dequantize_nf4(got, np.float32), dequantize_nf4(single, np.float32))


def test_llama3_70b_config():
    cfg = configs.get_config("llama3-70b")
    assert cfg is configs.LLAMA3_70B
    assert cfg == config_from_dict(jloader.config_to_dict(jconfigs.LLAMA3_70B))
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.tp_shards) == (80, 8192, 64, 8, 1)
    check_supported(cfg)
    assert configs.get_config("tiny-tp") == config_from_dict(jloader.config_to_dict(jconfigs.TINY_TP))


def test_llama3_70b_hf_config(tmp_path):
    """A Llama-3-70B ``config.json`` (its published fields, written here)
    maps to the same config through both packages' ``hf_config_to_llama``,
    and that config is the registry's."""
    hf = {
        "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
        "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 8192,
        "initializer_range": 0.02, "intermediate_size": 28672, "max_position_embeddings": 8192,
        "model_type": "llama", "num_attention_heads": 64, "num_hidden_layers": 80, "num_key_value_heads": 8,
        "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 500000.0,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "transformers_version": "4.40.0.dev0",
        "use_cache": True, "vocab_size": 128256,
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(hf))
    got = loader.hf_config_to_llama(str(path))
    want = jloader.hf_config_to_llama(str(path))
    assert config_to_dict(got) == {**jloader.config_to_dict(want), "dtype": "bfloat16"}
    assert got == config_from_dict(jloader.config_to_dict(want))
    assert got == configs.LLAMA3_70B
    check_supported(got)
