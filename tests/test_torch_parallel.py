"""Tensor parallelism of the port (``nf4_tpu_torch.parallel``) on the CPU,
held against the JAX package's (``nf4_tpu.parallel``, on the virtual
8-device mesh of ``tests/conftest.py``): the repacking index work byte for
byte, ``tp_local_config``'s values and refusals, and ``tp_prefill`` /
``tp_decode_step`` at tp = 2 and 4 over gloo ranks of this host (one group
of 4 for the module; a tp = 2 run uses ranks 0 and 1): logits within 2e-2
of their largest value, caches within the same, every rank's logits the
same bits.  Dense, MoE in tensor and expert mode, int8, the collective
matmul flag, and a ``tp_shards = 2`` checkpoint on one device."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.nf4 import format as jformat
from nf4_tpu.parallel import mesh as jmesh
from nf4_tpu.parallel import tp as jtp
from nf4_tpu_torch.models import configs, llama
from nf4_tpu_torch.nf4 import format as tformat
from nf4_tpu_torch.parallel import tp
from nf4_tpu_torch.parallel.launch import Ranks
from nf4_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from _torch_threads import _one_thread  # noqa: F401

TOKENS = np.arange(12, dtype=np.int32).reshape(2, 6) % 256
TOK, POS = np.array([5, 9], np.int32), np.array([6, 6], np.int32)
MOE = dict(num_experts=4, experts_per_token=2)


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, backend="gloo", device="cpu", threads=1) as r:
        yield r


def _jax_tp(cfg, seed, tp_deg, int8=False, decode=True):
    """The JAX package's tp_prefill (and tp_decode_step) logits and cache."""
    params = jllama.init_params(cfg, seed=seed)
    if int8:
        params = jllama.recode_params_int8(params)
    mesh = jmesh.make_mesh(tp=tp_deg, dp=8 // tp_deg)
    sharded, _ = jtp.shard_params(jtp.localize_params(params, tp_deg, cfg.moe_shard), mesh, moe_shard=cfg.moe_shard)
    logits, cache = jtp.tp_prefill(sharded, cfg, mesh, jnp.asarray(TOKENS))
    dec = None
    if decode:
        dec, _ = jtp.tp_decode_step(sharded, cfg, mesh, jnp.asarray(TOK), cache, jnp.asarray(POS))
        dec = np.asarray(dec, np.float32)
    return np.asarray(logits, np.float32), dec, cache


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def _port_cfg(jcfg):
    from nf4_tpu.models.loader import config_to_dict
    from nf4_tpu_torch.models.convert import config_from_dict

    return config_from_dict(config_to_dict(jcfg))


def _leaves(w):
    """A weight's arrays and metadata, either package's (layer axis first)."""
    if hasattr(w, "packed"):
        return [np.asarray(w.packed), np.asarray(w.scales)], (tuple(w.shape), tuple(w.padded_shape), w.shards)
    return [np.asarray(w, np.float32)], ()


def _port_stacked(params, name):
    ws = [getattr(lp, name) for lp in params.layers]
    if isinstance(ws[0], torch.Tensor):
        return [torch.stack(ws).float().numpy()], ()
    w = ws[0]
    return ([torch.stack([x.packed for x in ws]).numpy(), torch.stack([x.scales for x in ws]).numpy()],
            (tuple(w.shape), tuple(w.padded_shape), w.shards))


def _same_weights(params, jparams):
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        got, gmeta = _port_stacked(params, name)
        want, wmeta = _leaves(getattr(jparams.layers, name))
        assert gmeta == wmeta, name
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    if jparams.layers.qkv_bias is not None:
        np.testing.assert_array_equal(torch.stack([lp.qkv_bias for lp in params.layers]).numpy(),
                                      np.asarray(jparams.layers.qkv_bias))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_interleave_fuse_and_split_match_jax(groups):
    rng = np.random.default_rng(groups)
    sizes = (1024, 512, 512)
    np.testing.assert_array_equal(tformat.interleave_perm(sizes, groups), jformat.interleave_perm(sizes, groups))
    ws = [rng.standard_normal((m, 64)).astype(np.float32) for m in sizes]
    fused = llama.fuse_rows(ws, groups)
    np.testing.assert_array_equal(fused.numpy(), jllama.fuse_rows(ws, groups))
    np.testing.assert_array_equal(fused.numpy(), np.concatenate(ws)[tformat.interleave_perm(sizes, groups)])
    q = [jformat.QDense(rng.integers(0, 16, (m, 128)).astype(np.uint8), rng.random((m, 2), np.float32))
         for m in sizes]
    tq = llama.fuse_rows([tformat.QDense(x.codes, x.scales) for x in q], groups)
    jq = jllama.fuse_rows(q, groups)
    np.testing.assert_array_equal(tq.codes, jq.codes)
    np.testing.assert_array_equal(tq.scales, jq.scales)
    y = torch.randn(3, sum(sizes))
    for got, want in zip(llama.split_fused(y, sizes, groups), jllama.split_fused(jnp.asarray(y.numpy()), sizes, groups)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for w, back in zip(ws, llama.split_fused(fused.t(), sizes, groups)):
        np.testing.assert_array_equal(back.t().numpy(), w)


def test_permute_rechunk_and_sharded_quantize_match_jax():
    w = (np.random.default_rng(0).standard_normal((256, 1536)) * 0.05).astype(np.float32)
    jw = jformat.quantize_for_tpu(w, method="oracle")
    pw = tformat.quantize_for_tpu(w, method="oracle", device="cpu")
    np.testing.assert_array_equal(pw.packed.numpy(), np.asarray(jw.packed))
    perm = np.random.default_rng(1).permutation(256)
    got, want = tformat.permute_out_features(pw, perm), jformat.permute_out_features(jw, perm)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    for a, b in ((1, 4), (4, 2), (2, 3), (3, 1)):
        src_t, src_j = tformat.rechunk_shards(pw, a), jformat.rechunk_shards(jw, a)
        got, want = tformat.rechunk_shards(src_t, b), jformat.rechunk_shards(src_j, b)
        assert (got.shards, got.padded_shape) == (want.shards, tuple(want.padded_shape)) == (b, want.padded_shape)
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
        direct = tformat.quantize_for_tpu(w, shards=b, method="oracle", device="cpu")
        np.testing.assert_array_equal(direct.packed.numpy(), got.packed.numpy())
        np.testing.assert_array_equal(direct.scales.numpy(), got.scales.numpy())
    stacked = dataclasses.replace(pw, packed=torch.stack([pw.packed] * 2), scales=torch.stack([pw.scales] * 2))
    four = tformat.rechunk_shards(stacked, 4)
    np.testing.assert_array_equal(four.packed[1].numpy(), tformat.rechunk_shards(pw, 4).packed.numpy())
    with pytest.raises(ValueError, match="permutation"):
        tformat.permute_out_features(pw, np.zeros(256, int))
    with pytest.raises(ValueError, match="chunks"):
        tformat.rechunk_shards(pw, 5)


CASES = {
    "dense": {},
    "bias": dict(attn_bias=True),
    "moe-tensor": MOE,
    "moe-expert": dict(MOE, moe_shard="expert"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_packed_for_tp_and_repack_match_jax(case):
    """``init_params`` packed for tp_shards = 4 is the JAX package's byte for
    byte; ``repack_tp`` of the tp_shards = 1 params to 4 is quantizing with
    4 directly, and back to 1 the original."""
    jcfg = dataclasses.replace(jconfigs.TINY_TP, num_layers=1, **CASES[case])
    cfg = _port_cfg(jcfg)
    params = llama.init_params(cfg, seed=3, device="cpu")
    _same_weights(params, jllama.init_params(jcfg, seed=3))
    cfg1 = dataclasses.replace(cfg, tp_shards=1)
    p1 = llama.init_params(cfg1, seed=3, device="cpu")
    got, got_cfg = tp.repack_tp(p1, cfg1, 4)
    assert got_cfg == cfg
    _same_weights(got, jtp.repack_tp(jllama.init_params(dataclasses.replace(jcfg, tp_shards=1), seed=3),
                                     dataclasses.replace(jcfg, tp_shards=1), 4)[0])
    _same_weights(got, jllama.init_params(jcfg, seed=3))
    back, back_cfg = tp.repack_tp(got, cfg, 1)
    assert back_cfg == cfg1
    for a, b in zip(back.layers, p1.layers):
        for name in ("wqkv", "wo", "w_gateup", "w_down"):
            assert torch.equal(getattr(a, name).packed, getattr(b, name).packed), name
            assert torch.equal(getattr(a, name).scales, getattr(b, name).scales), name
    with pytest.raises(TypeError, match="recode to int8 after"):
        tp.repack_tp(llama.recode_params_int8(p1), cfg1, 2)


def test_tp_local_config_matches_jax_and_refuses():
    for case in sorted(CASES):
        jcfg = dataclasses.replace(jconfigs.TINY_TP, **CASES[case])
        for rank in range(4):
            got = tp.tp_local_config(_port_cfg(jcfg), 4, rank)
            want = _port_cfg(jtp.tp_local_config(jcfg, 4))
            assert got == dataclasses.replace(want, ep_rank=rank if case == "moe-expert" else None)
    cfg = configs.TINY_TP
    for bad in (dict(num_kv_heads=3), dict(num_heads=6), dict(tp_shards=2),
                dict(num_experts=3, moe_shard="expert")):
        with pytest.raises(ValueError):
            tp.tp_local_config(dataclasses.replace(cfg, **bad), 4)
        with pytest.raises(AssertionError):
            jtp.tp_local_config(dataclasses.replace(jconfigs.TINY_TP, **bad), 4)
    with pytest.raises(ValueError, match="tp_shards"):
        tp.localize_params(llama.init_params(dataclasses.replace(cfg, tp_shards=2), 0, device="cpu"), cfg, 4, 0)


@pytest.mark.parametrize("tp_deg", [2, 4])
def test_tp_prefill_and_decode_match_jax(ranks, tp_deg):
    jcfg = dataclasses.replace(jconfigs.TINY_TP, tp_shards=tp_deg)
    want, want_dec, jcache = _jax_tp(jcfg, 0, tp_deg)
    logits, dec, caches, same, stats = ranks.run(td.prefill_decode, _port_cfg(jcfg), 0, TOKENS, TOK, POS, tp=tp_deg)
    assert same, "ranks hold different logits"
    _close(logits, want)
    _close(dec, want_dec)
    assert (np.argmax(dec, -1) == np.argmax(want_dec, -1)).all()
    # The prefill's cache: rank r holds KV heads [r * KV / tp, (r + 1) * KV / tp).
    k = np.concatenate([c["k"] for c in caches], axis=2)
    assert k.shape == jcache.k.shape
    # (the decode step wrote position 6 too, which the JAX prefill's cache lacks)
    _close(k[:, :, :, :6], np.asarray(jcache.k, np.float32)[:, :, :, :6])
    _close(np.concatenate([c["v"] for c in caches], axis=2)[:, :, :, :6], np.asarray(jcache.v, np.float32)[:, :, :, :6])
    # Two reductions per layer and one logits gather per forward.
    assert stats["calls"] % (2 * jcfg.num_layers + 1) == 0


def test_tp_shards_checkpoint_on_one_device():
    """A tp_shards = 2 checkpoint served by one device gives the tp_shards =
    1 checkpoint's logits (and the JAX package's for it)."""
    cfg2 = dataclasses.replace(configs.TINY_TP, tp_shards=2)
    cfg1 = dataclasses.replace(cfg2, tp_shards=1)
    toks = torch.as_tensor(TOKENS)
    got, _ = llama.prefill(llama.init_params(cfg2, 0, device="cpu"), cfg2, toks)
    want, _ = llama.prefill(llama.init_params(cfg1, 0, device="cpu"), cfg1, toks)
    _close(got.numpy(), want.numpy())
    assert (got.argmax(-1) == want.argmax(-1)).all()
    jcfg2 = dataclasses.replace(jconfigs.TINY_TP, tp_shards=2)
    jwant, _ = jllama.prefill(jllama.init_params(jcfg2, seed=0), jcfg2, jnp.asarray(TOKENS))
    _close(got.numpy(), np.asarray(jwant, np.float32))


def test_collective_matmul_is_bit_identical(ranks, monkeypatch):
    """NF4TPU_COLLECTIVE_MATMUL=2 reduces wo's and w_down's 256 output lanes
    in two chunks of 128 (two reductions each), =4 would cut 64-lane
    chunks, not whole tiles, and keeps one: both give the bits of one
    reduction."""
    cfg = configs.TINY_TP
    runs = {n: ranks.run(td.prefill_decode, cfg, 0, TOKENS, TOK, POS, tp=4,
                         env={"NF4TPU_COLLECTIVE_MATMUL": str(n)}) for n in (0, 4, 2)}
    for n in (4, 2):
        np.testing.assert_array_equal(runs[n][0], runs[0][0])
        np.testing.assert_array_equal(runs[n][1], runs[0][1])
        for a, b in zip(runs[n][2], runs[0][2]):
            np.testing.assert_array_equal(a["k"], b["k"])
    calls = {n: r[4]["calls"] for n, r in runs.items()}  # the mesh's counts run on across calls
    per_forward = 2 * cfg.num_layers + 1
    assert calls[4] - calls[0] == 2 * per_forward  # a prefill and a decode step
    assert calls[2] - calls[4] == 2 * (per_forward + 2 * cfg.num_layers)
    for bad in ("banana", "-1"):
        monkeypatch.setenv("NF4TPU_COLLECTIVE_MATMUL", bad)
        with pytest.raises(ValueError, match="NF4TPU_COLLECTIVE_MATMUL"):
            llama.collective_chunks()
    monkeypatch.setenv("NF4TPU_COLLECTIVE_MATMUL", "2")  # one device: no reduction, nothing changes
    cfg1 = dataclasses.replace(cfg, tp_shards=1)
    p1 = llama.init_params(cfg1, 0, device="cpu")
    got, _ = llama.prefill(p1, cfg1, torch.as_tensor(TOKENS))
    monkeypatch.delenv("NF4TPU_COLLECTIVE_MATMUL")
    want, _ = llama.prefill(p1, cfg1, torch.as_tensor(TOKENS))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shard", ["tensor", "expert"])
def test_moe_over_tp_matches_jax(ranks, shard):
    """MoE at tp = 4 (the setups of the JAX package's TestMoETP and TestMoEEP:
    4 experts, top-2; "expert" mode one whole expert per rank), one layer,
    in fp32 activations: a route is a discrete choice that bf16 rounding
    can flip between the packages (``tests/test_torch_moe.py``)."""
    jcfg = dataclasses.replace(jconfigs.TINY_TP, moe_shard=shard, num_layers=1, dtype=jnp.float32, **MOE)
    seed = 3 if shard == "tensor" else 5
    want, _, _ = _jax_tp(jcfg, seed, 4, decode=False)
    logits, _, _, same, _ = ranks.run(td.prefill_decode, _port_cfg(jcfg), seed, TOKENS, TOK, POS, tp=4)
    assert same
    _close(logits, want)


def test_int8_over_tp_matches_jax(ranks):
    want, _, _ = _jax_tp(jconfigs.TINY_TP, 0, 4, int8=True, decode=False)
    logits, _, _, same, _ = ranks.run(td.prefill_decode, configs.TINY_TP, 0, TOKENS, TOK, POS, tp=4, int8=True)
    assert same
    _close(logits, want)


def test_mesh_refusals():
    """nccl needs one GPU per rank (this host has fewer than 64), and a mesh
    needs a job."""
    with pytest.raises(RuntimeError, match="one GPU per rank"):
        initialize_distributed("localhost:1", num_processes=64, process_id=0, backend="nccl")
    with pytest.raises(ValueError, match="together"):
        initialize_distributed("localhost:1", num_processes=2)
    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        make_mesh(tp=2)
