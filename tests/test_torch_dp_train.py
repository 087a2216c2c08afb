"""QLoRA training over a dp x tp mesh (``make_train_step(mesh=)``) on gloo
ranks on the CPU (one group of 4 for the module), ``merge_lora``'s shard
counts, and the JAX package's tensor-parallel gradients.

Tolerances (all in fp32, where the packages agree to fp32 rounding):

* the adapters' first SGD(1.0) update (their gradient) over a mesh against
  the port's one-process update on the same checkpoint: within 1e-5 of
  each leaf's largest value (the sums re-associated over the ranks), the
  loss within 1e-6 relative;
* losses against the JAX package's single-device step: 1e-5 relative at
  the first step, 1e-4 over AdamW steps (``test_torch_train.py``'s);
* ``merge_lora`` with the oracle quantizer: packed bytes and scales equal
  to the JAX ``merge_lora``'s (adapters of small dyadic values, so the
  merged fp32 weights are the same bits on both sides).

The JAX package's tensor-parallel step gives tp times the single-device
gradients (``nf4_tpu/train/trainer.py:134``, ``:147-155``: the transpose of
the forward's ``psum`` inside ``shard_map(check_vma=False)``);
:func:`test_the_reference_tp_gradients_are_tp_times_the_single_device_ones`
keeps that on record, and the port does not copy it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist as td
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.parallel.mesh import make_mesh as jax_mesh
from nf4_tpu.parallel.tp import repack_tp as jrepack_tp
from nf4_tpu.train import lora as jlora
from nf4_tpu.train import trainer as jtrainer
from nf4_tpu_torch.models import configs, llama
from nf4_tpu_torch.models.convert import lora_from_numpy
from nf4_tpu_torch.parallel.launch import Ranks
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.train import merge_lora
from _torch_threads import _one_thread  # noqa: F401

CFG, JCFG = (dataclasses.replace(c, dtype=d) for c, d in ((configs.TINY_TEST, torch.float32),
                                                          (jconfigs.TINY_TEST, jnp.float32)))
RANK, ALPHA = 4, 8.0
FIELDS = ("qkv", "o", "gateup", "down")


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4, backend="gloo", device="cpu", threads=1, timeout=td.RUN_TIMEOUT_S) as r:
        yield r


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(11).integers(0, CFG.vocab_size, (4, 16)).astype(np.int32)


def _jax_model(tp_shards):
    base = jllama.init_params(JCFG, seed=0)
    return jrepack_tp(base, JCFG, tp_shards) if tp_shards > 1 else (base, JCFG)


def _jax_adapters(jcfg, b_seed=None, b_scale=0.05):
    """``td.adapters``'s pair in the JAX package: init_lora's A, B drawn in
    the port's parameter order (layer by layer, target by target)."""
    jl = jlora.init_lora(jcfg, jlora.LoraConfig(rank=RANK, alpha=ALPHA), seed=0)
    if b_seed is None:
        return jl
    rng = np.random.default_rng(b_seed)
    bs = {f: np.array(getattr(jl.layers, f).b) for f in FIELDS}
    for i in range(jcfg.num_layers):
        for f in FIELDS:
            bs[f][i] = (rng.standard_normal(bs[f][i].shape) * b_scale).astype(np.float32)
    return jl.replace(layers=jl.layers.replace(**{f: getattr(jl.layers, f).replace(b=jnp.asarray(bs[f]))
                                                  for f in FIELDS}))


def _by_name(jtree):
    return {f"layers.{i}.{f}.{side}": np.asarray(getattr(getattr(jtree.layers, f), side))[i]
            for f in FIELDS for side in ("a", "b") for i in range(JCFG.num_layers)}


def _jax_step(tokens, tp_shards=1, b_seed=None, opt=None, steps=1, mesh=None, loss_mask=None, accum_steps=1):
    params, jcfg = _jax_model(tp_shards)
    jl = _jax_adapters(jcfg, b_seed)
    opt = opt or optax.sgd(1.0)
    step = jtrainer.make_train_step(jcfg, opt, mesh=mesh, accum_steps=accum_steps)
    state, losses, first = opt.init(jl), [], None
    toks = jnp.asarray(tokens)
    mask = None if loss_mask is None else jnp.asarray(loss_mask)
    for i in range(steps):
        new, state, loss = step(params, jl, state, toks, mask)
        if i == 0:
            before, after = _by_name(jl), _by_name(new)
            first = {n: before[n] - after[n] for n in before}
        jl = new
        losses.append(float(loss))
    return losses, first


def _close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for name in want:
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=rel * scale, err_msg=name)


# --- the repair: merge_lora keeps each weight's shard count ----------------------


def _dyadic_adapter(jcfg, seed):
    """A nonzero adapter of small multiples of 2^-6 (scaling 2): ``B @ A``
    and its scaling are exact in fp32, so each side's merged weight is
    ``W + delta`` with one rounding, the same bits in both packages."""
    jl = jlora.init_lora(jcfg, jlora.LoraConfig(rank=RANK, alpha=ALPHA), seed=0)
    rng = np.random.default_rng(seed)
    fields = {}
    for f in FIELDS:
        ab = getattr(jl.layers, f)
        a, b = (rng.integers(-8, 9, t.shape).astype(np.float32) / 64 for t in (ab.a, ab.b))
        fields[f] = ab.replace(a=jnp.asarray(a), b=jnp.asarray(b))
    return jl.replace(layers=jl.layers.replace(**fields))


@pytest.mark.parametrize("tp_shards", [2, 4])
def test_merge_lora_keeps_shards_and_matches_jax_bytes(tp_shards):
    jcfg = dataclasses.replace(jconfigs.TINY_TP, tp_shards=tp_shards)
    cfg = dataclasses.replace(configs.TINY_TP, tp_shards=tp_shards)
    jl = _dyadic_adapter(jcfg, seed=tp_shards)
    jmerged = jlora.merge_lora(jllama.init_params(jcfg, seed=0), jl, jcfg, quantize=True, method="oracle")
    params = llama.init_params(cfg, 0, device="cpu")
    merged = merge_lora(params, lora_from_numpy(jax.tree.map(np.asarray, jl), device="cpu"), cfg, method="oracle")
    for i in range(cfg.num_layers):
        for name in ("wqkv", "wo", "w_gateup", "w_down"):
            got, base, jw = getattr(merged.layers[i], name), getattr(params.layers[i], name), getattr(jmerged.layers, name)
            want_shards = tp_shards if name in ("wo", "w_down") else 1
            assert got.shards == base.shards == jw.shards == want_shards, name
            np.testing.assert_array_equal(got.packed.numpy(), np.asarray(jw.packed[i]), err_msg=name)
            np.testing.assert_array_equal(got.scales.numpy(), np.asarray(jw.scales[i]), err_msg=name)
            assert not np.array_equal(got.packed.numpy(), base.packed.numpy()), f"{name}: the adapter changed nothing"


# --- over a mesh against one process -------------------------------------------------


@pytest.mark.parametrize("tp,dp,accum,remat", [(1, 2, 1, False), (2, 1, 1, False), (2, 2, 2, True)],
                         ids=["dp2", "tp2", "dp2xtp2_accum2_remat"])
def test_mesh_gradients_are_the_single_device_gradients(ranks, tokens, tp, dp, accum, remat):
    """One SGD(1.0) step from a nonzero adapter (so every A and B has a
    gradient): the update gathered whole equals the one-process update on
    the same checkpoint (tp_shards = tp), not tp times it."""
    kw = dict(b_seed=3, accum_steps=accum, remat=remat, dtype=torch.float32)
    losses, got, _ = ranks.run(td.train_steps, CFG, 0, tokens, tp=tp, dp=dp, **kw)
    want_losses, want, _ = td.train_steps(None, CFG, 0, tokens, tp_shards=tp, **kw)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    _close(got, want, 1e-5)


def test_dp_masked_step_matches_the_jax_dp_step(ranks, tokens):
    """A masked loss at dp = 2: the mean of the two groups' masked means, as
    the JAX package defines it; the loss and the update against its dp
    step on ``make_mesh(dp=2)``."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    mask = (np.random.default_rng(2).random(tokens.shape) > 0.3).astype(np.float32)
    mask[2:, :10] = 0.0  # the second group weighs less
    losses, got, _ = ranks.run(td.train_steps, CFG, 0, tokens, loss_mask=mask, b_seed=3, dtype=torch.float32,
                               tp=1, dp=2)
    want_losses, want = _jax_step(tokens, b_seed=3, mesh=jax_mesh(dp=2), loss_mask=mask)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close(got, want, 1e-4)


def test_dp_adamw_and_accum_track_the_jax_step(ranks, tokens):
    """dp = 2 with AdamW for 3 steps, and dp = 2 with accum_steps 2, against
    the JAX package's single-device step on the same global batch
    (``tests/test_train.py``'s dp and accum-over-mesh cases)."""
    opt = dict(opt="adamw", lr=1e-2, steps=3, dtype=torch.float32)
    losses, _, _ = ranks.run(td.train_steps, CFG, 0, tokens, tp=1, dp=2, **opt)
    want, _ = _jax_step(tokens, opt=optax.adamw(1e-2), steps=3)
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    losses, _, _ = ranks.run(td.train_steps, CFG, 0, tokens, accum_steps=2, dtype=torch.float32, tp=1, dp=2)
    want, _ = _jax_step(tokens)
    np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_tp_loss_at_init_and_steps_track_single_device(ranks, tokens):
    """tp = 2 on the checkpoint repacked for 2: the loss of zero-B adapters
    is the JAX package's single-device loss of the base model; then 4 AdamW
    losses track its single-device training step for step."""
    losses, _, _ = ranks.run(td.train_steps, CFG, 0, tokens, opt="adamw", lr=1e-2, steps=4, dtype=torch.float32,
                             tp=2)
    base, _ = _jax_model(1)
    np.testing.assert_allclose(losses[0], float(jtrainer.lm_loss(base, None, JCFG, jnp.asarray(tokens))), rtol=1e-5)
    want, _ = _jax_step(tokens, opt=optax.adamw(1e-2), steps=4)
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_tp_shards_2_checkpoint_trains_on_one_device(tokens):
    """No mesh, a checkpoint packed for tp_shards 2 (the JAX package's tp = 1
    branch): the loss and the SGD update against the JAX step's."""
    losses, got, _ = td.train_steps(None, CFG, 0, tokens, tp_shards=2, b_seed=4, dtype=torch.float32)
    want_losses, want = _jax_step(tokens, tp_shards=2, b_seed=4)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close(got, want, 1e-4)


def test_the_reference_tp_gradients_are_tp_times_the_single_device_ones(tokens):
    """The JAX package's fault, kept on record: on the same checkpoint
    (repacked for 2) and the same zero-B adapters, its tp = 2 step's SGD(1.0)
    update of every B is twice its single-device one, at the same loss.
    The port's tp gradients are the single-device ones
    (:func:`test_mesh_gradients_are_the_single_device_gradients`)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    single_loss, single = _jax_step(tokens, tp_shards=2)
    tp_loss, tp = _jax_step(tokens, tp_shards=2, mesh=jax_mesh(tp=2))
    np.testing.assert_allclose(tp_loss, single_loss, rtol=1e-5)
    for f in FIELDS:
        names = [n for n in single if n.endswith(f"{f}.b")]
        ratio = np.linalg.norm([tp[n] for n in names]) / np.linalg.norm([single[n] for n in names])
        np.testing.assert_allclose(ratio, 2.0, rtol=1e-3, err_msg=f)


def test_tp_trained_adapter_merges_and_serves(ranks, tokens):
    """Two SGD steps at tp = 2, the adapters gathered and merged into the
    checkpoint packed for 2 (each weight keeps its shards), served over
    the mesh: every rank's tokens are those of the same merge served on
    one device."""
    prompts = [[3, 5, 7], [11, 13, 17, 19]]
    every, shards, whole = ranks.run(td.train_merge_serve, configs.TINY_TP, 0, tokens, prompts, 6, tp=2)
    assert shards == {"wqkv": 1, "wo": 2, "w_gateup": 1, "w_down": 2}
    assert all(e == every[0] for e in every)
    params, tcfg = td.tp_model(configs.TINY_TP, 0, 2)
    lora = td.adapters(tcfg, 4, 8.0)
    for n, p in lora.named_parameters():
        p.data = torch.from_numpy(whole[n])
    merged = merge_lora(params, lora, tcfg, method="oracle")
    eng = Engine(merged, tcfg, batch_size=2, eos_token=-1, device="cpu", cuda_graphs=False)
    assert every[0] == [r.tokens for r in eng.generate(prompts, max_new_tokens=6)]
