"""QLoRA training of the families that serve, in the port against nf4_tpu:
Gemma-2 (attention and final softcaps, alternating windows, four-norm
blocks), Gemma-3 (local layers' own RoPE, q/k norms, windows) and MoE
(attention-only LoRA over frozen packed experts).

Tiny models (``tiny-gemma2`` with caps its scores reach, a tiny Gemma-3,
``tiny-moe``) at fp32, their norms redrawn (``test_torch_variants._redraw``)
so an ignored field shows, go through the weight bridge; the same adapter
(``init_lora``'s A, a seeded B) and a packed batch whose examples outrun the
windows go through both packages.  Loss within 1e-5 relative and every
adapter gradient within 1e-4 of its largest value against
``jax.value_and_grad`` (``test_torch_train.py``'s tolerances: fp32 sums in
another order); each family's distinguishing field moves the loss by far
more than that, so the parity shows the field is trained through.  A
Gemma-2 adapter trained by ``make_train_step`` then serves from a bank,
held to the JAX ``Engine(lora_bank=)`` under ``test_torch_engine.py``'s
near-tie rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gemma2 import GEMMA2_LOW_CAPS, TINY_GEMMA3
from test_torch_multi_lora import _held_to_jax
from test_torch_train import _grads
from test_torch_variants import _redraw

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu.train import data as jdata
from nf4_tpu.train import lora as jlora
from nf4_tpu.train import trainer as jtrainer
from nf4_tpu_torch.models.convert import config_from_dict, lora_from_numpy, params_from_numpy
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.train import lm_loss, load_lora, make_train_step, save_lora
from _torch_threads import _one_thread  # noqa: F401

ATTN = ("wqkv", "wo")
FAMILIES = {  # name: (config, LoRA targets, a field the loss must depend on)
    "gemma2": (GEMMA2_LOW_CAPS, jlora._TARGETS, dict(attn_logit_softcapping=None)),
    "gemma2-window": (GEMMA2_LOW_CAPS, jlora._TARGETS, dict(sliding_window=64)),
    "gemma3": (TINY_GEMMA3, jlora._TARGETS, dict(rope_local_theta=None)),
    "moe": (jconfigs.TINY_MOE, ATTN, dict(experts_per_token=1)),
}


def _models(cfg, seed=0):
    cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    params = _redraw(jllama.init_params(cfg, seed=seed), cfg, np.random.default_rng(seed + 100))
    tcfg = config_from_dict(config_to_dict(cfg))
    return cfg, params, tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _adapter(cfg, targets, seed=2):
    jl = jlora.init_lora(cfg, jlora.LoraConfig(rank=4, alpha=8.0, targets=targets), seed=seed)
    rng = np.random.default_rng(seed + 100)
    fields = {f: getattr(jl.layers, f) for f in ("qkv", "o", "gateup", "down")}
    fields = {f: None if ab is None else ab.replace(b=jnp.asarray((rng.standard_normal(ab.b.shape) * 0.05)
                                                                  .astype(np.float32)))
              for f, ab in fields.items()}
    jl = jl.replace(layers=jl.layers.replace(**fields))
    return jl, lora_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")


def _jax_by_name(jtree):
    """Leaves of a JAX LoraParams-shaped tree by the port's parameter names
    (adapted projections only)."""
    out = {}
    for f in ("qkv", "o", "gateup", "down"):
        ab = getattr(jtree.layers, f)
        for side in ("a", "b") if ab is not None else ():
            arr = np.asarray(getattr(ab, side))
            out.update({f"{i}.{f}.{side}": arr[i] for i in range(arr.shape[0])})
    return out


def _batch(seed=3):
    """A packed batch of 2 x 64 slots whose examples (20-35 tokens) outrun
    the tiny models' windows (16, 8)."""
    rng = np.random.default_rng(seed)
    examples = [(list(rng.integers(1, 256, int(rng.integers(5, 10)))),
                 list(rng.integers(1, 256, int(rng.integers(15, 25))))) for _ in range(4)]
    b = jdata.pack_sft(examples, 64)
    arrays = (b.tokens, b.loss_mask, b.positions, b.segment_ids)
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_adapter_grads_match_jax(family):
    base, targets, other = FAMILIES[family]
    cfg, params, tcfg, tparams = _models(base)
    jl, tl = _adapter(cfg, targets)
    (tok, mask, pos, seg), (ttok, tmask, tpos, tseg) = _batch()
    loss_j, grads_j = jax.value_and_grad(
        lambda lo: jtrainer.lm_loss(params, lo, cfg, tok, mask, positions=pos, segment_ids=seg))(jl)
    loss_t = lm_loss(tparams, tl, tcfg, ttok, tmask, positions=tpos, segment_ids=tseg)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want, got = _jax_by_name(grads_j), _grads(tl)
    assert set(got) == set(want) and {k.split(".")[1] for k in got} == {jlora._TARGET_FIELD[t] for t in targets}
    for name in got:
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-4 * scale, rtol=0, err_msg=name)
    # The family's field is trained through: without it the loss moves.
    changed = lm_loss(tparams, tl, dataclasses.replace(tcfg, **other), ttok, tmask, positions=tpos,
                      segment_ids=tseg)
    assert abs(changed.item() - loss_t.item()) > 1e-3 * abs(loss_t.item()), (family, other)


@pytest.mark.parametrize("family", ["gemma2", "moe"])
def test_remat_and_train_step_run(family):
    """``make_train_step`` trains the family: remat gives the step's loss,
    two SGD steps lower it, the adapters stay finite."""
    base, targets, _ = FAMILIES[family]
    _, _, tcfg, tparams = _models(base)
    _, tl = _adapter(base, targets)
    _, (ttok, tmask, tpos, tseg) = _batch(seed=4)
    step = make_train_step(tcfg, torch.optim.SGD(tl.parameters(), lr=0.5), remat=True)
    plain = lm_loss(tparams, tl, tcfg, ttok, tmask, positions=tpos, segment_ids=tseg).item()
    losses = [step(tparams, tl, ttok, tmask, tpos, tseg).item() for _ in range(3)]
    np.testing.assert_allclose(losses[0], plain, rtol=1e-6)
    assert losses[2] < losses[0] and all(torch.isfinite(p).all() for p in tl.parameters())


def test_trained_gemma2_adapter_serves_from_a_bank(tmp_path):
    """A Gemma-2 adapter trained by the port, written with ``save_lora`` and
    read back by both packages, serves from a bank (beside the base)
    against the JAX Engine over the same bank."""
    cfg32, _, tcfg32, tparams32 = _models(jconfigs.TINY_GEMMA2)
    _, tl = _adapter(cfg32, jlora._TARGETS)
    _, (ttok, tmask, tpos, tseg) = _batch(seed=5)
    step = make_train_step(tcfg32, torch.optim.SGD(tl.parameters(), lr=0.5))
    for _ in range(2):
        step(tparams32, tl, ttok, tmask, tpos, tseg)
    path = str(tmp_path / "gemma2.npz")
    save_lora(path, tl, jlora.LoraConfig(rank=4, alpha=8.0))
    tl2, _ = load_lora(path, device="cpu")
    jl, _ = jlora.load_lora(path)
    cfg = jconfigs.TINY_GEMMA2  # served in bf16
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jbank = jlora.stack_adapters([jl])
    prompts, adapters = [[5, 6, 7, 8, 9], [11, 3, 2], [4, 4, 1, 9, 9, 9, 2]], [0, None, 0]
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4, lora_bank=jbank).generate(
        prompts, max_new_tokens=6, adapter=adapters)
    got = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu", lora_bank=[tl2]).generate(
        prompts, max_new_tokens=6, adapter=adapters)
    _held_to_jax(cfg, params, jbank, adapters, got, want)
    base = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu").generate(
        prompts, max_new_tokens=6)
    assert got[1].tokens == base[1].tokens
