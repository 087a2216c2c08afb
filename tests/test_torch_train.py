"""The port's QLoRA fine-tuning slice against nf4_tpu's.

The JAX package's TINY_TEST model (quantized by ``init_params``) goes
through the weight bridge, and the same seeded inputs run through both
packages:

* kernel E's plain version against the JAX exact kernel in interpret mode:
  fp32 out within 2e-5 (``tests/test_matmul.py``'s tolerance: the same
  fp32 values summed in another order), fp16 out within 2e-3 of the
  largest value (one fp16 rounding);
* the ``nf4_matmul`` gradient against ``jax.grad`` within 1e-4 (fp32 sums
  in another order);
* ``train_forward`` logits for a packed batch with a nonzero adapter: bf16
  within LOGIT_TOL = 0.2 (``tests/test_torch_llama.py``'s reason: the port's
  bf16 projections round each weight value to bf16, the JAX CPU path keeps
  fp32), fp32 within 1e-4 (both fp32 throughout);
* loss and adapter gradients at fp32 against ``jax.value_and_grad``: loss
  within 1e-5 relative, each gradient within 1e-4 of its largest value;
* one SGD(1.0) step against ``optax.sgd(1.0)`` (the adapters, as the
  gradients), and three AdamW losses against ``optax.adamw`` within 1e-4
  relative (Adam's first steps move near-zero gradients by about lr
  times their sign, so the adapters themselves are not compared);
* ``init_lora``'s A, the ``pad_sft``/``pack_sft`` arrays and adapter files
  written by either package: bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nf4_tpu
import nf4_tpu_torch
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.nf4.reference import quantize_nf4
from nf4_tpu.train import data as jdata
from nf4_tpu.train import lora as jlora
from nf4_tpu.train import trainer as jtrainer
from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.convert import config_from_dict, lora_from_numpy, params_from_numpy
from nf4_tpu_torch.train import (
    LoraConfig, data, init_lora, lm_loss, load_lora, load_train_state, make_train_step, save_lora,
    save_train_state,
)

LOGIT_TOL = 0.2
LCFG = LoraConfig(rank=4, alpha=8.0)


def _pair(rng, shape, shards=1, quant_type="nf4"):
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    state = quantize_nf4(w, quant_type=quant_type)
    return (
        nf4_tpu.pack_for_tpu(state, dtype=jnp.float32, shards=shards),
        nf4_tpu_torch.pack_for_tpu(state, dtype=torch.float32, shards=shards, device="cpu"),
    )


@pytest.mark.parametrize("shape", [(256, 1024), (100, 320)])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("xdt", ["fp32", "fp16"])
def test_exact_plain_matches_jax_exact_kernel(rng, monkeypatch, shape, quant_type, xdt):
    """Kernel E's plain version against ``_matmul_pallas_exact`` in
    interpret mode (NF4TPU_BACKEND=pallas on the CPU)."""
    monkeypatch.setenv("NF4TPU_BACKEND", "pallas")
    pj, pt = _pair(rng, shape, quant_type=quant_type)
    x = rng.standard_normal((37, shape[1])).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if xdt == "fp32" else (jnp.float16, torch.float16)
    want = np.asarray(nf4_tpu.nf4_matmul(jnp.asarray(x, jdt), pj), np.float32)
    got = nf4_tpu_torch.nf4_matmul(torch.from_numpy(x).to(tdt), pt)
    assert got.dtype == tdt and got.shape == (37, shape[0])
    if xdt == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("xdt", ["fp32", "bf16", "fp16"])
def test_matmul_grad_matches_jax(rng, shards, xdt):
    """``dx = g @ W`` in fp32, cast to x's dtype; the packed bytes and the
    scales get no gradient.  shards=2 sums the chunks' gradients."""
    shape = (128, 2048) if shards > 1 else (256, 384)
    pj, pt = _pair(rng, shape, shards)
    x = (rng.standard_normal((4, shape[1])) * 0.1).astype(np.float32)
    g = rng.standard_normal((4, shape[0])).astype(np.float32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
                "fp16": (jnp.float16, torch.float16)}[xdt]
    xj = jnp.asarray(x, jdt)
    want = jax.grad(lambda x: (nf4_tpu.nf4_matmul(x, pj).astype(jnp.float32) * g).sum())(xj)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    (nf4_tpu_torch.nf4_matmul(xt, pt).float() * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == tdt and not pt.packed.requires_grad and pt.scales.grad is None
    tol = 1e-4 if xdt == "fp32" else 1e-2
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_backward_product_is_full_fp32_under_any_precision_setting(rng):
    """The backward's product runs at "highest" even when the caller set
    "high" (TF32 on a card), and the caller's setting comes back after."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
                seen.append(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

    _, pt = _pair(rng, (128, 1024))
    x = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32)).requires_grad_()
    y = nf4_tpu_torch.nf4_matmul(x, pt)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with Record():
            y.sum().backward()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest"]
    want = torch.ones(3, 128) @ nf4_tpu_torch.dequantize(pt, torch.float32)
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)


# --- the model ---------------------------------------------------------------

@pytest.fixture(scope="module", params=["bf16", "fp32"])
def models(request):
    dt = {"bf16": jnp.bfloat16, "fp32": jnp.float32}[request.param]
    cfg = dataclasses.replace(jconfigs.TINY_TEST, dtype=dt)
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return request.param, cfg, params, tcfg, tparams


def _examples(seed, n=5, vocab=256):
    rng = np.random.default_rng(seed)
    return [
        (list(rng.integers(1, vocab, int(rng.integers(2, 6)))), list(rng.integers(1, vocab, int(rng.integers(3, 9)))))
        for _ in range(n)
    ]


def _batch(seed=3, seq_len=32):
    b = jdata.pack_sft(_examples(seed), seq_len)
    jb = [jnp.asarray(a) for a in (b.tokens, b.loss_mask, b.positions, b.segment_ids)]
    tb = [torch.from_numpy(np.array(a)) for a in (b.tokens, b.loss_mask, b.positions, b.segment_ids)]
    return jb, tb


def _adapters(cfg, seed=0, b_scale=0.05):
    """The same adapter pair in both packages: init_lora's A and a random B
    (so the delta is not zero)."""
    jl = jlora.init_lora(cfg, jlora.LoraConfig(rank=LCFG.rank, alpha=LCFG.alpha), seed=seed)
    rng = np.random.default_rng(seed + 100)
    fields = {}
    for f in ("qkv", "o", "gateup", "down"):
        ab = getattr(jl.layers, f)
        b = (rng.standard_normal(ab.b.shape) * b_scale).astype(np.float32)
        fields[f] = ab.replace(b=jnp.asarray(b))
    jl = jl.replace(layers=jl.layers.replace(**fields))
    return jl, lora_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")


def test_train_forward_logits_match_packed_batch(models):
    kind, cfg, params, tcfg, tparams = models
    jl, tl = _adapters(cfg)
    (tok, _, pos, seg), (ttok, _, tpos, tseg) = _batch()
    want = np.asarray(jllama.train_forward(params, cfg, tok, lora=jl, positions=pos, segment_ids=seg))
    got = llama.train_forward(tparams, tcfg, ttok, lora=tl, positions=tpos, segment_ids=tseg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = LOGIT_TOL if kind == "bf16" else 1e-4
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


def test_forward_with_lora_matches_jax(models):
    """The inference forward with an unmerged adapter (``forward(lora=)``)."""
    kind, cfg, params, tcfg, tparams = models
    jl, tl = _adapters(cfg, seed=1)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    lens = np.full(2, 12, np.int32)
    want, _ = jllama.forward(params, cfg, jnp.asarray(toks), jllama.init_kv_cache(cfg, 2), jnp.asarray(pos),
                             jnp.asarray(lens), lora=jl)
    got, _ = llama.forward(tparams, tcfg, torch.from_numpy(toks), llama.init_kv_cache(tcfg, 2, device="cpu"),
                           torch.from_numpy(pos), torch.from_numpy(lens), lora=tl)
    tol = LOGIT_TOL if kind == "bf16" else 1e-4
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def fp32_models():
    cfg = dataclasses.replace(jconfigs.TINY_TEST, dtype=jnp.float32)
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    return cfg, params, tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _grads(tl):
    return {f"{i}.{n}": p.grad.numpy().copy() for i, ll in enumerate(tl.layers) for n, p in ll.named_parameters()}


def _jax_by_name(jtree):
    """Leaves of a JAX LoraParams-shaped tree by the port's parameter names."""
    out = {}
    for f in ("qkv", "o", "gateup", "down"):
        ab = getattr(jtree.layers, f)
        for side in ("a", "b"):
            arr = np.asarray(getattr(ab, side))
            for i in range(arr.shape[0]):
                out[f"{i}.{f}.{side}"] = arr[i]
    return out


def test_loss_and_adapter_grads_match_jax_fp32(fp32_models):
    cfg, params, tcfg, tparams = fp32_models
    jl, tl = _adapters(cfg, seed=2)
    (tok, mask, pos, seg), (ttok, tmask, tpos, tseg) = _batch(seed=5)
    loss_j, grads_j = jax.value_and_grad(
        lambda lo: jtrainer.lm_loss(params, lo, cfg, tok, mask, positions=pos, segment_ids=seg)
    )(jl)
    loss_t = lm_loss(tparams, tl, tcfg, ttok, tmask, positions=tpos, segment_ids=tseg)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = _jax_by_name(grads_j)
    got = _grads(tl)
    assert set(got) == set(want)
    for name in got:
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-4 * scale, rtol=0, err_msg=name)


def test_sgd_step_matches_optax(fp32_models):
    cfg, params, tcfg, tparams = fp32_models
    jl, tl = _adapters(cfg, seed=3)
    (tok, mask, pos, seg), (ttok, tmask, tpos, tseg) = _batch(seed=6)
    opt = optax.sgd(1.0)
    jstep = jtrainer.make_train_step(cfg, opt)
    jl1, _, jloss = jstep(params, jl, opt.init(jl), tok, mask, pos, seg)
    step = make_train_step(tcfg, torch.optim.SGD(tl.parameters(), lr=1.0))
    loss = step(tparams, tl, ttok, tmask, tpos, tseg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _jax_by_name(jl1)
    before = _jax_by_name(jl)
    for name, p in ((f"{i}.{n}", p) for i, ll in enumerate(tl.layers) for n, p in ll.named_parameters()):
        # The update is the gradient: compare it at the gradient's scale.
        scale = np.abs(want[name] - before[name]).max()
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-4 * scale + 1e-7, rtol=0, err_msg=name)


def test_adamw_losses_match_optax(fp32_models):
    cfg, params, tcfg, tparams = fp32_models
    jl, tl = _adapters(cfg, seed=4)
    (tok, mask, pos, seg), (ttok, tmask, tpos, tseg) = _batch(seed=7)
    opt = optax.adamw(1e-2)
    jstep = jtrainer.make_train_step(cfg, opt)
    jstate = opt.init(jl)
    step = make_train_step(tcfg, torch.optim.AdamW(tl.parameters(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                                                   weight_decay=1e-4))
    for _ in range(3):
        jl, jstate, jloss = jstep(params, jl, jstate, tok, mask, pos, seg)
        loss = step(tparams, tl, ttok, tmask, tpos, tseg)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)


def test_remat_gives_the_same_grads(fp32_models):
    _, _, tcfg, tparams = fp32_models
    (_, _, _, _), (ttok, tmask, tpos, tseg) = _batch(seed=8)
    grads = []
    for remat in (False, True):
        tl = init_lora(tcfg, LCFG, seed=0, device="cpu")
        for ll in tl.layers:  # a nonzero B, so A gets a gradient too
            for ab in (ll.qkv, ll.o, ll.gateup, ll.down):
                ab.b.data.fill_(0.01)
        lm_loss(tparams, tl, tcfg, ttok, tmask, remat=remat, positions=tpos, segment_ids=tseg).backward()
        grads.append(_grads(tl))
    for name in grads[0]:
        torch.testing.assert_close(torch.from_numpy(grads[1][name]), torch.from_numpy(grads[0][name]),
                                   rtol=1e-6, atol=1e-7)


def test_accum_steps_equal_the_full_batch(fp32_models):
    """accum_steps=2 averages two microbatch gradients: one SGD(1.0) step
    moves the adapters by the full batch's gradient (unmasked batch, so
    the mean of microbatch means is the batch mean)."""
    _, _, tcfg, tparams = fp32_models
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, tcfg.vocab_size, (4, 16)).astype(np.int32))
    after, losses = [], []
    for accum in (1, 2):
        tl = init_lora(tcfg, LCFG, seed=0, device="cpu")
        step = make_train_step(tcfg, torch.optim.SGD(tl.parameters(), lr=1.0), accum_steps=accum)
        losses.append(step(tparams, tl, toks).item())
        after.append({n: p.detach().clone() for n, p in tl.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for name in after[0]:
        torch.testing.assert_close(after[1][name], after[0][name], rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="divide"):
        make_train_step(tcfg, torch.optim.SGD(tl.parameters(), lr=1.0), accum_steps=3)(tparams, tl, toks)


def test_mesh_and_tp_wait_for_multi_gpu(fp32_models):
    _, _, tcfg, _ = fp32_models
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        make_train_step(tcfg, opt, mesh=object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        make_train_step(dataclasses.replace(tcfg, tp_shards=2), opt)


def test_fp16_train_forward_runs_and_matches(rng):
    """cfg.dtype fp16 runs the whole training forward (kernel E's path on a
    card) and agrees with the JAX package within LOGIT_TOL."""
    cfg = dataclasses.replace(jconfigs.TINY_TEST, dtype=jnp.float16)
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jl, tl = _adapters(cfg, seed=5)
    (tok, _, pos, seg), (ttok, _, tpos, tseg) = _batch(seed=10)
    want = np.asarray(jllama.train_forward(params, cfg, tok, lora=jl, positions=pos, segment_ids=seg))
    got = llama.train_forward(tparams, tcfg, ttok, lora=tl, positions=tpos, segment_ids=tseg)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL, rtol=0)


# --- adapters, data, state ----------------------------------------------------

def test_init_lora_bit_identical_to_jax():
    cfg = jconfigs.TINY_TEST
    lcfg = LoraConfig(rank=4, alpha=8.0, targets=("wqkv", "w_down"))
    jl = jlora.init_lora(cfg, jlora.LoraConfig(rank=4, alpha=8.0, targets=("wqkv", "w_down")), seed=7)
    tl = init_lora(config_from_dict(config_to_dict(cfg)), lcfg, seed=7, device="cpu")
    assert tl.layers[0].o is None and tl.layers[0].gateup is None
    for f in ("qkv", "down"):
        ja = np.asarray(getattr(jl.layers, f).a)
        ta = np.stack([getattr(ll, f).a.detach().numpy() for ll in tl.layers])
        np.testing.assert_array_equal(ta.view(np.uint32), ja.view(np.uint32))
        assert not np.any(np.stack([getattr(ll, f).b.detach().numpy() for ll in tl.layers]))
        assert getattr(tl.layers[1], f).scaling == getattr(jl.layers, f).scaling == 2.0
    assert tl.num_params == jl.num_params


def test_adapter_files_cross_packages(tmp_path):
    cfg = jconfigs.TINY_TEST
    jl, tl = _adapters(cfg, seed=6)
    lcfg = LoraConfig(rank=LCFG.rank, alpha=LCFG.alpha)
    # The port writes, the JAX package reads.
    save_lora(str(tmp_path / "port.npz"), tl, lcfg)
    back, jcfg = jlora.load_lora(str(tmp_path / "port.npz"))
    assert (jcfg.rank, jcfg.alpha, jcfg.targets) == (lcfg.rank, lcfg.alpha, lcfg.targets)
    # The JAX package writes, the port reads.
    jlora.save_lora(str(tmp_path / "jax.npz"), jl, jcfg)
    tl2, lcfg2 = load_lora(str(tmp_path / "jax.npz"), device="cpu")
    assert lcfg2 == lcfg and tl2.tp_basis == 1
    for f in ("qkv", "o", "gateup", "down"):
        for side in ("a", "b"):
            ref = np.asarray(getattr(getattr(jl.layers, f), side))
            np.testing.assert_array_equal(np.asarray(getattr(getattr(back.layers, f), side)), ref)
            got = np.stack([getattr(getattr(ll, f), side).detach().numpy() for ll in tl2.layers])
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fn", ["pad_sft", "pack_sft"])
def test_sft_batches_identical_to_jax(fn):
    ex = _examples(11, n=9)
    want = getattr(jdata, fn)(ex, 24, pad_id=3)
    got = getattr(data, fn)(ex, 24, pad_id=3)
    for field in ("tokens", "loss_mask", "positions", "segment_ids"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.spans == want.spans and got.efficiency == want.efficiency
    with pytest.raises(ValueError, match="empty prompt"):
        getattr(data, fn)([([], [1])], 8)


def test_resumed_run_equals_uninterrupted(fp32_models, tmp_path):
    _, _, tcfg, tparams = fp32_models
    (_, _, _, _), (ttok, tmask, tpos, tseg) = _batch(seed=12)

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-4)

    tl = init_lora(tcfg, LCFG, seed=0, device="cpu")
    opt = adamw(tl.parameters())
    step = make_train_step(tcfg, opt)
    for _ in range(2):
        step(tparams, tl, ttok, tmask, tpos, tseg)
    path = str(tmp_path / "run.npz")
    save_train_state(path, tl, LCFG, opt, step=2)
    want = [step(tparams, tl, ttok, tmask, tpos, tseg).item() for _ in range(2)]

    tl2, lcfg2, opt2, at = load_train_state(path, adamw, device="cpu")
    assert lcfg2 == LCFG and at == 2
    step2 = make_train_step(tcfg, opt2)
    got = [step2(tparams, tl2, ttok, tmask, tpos, tseg).item() for _ in range(2)]
    assert got == want
    # The adapter half is an adapter file of either package.
    jl, _ = jlora.load_lora(path + ".lora.npz")
    assert np.asarray(jl.layers.qkv.a).shape == (tcfg.num_layers, LCFG.rank, tcfg.hidden_size)
