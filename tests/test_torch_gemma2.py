"""Gemma-2/3 in the port against nf4_tpu: attention softcaps, the four-norm
block, the final softcap, alternating local/global layers and Gemma-3's
local RoPE.

Attention: the port's naive, chunked and decode paths with a softcap, bf16
and int8 KV, with and without a window, against the JAX package's naive and
chunked attention on the same seeded inputs, within 2e-2 of the largest
output (the rounding of bf16 probabilities, as ``test_torch_attention.py``
states it).  Models: ``tiny-gemma2`` and a tiny Gemma-3 built by
``nf4_tpu.models.llama.init_params`` with every norm redrawn
(``test_torch_variants._redraw``: ``init_params`` draws ones, which would
hide an ignored field), prefill and decode logits within LOGIT_TOL and
greedy tokens under the teacher-forced rule of ``test_torch_variants.py``;
the Engine's greedy tokens against the JAX Engine's under the near-tie rule
of ``test_torch_engine.py``; packed checkpoints across the packages.
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
from nf4_tpu.ops import attention as jattn
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models import configs, llama, loader
from nf4_tpu_torch.models.convert import _tensor, config_from_dict, params_from_numpy
from nf4_tpu_torch.ops import attention as tattn
from nf4_tpu_torch.serve.engine import Engine

ATTN_TOL = 2e-2

# A tiny Gemma-3: five local layers (window 8, local RoPE at 10k unscaled)
# to one global (1M with linear x8 scaling), q/k head norms, no softcaps.
TINY_GEMMA3 = dataclasses.replace(
    jconfigs.TINY_GEMMA2, num_layers=6, attn_logit_softcapping=None, final_logit_softcapping=None,
    qk_norm=True, rope_theta=1e6, rope_local_theta=1e4, rope_scaling=("linear", 8.0), sliding_window=8,
    sliding_window_pattern=6,
)
# tiny-gemma2 with caps the tiny model's scores and logits reach, so that a
# port that ignored either would miss the JAX logits.
GEMMA2_LOW_CAPS = dataclasses.replace(jconfigs.TINY_GEMMA2, attn_logit_softcapping=2.0, final_logit_softcapping=1.5)


def _models(cfg, seed=0):
    params = _redraw(jllama.init_params(cfg, seed=seed), cfg, np.random.default_rng(seed + 100))
    tcfg = config_from_dict(config_to_dict(cfg))
    return cfg, params, tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _qkv(rng, b, h, kv, s, t, d, int8):
    """Seeded q [B, H, S, D] and a cache k, v [B, KV, T, D] (bf16, or int8
    with per-slot absmax scales), scaled so that scores reach the cap."""
    q = rng.standard_normal((b, h, s, d)).astype(np.float32) * 2.0
    k = rng.standard_normal((b, kv, t, d)).astype(np.float32) * 2.0
    v = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    as_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    if not int8:
        return as_bf16(q), as_bf16(k), as_bf16(v), None, None
    (k8, ks), (v8, vs) = jllama._quantize_kv(jnp.asarray(k)), jllama._quantize_kv(jnp.asarray(v))
    return as_bf16(q), k8, v8, ks, vs


def _to_torch(a):
    return None if a is None else _tensor(a, "cpu")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [None, 5])
def test_softcap_attention_matches_jax(int8, window):
    """Prefill (naive and chunked) and decode attention with a softcap of
    5 against the JAX package's naive and chunked paths."""
    rng = np.random.default_rng(3)
    cap, scale = 5.0, 32**-0.5
    b, h, kv, s, t, d = 2, 4, 2, 12, 20, 32
    q, k, v, ks, vs = _qkv(rng, b, h, kv, s, t, d, int8)
    pos = np.stack([np.arange(s) + 3, np.arange(s) + 8]).astype(np.int32)
    lens = pos[:, -1] + 1
    kw = dict(scale=scale, sliding_window=window, k_scale=ks, v_scale=vs, logit_softcap=cap)
    want = np.asarray(jattn.naive_attention(q, k, v, jnp.asarray(pos), jnp.asarray(lens), **kw), np.float32)
    want_c = np.asarray(jattn.chunked_attention(q, k, v, jnp.asarray(pos), jnp.asarray(lens), q_chunk=4, kv_chunk=8,
                                                **kw), np.float32)
    tq, tk, tv, tks, tvs = map(_to_torch, (q, k, v, ks, vs))
    tkw = dict(scale=scale, sliding_window=window, k_scale=tks, v_scale=tvs, logit_softcap=cap)
    tpos, tlens = torch.from_numpy(pos), torch.from_numpy(lens)
    limit = ATTN_TOL * np.abs(want).max()
    got = tattn.naive_attention(tq, tk, tv, tpos, tlens, **tkw).float().numpy()
    got_c = tattn.chunked_attention(tq, tk, tv, tpos, tlens, q_chunk=4, kv_chunk=8, **tkw).float().numpy()
    assert np.abs(got - want).max() <= limit and np.abs(got_c - want_c).max() <= limit
    assert np.abs(got_c - want).max() <= limit
    # Decode: each row's last query alone, over the cache.
    last = tattn.decode_attention(tq[:, :, -1:], tk, tv, tpos[:, -1:], tlens, **tkw).float().numpy()
    assert np.abs(last - want[:, :, -1:]).max() <= limit
    # The cap matters here: without it the outputs miss the JAX ones.
    free = tattn.naive_attention(tq, tk, tv, tpos, tlens, **{**tkw, "logit_softcap": None}).float().numpy()
    assert np.abs(free - want).max() > limit


def test_decode_softcap_masks_after_the_tanh():
    """Visible scores far below -cap: a mask added before the tanh would
    leave masked slots at -cap, close to the visible ones, and visible.  The
    port's decode attention matches the JAX naive path; the mask-first
    variant (computed here by hand) misses it."""
    rng = np.random.default_rng(7)
    cap, scale, d = 4.0, 1.0, 32
    b, h, kv, t = 1, 2, 1, 24
    qv = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=-1, keepdims=True)
    k = -qv[:, :1, :, :] * 40.0 + rng.standard_normal((b, kv, t, d)).astype(np.float32) * 0.05  # scores ~ -40
    v = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in (qv, k, v))
    pos = np.asarray([[9]], np.int32)
    lens = np.asarray([10], np.int32)
    want = np.asarray(jattn.naive_attention(q, k, v, jnp.asarray(pos), jnp.asarray(lens), scale=scale,
                                            logit_softcap=cap), np.float32)
    tq, tk, tv = map(_to_torch, (q, k, v))
    got = tattn.decode_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(lens), scale=scale,
                                 logit_softcap=cap).float().numpy()
    limit = ATTN_TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= limit
    # The bias first, then the cap: masked slots come back as -cap.
    sc = torch.einsum("bhd,btd->bht", tq[:, :, 0].float(), tk[:, 0].float()) * scale
    vis = torch.arange(t) < 10
    sc = torch.tanh(torch.where(vis, sc, torch.full_like(sc, -1e30)) / cap) * cap
    wrong = torch.einsum("bht,btd->bhd", torch.softmax(sc, -1).to(torch.bfloat16).float(), tv[:, 0].float())
    assert np.abs(wrong.numpy()[:, :, None] - want).max() > limit


def test_flash_dispatch_skips_softcapped_prefills(monkeypatch):
    """A softcapped prefill large enough for kernel C stays on the plain
    paths; without the cap the same call dispatches to kernel C."""
    calls = []
    monkeypatch.setattr(tattn, "_flash_eligible", lambda q, s, d: True)
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **k: calls.append(1) or "flash")
    monkeypatch.setattr(tattn, "_CHUNKED_MIN_SCORE_ELEMS", 1)
    q = torch.zeros((1, 2, 4, 32), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 8, 32), dtype=torch.bfloat16)
    pos, lens = torch.arange(4, dtype=torch.int32)[None], torch.full((1,), 4, dtype=torch.int32)
    out = tattn.attention(q, k, k, pos, lens, scale=1.0, logit_softcap=5.0)
    assert isinstance(out, torch.Tensor) and not calls
    assert tattn.attention(q, k, k, pos, lens, scale=1.0) == "flash" and calls == [1]


@pytest.mark.parametrize("name", ["tiny-gemma2", "tiny-gemma3"])
def test_gemma_prefill_and_decode_match_jax(name):
    """Prefill of 3 prompts of 24 tokens (longer than the local window) and
    4 greedy decode steps against the JAX model."""
    cfg = jconfigs.TINY_GEMMA2 if name == "tiny-gemma2" else TINY_GEMMA3
    cfg, params, tcfg, tparams = _models(cfg)
    assert PROMPT > cfg.sliding_window
    prefill, tokens, decode, want = _prefill_and_decode(cfg, params, tcfg, tparams, seed=1)
    np.testing.assert_allclose(prefill, want[:, :PROMPT], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(decode, want[:, PROMPT:], atol=LOGIT_TOL, rtol=0)
    _check_greedy(tokens, want[:, PROMPT - 1:])


def _without(tcfg, tparams, cfg_fields=None, drop=()):
    off_cfg = dataclasses.replace(tcfg, **(cfg_fields or {}))
    off = dataclasses.replace(tparams, layers=[dataclasses.replace(lp, **{n: None for n in drop})
                                               for lp in tparams.layers])
    return off_cfg, off


@pytest.mark.parametrize("field", [
    "attn_logit_softcapping", "final_logit_softcapping", "sliding_window_pattern", "post_norms", "rope_local_theta",
])
def test_each_gemma_field_matters(field):
    """The same weights with one field ignored (the cap off, every layer
    windowed, the output norms dropped, one RoPE for every layer) miss the
    JAX prefill logits by more than LOGIT_TOL, while the port with the
    field matches them."""
    cfg = TINY_GEMMA3 if field == "rope_local_theta" else GEMMA2_LOW_CAPS
    cfg, params, tcfg, tparams = _models(cfg, seed=2)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = np.asarray(jllama.prefill(params, cfg, jnp.asarray(toks))[0], np.float32)
    got, _ = llama.prefill(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)
    if field == "post_norms":
        off_cfg, off = _without(tcfg, tparams, drop=("post_attn_out_norm", "post_ffw_norm"))
    elif field == "sliding_window_pattern":
        off_cfg, off = _without(tcfg, tparams, {"sliding_window_pattern": 1})
    else:
        off_cfg, off = _without(tcfg, tparams, {field: None})
    miss, _ = llama.prefill(off, off_cfg, torch.from_numpy(toks))
    assert np.abs(miss.numpy() - want).max() > LOGIT_TOL, field


def test_layer_windows_and_tables():
    """Gemma-2: windows on even layers, none on odd ones; Gemma-3: the
    local layers' tables are the unscaled local theta's, the global
    layer's the scaled global ones, as the JAX package builds them."""
    g2, g3 = configs.GEMMA2_9B, config_from_dict(config_to_dict(TINY_GEMMA3))
    assert [llama._layer_window(g2, i) for i in range(4)] == [4096, None, 4096, None]
    want_w = np.asarray(jllama._layer_windows(jconfigs.GEMMA2_9B))
    assert all((w == 4096) == (llama._layer_window(g2, i) == 4096) for i, w in enumerate(want_w))
    assert [llama._layer_window(configs.MISTRAL_7B, i) for i in range(2)] == [4096, 4096]
    pos = np.arange(30, dtype=np.int32)[None]
    tables = llama._layer_tables(g3, torch.from_numpy(pos))
    local = jllama.local_rope_tables(TINY_GEMMA3, jnp.asarray(pos))
    glob = jllama.rope_tables(TINY_GEMMA3, jnp.asarray(pos))
    for i, (c, s) in enumerate(tables):
        wc, ws = local if i < 5 else glob
        np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=1e-5)


def test_gemma2_int8_mode_matches_jax():
    """tiny-gemma2 with int8-recoded weights and an int8 KV cache."""
    cfg, params, tcfg, tparams = _models(dataclasses.replace(jconfigs.TINY_GEMMA2, kv_quant=True))
    p8, t8 = jllama.recode_params_int8(params), llama.recode_params_int8(tparams)
    prefill, tokens, decode, want = _prefill_and_decode(cfg, p8, tcfg, t8, seed=3)
    np.testing.assert_allclose(prefill, want[:, :PROMPT], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(decode, want[:, PROMPT:], atol=LOGIT_TOL, rtol=0)
    _check_greedy(tokens, want[:, PROMPT - 1:])


@pytest.mark.parametrize("name", ["tiny-gemma2", "tiny-gemma3"])
def test_prefill_chunked_matches_jax(name):
    """``prefill_chunked`` in segments of 16 over 40-token prompts: the
    last-token logits and the cache against the JAX package's."""
    cfg = jconfigs.TINY_GEMMA2 if name == "tiny-gemma2" else TINY_GEMMA3
    cfg, params, tcfg, tparams = _models(cfg, seed=5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, wcache = jllama.prefill_chunked(params, cfg, jnp.asarray(toks), chunk=16)
    got, cache = llama.prefill_chunked(tparams, tcfg, torch.from_numpy(toks), chunk=16)
    assert got.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)
    whole, _ = llama.prefill(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), whole[:, -1].numpy(), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(cache.k[:, :, :, :40].float().numpy(), np.asarray(wcache.k[:, :, :, :40], np.float32),
                               atol=0.1, rtol=0.05)


def test_gemma2_engine_matches_jax_engine():
    """Greedy tokens of the port's Engine and the JAX Engine for
    tiny-gemma2: six prompts (two longer than the window) through two
    slots, decode chunks of 4, under the near-tie rule."""
    from test_torch_engine import _agree_until_near_tie, _teacher_forced

    cfg, params, tcfg, tparams = _models(jconfigs.TINY_GEMMA2)
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
def test_gemma_checkpoint_round_trip(tmp_path, ext):
    """A tiny Gemma-3 checkpoint (output norms, q/k norms) saved by nf4_tpu
    and loaded by the port, and back: the same leaves, bit for bit, and the
    JAX model's logits."""
    cfg, params, tcfg, tparams = _models(TINY_GEMMA3, seed=7)
    path = str(tmp_path / f"gemma.{ext}")
    jloader.save_packed(path, params, cfg)
    got, got_cfg = loader.load_packed_auto(path, device="cpu")
    assert got_cfg == tcfg
    names = ("post_attn_out_norm", "post_ffw_norm", "q_norm", "k_norm", "input_norm", "post_attn_norm")
    for a, b in zip(got.layers, tparams.layers):
        for name in names:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    back = str(tmp_path / f"back.{ext}")
    loader.save_packed(back, got, got_cfg)
    jp, _ = jloader.load_packed_auto(back)
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(jp.layers, name)), np.asarray(getattr(params.layers, name)))
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jllama.prefill(params, cfg, jnp.asarray(toks))
    lt, _ = llama.prefill(got, got_cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


def test_training_gemma_raises():
    """Training on Gemma-2/3 is not ported yet; serving is."""
    from nf4_tpu_torch.train import make_train_step

    for name in ("tiny-gemma2", "gemma3-4b"):
        with pytest.raises(NotImplementedError, match="not ported yet: training with"):
            make_train_step(configs.get_config(name), torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0))
