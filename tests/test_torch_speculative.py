"""The port's speculative functions (``nf4_tpu_torch/serve/speculative.py``)
against the JAX package's, and the verify forward on the CPU.

``propose_ngram`` is the JAX package's NumPy code and must give the same
drafts; ``draft_ngram_device`` the JAX device drafter's on the same
histories, each row as it is alone.  ``spec_verify`` on the same converted
weights, cache and drafts: its logprobs within ``LOGIT_TOL`` of the JAX
ones, its targets equal wherever the JAX top-2 logit gap exceeds that
tolerance, and its accept counts equal where the targets agree up to the
verdict.  The verify
forward (``forward(decode=True)``) gives each position the logits S single
decode steps give it, within the same tolerance (bf16 activations summed
in another shape), and the same bits at every ``kv_len`` past its
positions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve import speculative as jspec
from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy
from nf4_tpu_torch.serve import speculative as spec

LOGIT_TOL = 0.2  # test_torch_engine.py's: the port rounds weights to bf16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params) of TINY_TEST."""
    cfg = jconfigs.TINY_TEST
    params = jllama.init_params(cfg, seed=0)
    tcfg = config_from_dict(config_to_dict(cfg))
    return cfg, params, tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


@pytest.mark.parametrize("ctx, k, want", [
    ([1, 2, 5, 6, 7, 8, 9, 3, 4, 5, 6, 7], 2, [8, 9]),  # a repeated trigram
    ([9, 1, 9, 2, 9], 1, [2]),  # the last earlier occurrence wins
    ([3, 7, 1, 2, 3], 1, [7]),  # down to a unigram
    ([1, 2, 3, 4], 3, [4, 4, 4]),  # no match: the last token
    ([5, 6, 9, 5, 6], 4, [9, 5, 6, 6]),  # a short continuation padded
    ([], 2, [0, 0]),
    ([7], 2, [7, 7]),
])
def test_propose_ngram_cases(ctx, k, want):
    got = spec.propose_ngram(ctx, k)
    assert got.dtype == np.int32 and got.tolist() == want
    assert got.tolist() == jspec.propose_ngram(ctx, k).tolist()


def test_propose_ngram_equals_jax_on_random_contexts():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ctx = rng.integers(0, 6, rng.integers(0, 40)).tolist()
        k, ngram = int(rng.integers(1, 8)), int(rng.integers(1, 5))
        assert spec.propose_ngram(ctx, k, ngram).tolist() == jspec.propose_ngram(ctx, k, ngram).tolist()


@pytest.mark.parametrize("ngram", [1, 2, 3, 4])
def test_draft_ngram_device_equals_jax(ngram):
    """Seeded histories with stale tails (random tokens past each row's
    length, as a chunk leaves them): the JAX drafter's drafts, and each
    row's drafts are the row's alone."""
    rng = np.random.default_rng(ngram)
    b, s_len, k = 6, 48, 5
    hist = rng.integers(0, 5, (b, s_len)).astype(np.int32)
    hlen = np.asarray([1, 2, 7, 20, 33, 48], np.int32)
    got = spec.draft_ngram_device(torch.from_numpy(hist), torch.from_numpy(hlen), k, ngram)
    assert got.dtype == torch.int32 and got.shape == (b, k)
    want = np.asarray(jspec.draft_ngram_device(jnp.asarray(hist), jnp.asarray(hlen), k, ngram))
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(b):
        alone = spec.draft_ngram_device(torch.from_numpy(hist[r : r + 1]), torch.from_numpy(hlen[r : r + 1]), k, ngram)
        np.testing.assert_array_equal(alone.numpy()[0], got.numpy()[r])


@pytest.mark.parametrize("ctx", [[1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3], [5, 6, 7, 8, 9, 10], [3, 3, 3, 3, 3],
                                 [1, 2], [4, 9, 4, 9, 4]])
def test_draft_ngram_device_matches_the_host_drafter(ctx):
    """Where the continuation is whole, the device drafter proposes what
    ``propose_ngram`` does (the JAX package's test cases)."""
    hist = np.zeros((1, 32), np.int32)
    hist[0, : len(ctx)] = ctx
    got = spec.draft_ngram_device(torch.from_numpy(hist), torch.tensor([len(ctx)], dtype=torch.int32), 5, 3)
    assert got[0].tolist() == spec.propose_ngram(ctx, 5, 3).tolist()


def _prefilled(model, prompts):
    """Both packages' caches with ``prompts`` (equal lengths) prefilled."""
    cfg, params, tcfg, tparams = model
    toks = np.asarray(prompts, np.int32)
    jcache = jllama.init_kv_cache(cfg, len(prompts))
    _, jcache = jllama.prefill(params, cfg, jnp.asarray(toks), jcache)
    cache = llama.init_kv_cache(tcfg, len(prompts), device="cpu")
    llama.prefill(tparams, tcfg, torch.from_numpy(toks), cache)
    return jcache, cache


def _port_fwd(tcfg, kv_len=None):
    def fwd(params, tokens, cache, positions, seq_lens):
        return llama.forward(params, tcfg, tokens, cache, positions, seq_lens, kv_len=kv_len, decode=True)
    return fwd


def _jax_fwd(cfg):
    def fwd(params, tokens, cache, positions, seq_lens):
        return jllama.forward(params, cfg, tokens, cache, positions, seq_lens)
    return fwd


def test_spec_verify_against_jax(model):
    """The same drafts (the JAX targets, one broken per row at another
    position) on the same prefilled caches: logprobs within LOGIT_TOL,
    targets equal where JAX's choice is clear, accept counts equal."""
    cfg, params, tcfg, tparams = model
    rng = np.random.default_rng(3)
    k, b = 4, 3
    prompts = rng.integers(0, cfg.vocab_size, (b, 9)).tolist()
    jcache, cache = _prefilled(model, prompts)
    pos = np.full(b, 9, np.int32)
    # The JAX model's greedy continuation: the first token (at position 9)
    # from the prompt's logits, then k drafts that all match, the JAX
    # verify's targets fed back one position at a time.
    logits, _ = jllama.prefill(params, cfg, jnp.asarray(prompts, jnp.int32))
    cur = np.array(jnp.argmax(logits[:, -1], -1), np.int32)  # a writable copy
    jverify = jax.jit(functools.partial(jspec.spec_verify, fwd=_jax_fwd(cfg), k=k))
    drafts = np.zeros((b, k), np.int32)
    for i in range(k):
        drafts[:, i] = np.asarray(jverify(params, jnp.asarray(cur), jnp.asarray(drafts), jcache, jnp.asarray(pos))[0])[:, i]
    for r, at in enumerate((1, 3, k)):  # row 2 keeps every draft
        if at < k:
            drafts[r, at] = (drafts[r, at] + 1) % cfg.vocab_size
    jt, ja, jlp, _ = jverify(params, jnp.asarray(cur), jnp.asarray(drafts), jcache, jnp.asarray(pos))
    t, a, lp, _ = spec.spec_verify(tparams, torch.from_numpy(cur), torch.from_numpy(drafts), cache,
                                   torch.from_numpy(pos), fwd=_port_fwd(tcfg), k=k)
    assert t.dtype == torch.int32 and a.dtype == torch.int32 and t.shape == (b, k + 1) and lp.shape == (b, k + 1)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=LOGIT_TOL)
    logits, _ = jax.jit(_jax_fwd(cfg))(params, jnp.asarray(np.concatenate([cur[:, None], drafts], 1)), jcache,
                                       jnp.asarray(pos[:, None] + np.arange(k + 1)), jnp.asarray(pos + k + 1))
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > LOGIT_TOL
    np.testing.assert_array_equal(t.numpy()[clear], np.asarray(jt)[clear])
    assert np.asarray(ja).tolist() == [1, 3, k]
    for r in range(b):
        differ = np.flatnonzero(t.numpy()[r] != np.asarray(jt)[r])
        first = int(differ[0]) if differ.size else k + 1
        if first > int(ja[r]):  # the targets agree up to the verdict: so does the count
            assert int(a[r]) == int(ja[r]), r


def test_verify_forward_equals_single_decode_steps(model):
    """The verify forward's logits at each of its S positions against S
    single decode steps over the same tokens, in the 4-bit and the
    int8/kv8 modes; its cache writes likewise."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(5)
    for cfg, params in ((tcfg, tparams),
                        (dataclasses.replace(tcfg, kv_quant=True), llama.recode_params_int8(tparams))):
        b, s = 3, 6
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 10)).astype(np.int32))
        window = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
        caches = [llama.init_kv_cache(cfg, b, device="cpu") for _ in range(2)]
        for c in caches:
            llama.prefill(params, cfg, prompts, c)
        pos = torch.full((b,), 10, dtype=torch.int32)
        positions = pos[:, None] + torch.arange(s, dtype=torch.int32)[None, :]
        got, _ = llama.forward(params, cfg, window, caches[0], positions, pos + s, kv_len=cfg.max_seq_len,
                               decode=True)
        steps = [llama.decode_step(params, cfg, window[:, i], caches[1], pos + i, kv_len=cfg.max_seq_len)[0]
                 for i in range(s)]
        np.testing.assert_allclose(got.numpy(), torch.stack(steps, 1).numpy(), atol=LOGIT_TOL)
        for name, t in caches[0].planes().items():
            np.testing.assert_allclose(t.float().numpy(), caches[1].planes()[name].float().numpy(), atol=0.05)


def test_verify_forward_independent_of_kv_len(model):
    """A model with 1536 cache slots, rows at positions 100, 530 and 1100:
    each row's verify logits are the same bits at every kv_len past its
    window (one, two and three key blocks of 512)."""
    _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, max_seq_len=1536)
    rng = np.random.default_rng(6)
    b, s, pos0 = 3, 5, [100, 530, 1100]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1536)).astype(np.int32))
    base = llama.init_kv_cache(cfg, b, device="cpu")
    llama.prefill(tparams, cfg, toks, base)
    pos = torch.tensor(pos0, dtype=torch.int32)
    positions = pos[:, None] + torch.arange(s, dtype=torch.int32)[None, :]
    window = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    outs = {}
    for kv_len in (512, 1024, 1536):
        cache = llama.KVCache(**{n: t.clone() for n, t in base.planes().items()})
        outs[kv_len], _ = llama.forward(tparams, cfg, window, cache, positions, pos + s, kv_len=kv_len, decode=True)
    for r, p in enumerate(pos0):
        for kv_len, out in outs.items():
            if kv_len >= p + s:
                assert torch.equal(out[r], outs[1536][r]), (r, kv_len)


def test_decode_attention_takes_the_verify_window():
    """decode_attention over S queries per row against naive attention over
    the same cache, and one query per row unchanged in its bits by the
    extension (the S = 1 path is the decode path)."""
    from nf4_tpu_torch.ops.attention import DECODE_MAX_QUERIES, decode_attention, naive_attention

    gen = torch.Generator().manual_seed(2)
    b, h, kv, t, d, s = 2, 8, 2, 700, 32, 7
    q = torch.randn((b, h, s, d), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((b, kv, t, d), generator=gen).to(torch.bfloat16) for _ in "kv")
    pos = torch.tensor([[40], [600]], dtype=torch.int32) + torch.arange(s, dtype=torch.int32)[None, :]
    lens = pos[:, -1] + 1
    got = decode_attention(q, k, v, pos, lens, scale=d**-0.5, kv_len=t)
    want = naive_attention(q, k, v, pos, lens, scale=d**-0.5)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2)
    for i in range(s):  # each position alone, as a decode step
        one = decode_attention(q[:, :, i : i + 1], k, v, pos[:, i : i + 1], pos[:, i] + 1, scale=d**-0.5, kv_len=t)
        np.testing.assert_allclose(one.float().numpy(), got[:, :, i : i + 1].float().numpy(), atol=2e-2)
    with pytest.raises(ValueError, match="queries per row"):
        decode_attention(q[:, :, :1].expand(b, h, DECODE_MAX_QUERIES + 1, d), k, v, pos, lens, scale=1.0)
