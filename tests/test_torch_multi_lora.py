"""The port's multi-LoRA serving against nf4_tpu's: ``stack_adapters``, the
banked LoRA delta, ``Engine(lora_bank=)`` with ``generate`` / ``score`` /
``admissible`` per adapter, ``token_logprobs(lora=, adapter_ids=)``, the
HTTP server's model routing and ``merge_lora``.

The same seeded adapters (``init_lora``'s A, a seeded B large enough that
the adapters change the tokens) go into both packages' banks, over the
JAX package's TINY_TEST weights through the weight bridge.  Tolerances:

* ``stack_adapters``'s leaves: bit for bit (zero padding, the scaling
  folded in fp32);
* the banked delta per row: bf16 within 2e-2 of the largest value (one
  bf16 rounding of the rank-r intermediate and of the output, summed in
  another order), fp32 within 1e-5; a row without an adapter exactly 0;
* generated tokens: ``test_torch_engine.py``'s rules (teacher-forced on
  the JAX logits of each request through its own adapter, and equal to
  the JAX Engine's up to a near-tie within LOGIT_TOL), also through a
  permuted bank and refills that switch adapters; requests without an
  adapter bit for bit the base Engine's;
* scores: ``test_torch_eval.py``'s LOGP_TOL;
* ``merge_lora(quantize=False)`` at fp32 within 1e-6 of the largest value
  (the same fp32 operations, ``B @ A`` summed in another order);
  ``quantize=True``: the packed codes equal the JAX package's wherever the
  two merged fp32 values are equal, and every block scale within one fp32
  rounding (``test_quantize.py``'s reason: the same fp32 statistics).
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf4_tpu.eval import ppl as jppl
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve.api import CompletionServer as JaxCompletionServer
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu.serve.sampling import SamplingParams as JaxSamplingParams
from nf4_tpu.train import lora as jlora
from nf4_tpu_torch.eval import ppl
from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.convert import config_from_dict, lora_from_numpy, params_from_numpy
from nf4_tpu_torch.nf4.format import PackedNF4
from nf4_tpu_torch.ops.dequant import dequantize
from nf4_tpu_torch.parallel.mesh import Mesh
from nf4_tpu_torch.serve.api import CompletionServer
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import SamplingParams
from nf4_tpu_torch.train import LoraConfig, LoraLayer, LoraParams, init_lora, merge_lora, stack_adapters
from _torch_threads import _one_thread  # noqa: F401

LOGIT_TOL = 0.2  # test_torch_engine.py's
LOGP_TOL = 0.2  # test_torch_eval.py's
ALL = ("wqkv", "wo", "w_gateup", "w_down")
# (seed, rank, targets) of the bank's adapters: ranks to pad, a target left out.
ADAPTERS = [(1, 4, ALL), (2, 8, ("wqkv", "wo")), (3, 2, ALL)]
PROMPTS_IDS = [None, 0, 1, 2, 0, 1]


def _adapter(cfg, seed, rank, targets, b_scale=0.3):
    """One adapter in both packages: init_lora's A and a seeded B."""
    jl = jlora.init_lora(cfg, jlora.LoraConfig(rank=rank, alpha=2.0 * rank, targets=targets), seed=seed)
    rng = np.random.default_rng(seed + 100)
    fields = {}
    for f in ("qkv", "o", "gateup", "down"):
        ab = getattr(jl.layers, f)
        fields[f] = None if ab is None else ab.replace(
            b=jnp.asarray((rng.standard_normal(ab.b.shape) * b_scale).astype(np.float32)))
    jl = jl.replace(layers=jl.layers.replace(**fields))
    return jl, lora_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")


def _bridge(cfg, seed=0):
    params = jllama.init_params(cfg, seed=seed)
    tcfg = config_from_dict(config_to_dict(cfg))
    return params, tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    cfg = jconfigs.TINY_TEST
    params, tcfg, tparams = _bridge(cfg)
    pairs = [_adapter(cfg, *a) for a in ADAPTERS]
    jls, tls = [p[0] for p in pairs], [p[1] for p in pairs]
    return cfg, params, tcfg, tparams, jls, tls, jlora.stack_adapters(jls), stack_adapters(tls)


def _prompts():
    rng = np.random.default_rng(5)
    return [list(map(int, rng.integers(3, 256, size=n))) for n in (3, 17, 9, 30, 1, 12)]


def _ids(adapters):
    return [-1 if a is None else a for a in adapters]


def _jax_logits(cfg, params, bank, seqs, adapters):
    """The JAX model's fp32 logits [len(seq), V] of each sequence through its
    own adapter, from one right-padded forward (causal attention keeps the
    padding out of every real position)."""
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        toks[i, : len(s)] = s
    n, t = toks.shape
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (n, t))
    logits, _ = jllama.forward(params, cfg, jnp.asarray(toks), jllama.init_kv_cache(cfg, n), pos,
                               jnp.full((n,), t, jnp.int32), lora=bank,
                               adapter_ids=jnp.asarray(_ids(adapters), jnp.int32))
    logits = np.asarray(logits, np.float32)
    return [logits[i, : len(s)] for i, s in enumerate(seqs)]


def _held_to_jax(cfg, params, bank, adapters, got, want):
    """Each request: the teacher-forced rule on the JAX logits of the port's
    own tokens through its adapter, and the port's tokens equal to the
    JAX Engine's up to the first step whose JAX top-2 gap is within
    LOGIT_TOL."""
    seqs = [list(g.prompt) + list(g.tokens) for g in got] + [list(w.prompt) + list(w.tokens) for w in want]
    rows = _jax_logits(cfg, params, bank, seqs, list(adapters) * 2)
    for i, (g, w) in enumerate(zip(got, want)):
        p = len(g.prompt)
        for j, tok in enumerate(g.tokens):
            row = rows[i][p - 1 + j]
            top2 = np.sort(row)[-2:]
            assert row[tok] >= top2[1] - LOGIT_TOL, (i, j, tok, row[tok], top2[1])
            if top2[1] - top2[0] > LOGIT_TOL:
                assert tok == int(np.argmax(row)), (i, j)
        wrows = rows[len(got) + i]
        for j, (a, b) in enumerate(zip(g.tokens, w.tokens)):
            if a != b:
                top2 = np.sort(wrows[p - 1 + j])[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL, f"request {i} diverged at {j} where JAX's choice was clear"
                break
        else:
            assert len(g.tokens) == len(w.tokens)


# --- the bank ------------------------------------------------------------------


def test_stack_adapters_matches_jax(models):
    cfg, _, _, _, jls, tls, jbank, tbank = models
    assert tbank.tp_basis == jbank.tp_basis == 1
    for i in range(cfg.num_layers):
        for f in ("qkv", "o", "gateup", "down"):
            jab, tab = getattr(jbank.layers, f), getattr(tbank.layers[i], f)
            assert tab.scaling == jab.scaling == 1.0
            rmax = 8 if f in ("qkv", "o") else 4  # adapter 1 (rank 8) adapts attention only
            assert tab.a.shape == (3, rmax, jab.a.shape[-1]) and tab.b.shape[-1] == rmax
            np.testing.assert_array_equal(tab.a.detach().numpy(), np.asarray(jab.a[i]), err_msg=f"{i}.{f}.a")
            np.testing.assert_array_equal(tab.b.detach().numpy(), np.asarray(jab.b[i]), err_msg=f"{i}.{f}.b")
    # Adapter 1 left the MLP out: zero pairs in its slot.
    assert not tbank.layers[0].gateup.a[1].any() and not tbank.layers[0].down.b[1].any()
    # Mixed tensor-parallel bases refuse, on both sides.
    with pytest.raises(ValueError, match="tp_shards bases"):
        stack_adapters([tls[0], LoraParams(list(tls[1].layers), tp_basis=2)])
    with pytest.raises(AssertionError, match="tp_shards bases"):
        jlora.stack_adapters([jls[0], jls[1].replace(tp_basis=2)])
    with pytest.raises(ValueError):
        stack_adapters([])


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_banked_delta_matches_jax_per_row(models, dtype):
    """``_lora_delta`` of a bank against the JAX one on the same x and ids,
    at every projection of layer 1; the serving form gives the same bits;
    a row's delta follows its own id only."""
    cfg, _, _, _, _, _, jbank, tbank = models
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (jnp.float32, torch.float32)}[dtype]
    served = llama.prepare_bank(tbank, tdt)
    ids = np.asarray([-1, 0, 1, 2, 2], np.int32)
    rng = np.random.default_rng(7)
    for f in ("qkv", "o", "gateup", "down"):
        jab = getattr(jbank.layers, f)
        jab = jab.replace(a=jab.a[1], b=jab.b[1])
        x = rng.standard_normal((len(ids), 3, jab.a.shape[-1])).astype(np.float32)
        want = np.asarray(jllama._lora_delta(jnp.asarray(x, jdt), jab, jnp.asarray(ids)), np.float32)
        xt = torch.from_numpy(x).to(tdt)
        got = llama._lora_delta(xt, getattr(tbank.layers[1], f), torch.from_numpy(ids))
        assert got.dtype == tdt and got.shape == want.shape
        tol = 2e-2 * np.abs(want).max() if dtype == "bf16" else 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0, err_msg=f)
        assert np.abs(want[1:]).max() > 0 and not got[0].any()
        fast = llama._lora_delta(xt, getattr(served.layers[1], f), torch.from_numpy(ids))
        torch.testing.assert_close(fast, got.detach(), rtol=0, atol=0)
        # Each row alone, with the same neighbours' x: the same bits.
        for r in range(len(ids)):
            other = torch.from_numpy(np.where(np.arange(len(ids)) == r, ids, (ids + 1) % 3))
            alone = llama._lora_delta(xt, getattr(served.layers[1], f), other)
            torch.testing.assert_close(alone[r], fast[r], rtol=0, atol=0)


def test_forward_with_bank_matches_single_adapters(models):
    """``forward(lora=bank, adapter_ids=)``: each row's logits those of
    ``forward(lora=its adapter)`` (fp32 sums of the same terms in another
    order), and -1 rows the base forward's bits."""
    cfg, _, tcfg, tparams, _, tls, _, tbank = models
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (4, 10)).astype(np.int32))
    pos = torch.arange(10, dtype=torch.int32).expand(4, 10)
    lens = torch.full((4,), 10, dtype=torch.int32)
    ids = torch.tensor([-1, 0, 1, 2], dtype=torch.int32)

    def fwd(**kw):
        with torch.no_grad():
            return llama.forward(tparams, tcfg, toks, llama.init_kv_cache(tcfg, 4, device="cpu"), pos, lens,
                                 **kw)[0]

    got = fwd(lora=tbank, adapter_ids=ids)
    torch.testing.assert_close(got[0], fwd()[0], rtol=0, atol=0)
    for j in range(3):
        np.testing.assert_allclose(got[j + 1].numpy(), fwd(lora=tls[j])[j + 1].numpy(), atol=LOGIT_TOL, rtol=0)
    with pytest.raises(ValueError, match="adapter_ids"):
        fwd(lora=tbank)


# --- the Engine ------------------------------------------------------------------


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1)], ids=["bank", "permuted"])
def test_generate_matches_jax_engine(models, order):
    """Six requests of mixed adapters (and none) through 2 slots, so refills
    switch a slot's adapter, against the JAX ``Engine(lora_bank=)``; the
    permuted bank serves the same requests under its own indices."""
    cfg, params, tcfg, tparams, _, tls, jbank, _ = models
    prompts = _prompts()
    want = JaxEngine(params, cfg, batch_size=2, eos_token=-1, decode_chunk=4, lora_bank=jbank).generate(
        prompts, max_new_tokens=8, adapter=PROMPTS_IDS)
    where = {a: order.index(a) for a in range(3)}
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu",
                 lora_bank=[tls[a] for a in order])
    assert eng.num_adapters == 3
    got = eng.generate(prompts, max_new_tokens=8, adapter=[None if a is None else where[a] for a in PROMPTS_IDS])
    assert [r.prompt for r in got] == prompts and all(len(r.tokens) == 8 for r in got)
    _held_to_jax(cfg, params, jbank, PROMPTS_IDS, got, want)
    # The adapters change the tokens: each adapted request differs from the base.
    base = Engine(tparams, tcfg, batch_size=2, eos_token=-1, decode_chunk=4, device="cpu").generate(
        prompts, max_new_tokens=8)
    assert sum(g.tokens != b.tokens for g, b in zip(got, base)) >= 4


def test_requests_without_adapter_are_the_base_engines_bits(models):
    """A request with no adapter, batched with adapted ones, gets the base
    Engine's tokens and logprobs bit for bit (its delta is exact zeros);
    a second call on the same Engine repeats the first."""
    _, _, tcfg, tparams, _, _, _, tbank = models
    prompts = _prompts()
    kw = dict(batch_size=2, eos_token=-1, decode_chunk=4, device="cpu")
    eng = Engine(tparams, tcfg, lora_bank=tbank, **kw)
    got = eng.generate(prompts, max_new_tokens=8, adapter=PROMPTS_IDS, return_logprobs=True)
    base = Engine(tparams, tcfg, **kw).generate(prompts, max_new_tokens=8, return_logprobs=True)
    for g, b, a in zip(got, base, PROMPTS_IDS):
        if a is None:
            assert g.tokens == b.tokens and g.logprobs == b.logprobs
    again = eng.generate(prompts, max_new_tokens=8, adapter=PROMPTS_IDS, return_logprobs=True)
    assert [r.tokens for r in again] == [r.tokens for r in got]
    # No adapter at all: the base Engine's call.
    plain = eng.generate(prompts, max_new_tokens=8)
    assert [r.tokens for r in plain] == [r.tokens for r in base]


def test_admitted_request_keeps_its_adapter(models):
    """``admit`` tuples carry the adapter: a request admitted mid-call with
    adapter 2 gets its run alone's tokens; ``features`` advertise the bank."""
    _, _, tcfg, tparams, _, _, _, tbank = models
    eng = Engine(tparams, tcfg, batch_size=3, eos_token=-1, decode_chunk=2, device="cpu", lora_bank=tbank)
    late = [7, 8, 9, 10]
    solo = eng.generate([late], max_new_tokens=6, adapter=[2])[0]
    seen = []

    def admit(features):
        seen.append(features)
        return [(late, None, 2)] if len(seen) == 2 else []

    admit.peek = lambda: len(seen) < 2
    res = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=12, adapter=[0, None], admit=admit)
    assert len(res) == 3 and res[2].tokens[:6] == solo.tokens
    assert seen[0]["adapters"] and seen[0]["num_adapters"] == 3
    assert not Engine.admissible(seen[0], late, SamplingParams(), adapter=3)
    assert Engine.admissible(seen[0], late, SamplingParams(), adapter=-1)

    def bad(features):
        return [(late, None, 5)]

    with pytest.raises(ValueError, match="admissible"):
        eng.generate([[1, 2]], max_new_tokens=4, admit=bad)


def test_admissible_with_a_bank_agrees_with_jax():
    base = {"use_mask": False, "use_counts": False, "use_bias": False, "top_lp_k": 0, "return_logprobs": False,
            "max_prompt_len": 63, "prefix": ()}
    for feats in (dict(base, adapters=True, num_adapters=3), dict(base, adapters=False, num_adapters=0)):
        for adapter in (None, -2, -1, 0, 2, 3):
            for prompt in ([], [1, 2], list(range(64))):
                want = JaxEngine.admissible(feats, prompt, JaxSamplingParams(), adapter=adapter)
                assert Engine.admissible(feats, prompt, SamplingParams(), adapter=adapter) == want


def test_guards(models):
    _, _, tcfg, tparams, _, tls, _, tbank = models
    kw = dict(batch_size=2, eos_token=-1, device="cpu")
    eng = Engine(tparams, tcfg, lora_bank=tbank, **kw)
    with pytest.raises(ValueError, match="adapter indices"):
        eng.generate([[1, 2]], max_new_tokens=2, adapter=[3])
    with pytest.raises(ValueError, match="one adapter index per prompt"):
        eng.generate([[1, 2]], max_new_tokens=2, adapter=[0, 1])
    with pytest.raises(ValueError, match="adapter indices"):
        eng.score([[1, 2, 3]], adapter=[-2])
    base = Engine(tparams, tcfg, **kw)
    with pytest.raises(ValueError, match="lora_bank"):
        base.generate([[1, 2]], max_new_tokens=2, adapter=[0])
    with pytest.raises(ValueError, match="lora_bank"):
        base.score([[1, 2]], adapter=[0])
    for extra in ({"spec_k": 3}, {"prefix_cache": True}):
        with pytest.raises(ValueError, match="not composable"):
            Engine(tparams, tcfg, lora_bank=tbank, **kw, **extra)
    with pytest.raises(ValueError, match="stacked bank"):
        Engine(tparams, tcfg, lora_bank=tls[0], **kw)
    mesh = Mesh(tp=1, dp=1, rank=0, tp_rank=0, dp_rank=0, tp_group=None, dp_group=None,
                device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="multi-LoRA serving is single-device"):
        Engine(tparams, tcfg, lora_bank=tbank, mesh=mesh, cuda_graphs=False, **kw)


def test_score_and_token_logprobs_match_jax(models):
    cfg, params, tcfg, tparams, _, _, jbank, tbank = models
    seqs = [p + [5, 6] for p in _prompts()[:4]]
    adapters = [None, 0, 1, 2]
    want = JaxEngine(params, cfg, batch_size=4, eos_token=-1, lora_bank=jbank).score(seqs, adapter=adapters)
    eng = Engine(tparams, tcfg, batch_size=4, eos_token=-1, device="cpu", lora_bank=tbank)
    got = eng.score(seqs, adapter=adapters)
    direct = ppl.token_logprobs(tparams, tcfg, seqs, batch_size=4, lora=tbank, adapter_ids=_ids(adapters),
                               device="cpu")
    jdirect = jppl.token_logprobs(params, cfg, seqs, batch_size=4, lora=jbank, adapter_ids=_ids(adapters))
    for g, w, d, jd in zip(got, want, direct, jdirect):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, atol=LOGP_TOL, rtol=0)
        np.testing.assert_allclose(d, jd, atol=LOGP_TOL, rtol=0)
        assert g == d  # the serving form reads the same bf16 values
    # The adapters move the scores; no adapter scores as the base Engine.
    plain = Engine(tparams, tcfg, batch_size=4, eos_token=-1, device="cpu").score(seqs)
    assert got[0] == plain[0] and max(abs(a - b) for a, b in zip(got[1], plain[1])) > 0.1
    assert eng.score(seqs) == plain


# --- HTTP routing ------------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _models_list(url):
    with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
        return [m["id"] for m in json.loads(r.read())["data"]]


def test_http_routes_model_names(models):
    """``CompletionServer(adapters=)``: ``/v1/models`` lists the base and
    every adapter as the JAX server does; two model names and the base in
    one wave get their direct ``generate`` tokens; an ``echo`` request
    scores through its adapter; an unknown name is a 400 on both
    servers."""
    cfg, params, tcfg, tparams, _, _, jbank, tbank = models
    names = {"alpha": 0, "gamma": 2}
    kw = dict(batch_size=4, eos_token=-1, device="cpu")
    server = CompletionServer(Engine(tparams, tcfg, lora_bank=tbank, **kw), adapters=names, batch_window=0.5)
    jserver = JaxCompletionServer(JaxEngine(params, cfg, batch_size=4, eos_token=-1, lora_bank=jbank),
                                  adapters=names)
    url = f"http://127.0.0.1:{server.start(port=0)}"
    jurl = f"http://127.0.0.1:{jserver.start(port=0)}"
    bodies = {"alpha": {"prompt": [3, 5, 7], "max_tokens": 6, "model": "alpha"},
              "gamma": {"prompt": [2, 4, 6, 8], "max_tokens": 5, "model": "gamma"},
              "base": {"prompt": [9, 9, 1], "max_tokens": 4, "model": "nf4-tpu"},
              "echo": {"prompt": [4, 4, 2, 7], "max_tokens": 0, "echo": True, "logprobs": True, "model": "gamma"}}
    out = {}
    try:
        assert _models_list(url) == _models_list(jurl) == ["nf4-tpu", "alpha", "gamma"]
        threads = [threading.Thread(target=lambda k=k: out.setdefault(k, _post(url, bodies[k]))) for k in bodies]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        bad = {"prompt": [1, 2], "max_tokens": 2, "model": "delta"}
        status, body = _post(url, bad)
        jstatus, _ = _post(jurl, bad)
    finally:
        server.stop()
        jserver.stop()
    assert status == jstatus == 400 and "unknown model" in body["error"]
    assert server.stats["waves"] == 1
    twin = Engine(tparams, tcfg, lora_bank=tbank, **kw)
    direct = twin.generate([bodies[k]["prompt"] for k in ("alpha", "gamma", "base")], max_new_tokens=6,
                           sampling=[SamplingParams(max_new_tokens=bodies[k]["max_tokens"])
                                     for k in ("alpha", "gamma", "base")], adapter=[0, 2, None])
    for k, r in zip(("alpha", "gamma", "base"), direct):
        assert out[k][0] == 200 and out[k][1]["choices"][0]["tokens"] == r.tokens, k
    score = twin.score([bodies["echo"]["prompt"]], adapter=[2])[0]
    assert out["echo"][1]["choices"][0]["logprobs"]["token_logprobs"] == [None] + score
    with pytest.raises(ValueError, match="lora_bank"):
        CompletionServer(Engine(tparams, tcfg, **kw), adapters=names)
    with pytest.raises(ValueError, match="out of range"):
        CompletionServer(twin, adapters={"x": 3})


# --- merge_lora --------------------------------------------------------------------


@pytest.fixture(scope="module")
def fp32_models():
    cfg = dataclasses.replace(jconfigs.TINY_TEST, dtype=jnp.float32)
    params, tcfg, tparams = _bridge(cfg)
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("which", [0, 1])
def test_merge_lora_matches_jax(fp32_models, which):
    """Adapter 0 (all four targets) and 1 (attention only) merged into the
    fp32 model, dense and requantized, against the JAX ``merge_lora``."""
    cfg, params, tcfg, tparams = fp32_models
    jl, tl = _adapter(cfg, *ADAPTERS[which])
    dense_j = jlora.merge_lora(params, jl, cfg, quantize=False)
    dense_t = merge_lora(tparams, tl, tcfg, quantize=False)
    packed_j = jlora.merge_lora(params, jl, cfg, quantize=True)
    packed_t = merge_lora(tparams, tl, tcfg, quantize=True)
    field = {"wqkv": "qkv", "wo": "o", "w_gateup": "gateup", "w_down": "down"}
    for i in range(cfg.num_layers):
        for name in ALL:
            lp = dense_t.layers[i]
            if getattr(tl.layers[i], field[name]) is None:  # not adapted: the weight itself
                assert getattr(lp, name) is getattr(tparams.layers[i], name)
                assert getattr(packed_t.layers[i], name) is getattr(tparams.layers[i], name)
                continue
            got, want = getattr(lp, name).numpy(), np.asarray(getattr(dense_j.layers, name)[i])
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0, err_msg=name)
            pw, jpw = getattr(packed_t.layers[i], name), getattr(packed_j.layers, name)
            assert isinstance(pw, PackedNF4) and pw.quant_type == jpw.quant_type
            jp, js = np.asarray(jpw.packed[i]), np.asarray(jpw.scales[i])
            same = got == want  # merged fp32 values equal: the codes must be
            codes_t = np.stack([pw.packed.numpy() & 15, pw.packed.numpy() >> 4], 1).reshape(-1, jp.shape[1])
            codes_j = np.stack([jp & 15, jp >> 4], 1).reshape(-1, jp.shape[1])
            m, n = want.shape
            np.testing.assert_array_equal(codes_t[:n, :m][same.T], codes_j[:n, :m][same.T], err_msg=name)
            np.testing.assert_allclose(pw.scales.numpy(), js, rtol=2 ** -23, atol=0, err_msg=name)
    # The merged model is the adapted one: its logits those of forward(lora=).
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 8)).astype(np.int32))
    with torch.no_grad():
        merged, _ = llama.prefill(dense_t, tcfg, toks)
        adapted, _ = llama.forward(tparams, tcfg, toks, llama.init_kv_cache(tcfg, 2, device="cpu"),
                                   torch.arange(8, dtype=torch.int32).expand(2, 8), torch.full((2,), 8), lora=tl)
    np.testing.assert_allclose(merged.numpy(), adapted.numpy(), atol=1e-4, rtol=0)
    requant = dequantize(packed_t.layers[0].wqkv, torch.float32).numpy()
    assert np.abs(requant - dense_t.layers[0].wqkv.numpy()).max() < 0.5 * np.abs(requant).max()


def test_merge_lora_guards(fp32_models, models):
    _, _, tcfg, tparams = fp32_models
    tbank = models[7]
    tl = init_lora(tcfg, LoraConfig(rank=2, alpha=4.0), device="cpu")
    with pytest.raises(ValueError, match="tp_basis"):
        merge_lora(tparams, LoraParams(list(tl.layers), tp_basis=2), tcfg)
    with pytest.raises(ValueError, match="not a bank"):
        merge_lora(tparams, tbank, tcfg)
    with pytest.raises(ValueError, match="method="):
        merge_lora(tparams, tl, tcfg, method="fast")
    native = merge_lora(tparams, tl, tcfg, method="native")  # ported: the oracle's bytes
    oracle = merge_lora(tparams, tl, tcfg, method="oracle")
    for got, want in zip(native.layers, oracle.layers):
        for name in ("wqkv", "wo", "w_gateup", "w_down"):
            g, w = getattr(got, name), getattr(want, name)
            assert torch.equal(g.packed, w.packed) and torch.equal(g.scales, w.scales), name


# --- the MoE repair ----------------------------------------------------------------


def test_moe_expert_lora_refused_on_both_sides():
    """LoRA on an MoE layer's expert MLP is refused in the forward, as the
    JAX package's is (it used to be dropped silently); attention-only
    LoRA runs."""
    cfg = jconfigs.TINY_MOE
    params, tcfg, tparams = _bridge(cfg)
    dense = dataclasses.replace(cfg, num_experts=1)
    jl = jlora.init_lora(dense, jlora.LoraConfig(rank=2, alpha=4.0), seed=0)
    tl = lora_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")
    toks = np.asarray([[1, 2, 3, 4]], np.int32)
    with pytest.raises(AssertionError, match="MoE expert MLPs"):
        jllama.train_forward(params, cfg, jnp.asarray(toks), lora=jl)
    with pytest.raises(ValueError, match="MoE expert MLPs"):
        llama.train_forward(tparams, tcfg, torch.from_numpy(toks), lora=tl)
    with pytest.raises(ValueError, match="MoE expert MLPs"):
        llama.forward(tparams, tcfg, torch.from_numpy(toks), llama.init_kv_cache(tcfg, 1, device="cpu"),
                      torch.arange(4, dtype=torch.int32)[None], torch.full((1,), 4), lora=tl)
    attn_only = LoraParams([LoraLayer(qkv=ll.qkv, o=ll.o) for ll in tl.layers])
    out = llama.train_forward(tparams, tcfg, torch.from_numpy(toks), lora=attn_only)
    assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="MoE expert MLPs"):  # init_lora refuses the targets too
        init_lora(tcfg, LoraConfig(rank=2, alpha=4.0), device="cpu")
