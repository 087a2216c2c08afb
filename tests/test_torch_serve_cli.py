"""The port's serving CLI (``python -m nf4_tpu_torch.serve``) driven
in-process on the CPU (``--device cpu``), the cases of
``tests/test_serve_cli.py``: a packed checkpoint the test saves (from the
JAX package's ``init_params``, so both packages serve the same weights),
in the 4-bit and the ``--int8 --kv8`` modes, and ``--model tiny-test
--synthetic`` (also ``tiny-gemma2`` and ``tiny-moe``); answers over localhost equal a twin Engine's, and a
checkpoint the JAX package saves is served as its own CLI serves it; an
HF directory (``--hf-dir``) is quantized as it loads and served;
``--spec-k`` and ``--draft-*`` serve speculatively; flags of machinery not
ported yet exit with a clear message."""

import dataclasses
import json
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu_torch.models import llama
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy
from nf4_tpu_torch.models.loader import save_packed
from nf4_tpu_torch.serve.__main__ import main
from nf4_tpu_torch.serve.engine import Engine


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = jconfigs.TINY_TEST
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jllama.init_params(cfg, seed=0)), tcfg, device="cpu")
    path = str(tmp_path_factory.mktemp("cli") / "tiny.npz")
    save_packed(path, tparams, tcfg)
    return path, tcfg, tparams


def _complete(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("int8", [False, True])
def test_packed_checkpoint_serves(checkpoint, int8):
    path, tcfg, tparams = checkpoint
    flags = ["--int8", "--kv8"] if int8 else []
    server = main(["--packed", path, "--port", "0", "--batch-size", "2", "--eos", "-1", "--model-name", "tiny-nf4",
                   "--device", "cpu", "--decode-chunk", "4", *flags], block=False)
    try:
        assert server.engine.cfg.kv_quant == int8 and server.engine.decode_chunk == 4
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/models", timeout=30) as r:
            assert json.loads(r.read())["data"][0]["id"] == "tiny-nf4"
        body = _complete(server.port, {"model": "tiny-nf4", "prompt": [3, 1, 4, 1, 5], "max_tokens": 6})
    finally:
        server.stop()
    cfg, params = tcfg, tparams
    if int8:
        cfg, params = dataclasses.replace(tcfg, kv_quant=True), llama.recode_params_int8(tparams)
    twin = Engine(params, cfg, batch_size=2, eos_token=-1, device="cpu")
    assert body["choices"][0]["tokens"] == twin.generate([[3, 1, 4, 1, 5]], max_new_tokens=6)[0].tokens


@pytest.mark.parametrize("int8", [False, True])
def test_jax_checkpoint_serves_as_the_jax_cli(tmp_path, int8):
    """A checkpoint the JAX package saves, served by both CLIs with the same
    flags: equal /v1/models payloads, the same payload keys, finish reasons
    and usage, and in the 4-bit mode the JAX CLI's greedy tokens up to the
    first step whose top-2 gap in the JAX logits is within 0.2
    (``test_torch_engine.py``'s rule; the int8 modes recode on their own
    scales, so there only the shape is compared)."""
    from nf4_tpu.models.loader import save_packed as jax_save_packed
    from nf4_tpu.serve.__main__ import main as jax_main

    cfg = jconfigs.TINY_TEST
    jparams = jllama.init_params(cfg, seed=0)
    path = str(tmp_path / "tiny.npz")
    jax_save_packed(path, jparams, cfg)
    flags = ["--packed", path, "--port", "0", "--batch-size", "2", "--eos", "-1", "--model-name", "tiny-nf4",
             "--decode-chunk", "4"] + (["--int8", "--kv8"] if int8 else [])
    prompt, answers = [3, 1, 4, 1, 5], []
    for start in (lambda: jax_main(flags, block=False), lambda: main(flags + ["--device", "cpu"], block=False)):
        server = start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/models", timeout=30) as r:
                models = json.loads(r.read())
            answers.append((models, _complete(server.port, {"prompt": prompt, "max_tokens": 6})))
        finally:
            server.stop()
    (jmodels, want), (tmodels, got) = answers
    assert tmodels == jmodels
    assert sorted(got) == sorted(want) and got["usage"] == want["usage"]
    (g,), (w,) = got["choices"], want["choices"]
    assert sorted(g) == sorted(w) and g["finish_reason"] == w["finish_reason"] and len(g["tokens"]) == len(w["tokens"])
    if int8:
        return
    logits, _ = jllama.prefill(jparams, cfg, jax.numpy.asarray([prompt + w["tokens"]], jax.numpy.int32))
    rows = np.asarray(logits[0], np.float32)[len(prompt) - 1:]
    for i, (a, b) in enumerate(zip(g["tokens"], w["tokens"])):
        if a != b:
            top2 = np.sort(rows[i])[-2:]
            assert top2[1] - top2[0] <= 0.2, f"diverged at step {i} where JAX's choice was clear"
            break


def test_synthetic_model_serves():
    server = main(["--model", "tiny-test", "--synthetic", "--port", "0", "--batch-size", "2", "--eos", "-1",
                   "--device", "cpu", "--temperature", "0.7", "--max-seq-len", "48"], block=False)
    try:
        assert server.engine.sampling.temperature == 0.7 and server.engine.cfg.max_seq_len == 48
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        body = _complete(server.port, {"prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0.9, "seed": 1})
        assert len(body["choices"][0]["tokens"]) == 4
    finally:
        server.stop()


@pytest.mark.parametrize("model", ["tiny-gemma2", "tiny-moe"])
def test_synthetic_gemma2_and_moe_serve(model):
    """``--model tiny-gemma2 --synthetic`` and ``--model tiny-moe
    --synthetic`` answer a greedy completion on the CPU: the tokens a twin
    Engine on the same synthetic weights gives."""
    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params

    server = main(["--model", model, "--synthetic", "--port", "0", "--batch-size", "2", "--eos", "-1",
                   "--device", "cpu", "--decode-chunk", "4"], block=False)
    try:
        body = _complete(server.port, {"prompt": [5, 9, 2, 7], "max_tokens": 6})
    finally:
        server.stop()
    cfg = configs.get_config(model)
    twin = Engine(synthetic_params(cfg, seed=0, device="cpu"), cfg, batch_size=2, eos_token=-1, device="cpu")
    tokens = body["choices"][0]["tokens"]
    assert len(tokens) == 6 and tokens == twin.generate([[5, 9, 2, 7]], max_new_tokens=6)[0].tokens


def test_tokenizer_unavailable_falls_back_to_token_ids(checkpoint, tmp_path, capsys, monkeypatch):
    """Without transformers (hidden here, so nothing is looked up) the
    server keeps the token-id API."""
    path, _, _ = checkpoint
    monkeypatch.setitem(sys.modules, "transformers", None)
    server = main(["--packed", path, "--port", "0", "--device", "cpu", "--tokenizer", str(tmp_path / "none")],
                  block=False)
    try:
        assert server.tokenizer is None and server.engine.eos_token == 2
    finally:
        server.stop()
    assert "token-id API only" in capsys.readouterr().err


def test_hf_dir_serves(tmp_path, capsys, monkeypatch):
    """``--hf-dir DIR --device cpu`` quantizes the directory as it loads,
    builds the Engine and answers a request: the tokens of a twin Engine
    on ``load_hf_llama`` of the same directory.  The directory has no
    tokenizer files (and transformers is hidden): the token-id API."""
    from test_torch_hf_loader import write_checkpoint

    from nf4_tpu_torch.models.loader import load_hf_llama

    path = write_checkpoint(tmp_path / "hf", "llama3", np.float16, shards=2)
    monkeypatch.setitem(sys.modules, "transformers", None)
    server = main(["--hf-dir", path, "--port", "0", "--batch-size", "2", "--eos", "-1", "--device", "cpu",
                   "--decode-chunk", "4"], block=False)
    try:
        assert server.tokenizer is None and server.engine.cfg.num_layers == 2
        body = _complete(server.port, {"prompt": [3, 1, 4, 1, 5], "max_tokens": 6})
    finally:
        server.stop()
    assert "token-id API only" in capsys.readouterr().err
    params, cfg = load_hf_llama(path, device="cpu")
    twin = Engine(params, cfg, batch_size=2, eos_token=-1, device="cpu")
    assert body["choices"][0]["tokens"] == twin.generate([[3, 1, 4, 1, 5]], max_new_tokens=6)[0].tokens


@pytest.mark.parametrize("flags", [
    ["--spec-k", "3"],
    ["--spec-k", "2", "--int8", "--kv8"],
    ["--spec-k", "3", "--draft-model", "tiny-test"],
    ["--spec-k", "3", "--draft-packed", "CHECKPOINT"],
], ids=["prompt-lookup", "prompt-lookup-int8", "draft-model", "draft-packed"])
def test_spec_flags_serve(checkpoint, flags):
    """``--spec-k`` with prompt lookup (also in the int8 mode) and with a
    draft model (synthetic, or the test's checkpoint): the server's Engine
    speculates, with the draft's context cut to the target's, and answers
    with a plain Engine's greedy tokens."""
    path, tcfg, tparams = checkpoint
    flags = [path if f == "CHECKPOINT" else f for f in flags]
    server = main(["--packed", path, "--port", "0", "--batch-size", "2", "--eos", "-1", "--device", "cpu",
                   "--decode-chunk", "4", "--max-seq-len", "48", *flags], block=False)
    try:
        eng = server.engine
        eng.spec_min_accept = 0.0
        assert eng.spec_k == int(flags[1])
        if "--draft-model" in flags or "--draft-packed" in flags:
            assert eng._draft is not None and eng._draft[1].max_seq_len == 48
        body = _complete(server.port, {"prompt": [3, 1, 4, 1, 3, 1, 4, 1], "max_tokens": 10})
    finally:
        server.stop()
    assert eng.spec_stats["steps"] > 0
    cfg, params = dataclasses.replace(tcfg, max_seq_len=48), tparams
    if "--int8" in flags:
        cfg, params = dataclasses.replace(cfg, kv_quant=True), llama.recode_params_int8(tparams)
    twin = Engine(params, cfg, batch_size=2, eos_token=-1, device="cpu")
    assert body["choices"][0]["tokens"] == twin.generate([[3, 1, 4, 1, 3, 1, 4, 1]], max_new_tokens=10)[0].tokens


def test_draft_flags_need_spec_k():
    with pytest.raises(SystemExit, match="requires --spec-k"):
        main(["--model", "tiny-test", "--synthetic", "--port", "0", "--device", "cpu", "--draft-model", "tiny-test"],
             block=False)


@pytest.mark.parametrize("flags, what", [
    (["--prefix-cache"], "--prefix-cache"), (["--tp", "2"], "--tp"), (["--dp", "2"], "--dp"),
])
def test_unported_flags_exit(flags, what):
    with pytest.raises(SystemExit, match="not ported yet") as e:
        main(["--model", "tiny-test", "--synthetic", "--port", "0", "--device", "cpu", *flags], block=False)
    assert what in str(e.value)


def test_weight_source_validation():
    with pytest.raises(SystemExit, match="pick exactly one"):
        main(["--port", "0", "--device", "cpu"], block=False)
    with pytest.raises(SystemExit, match="requires --model"):
        main(["--synthetic", "--port", "0", "--device", "cpu"], block=False)
    with pytest.raises(SystemExit, match="pick exactly one"):
        main(["--synthetic", "--model", "tiny-test", "--packed", "x.npz", "--device", "cpu"], block=False)


def test_default_device_is_cuda():
    """Without ``--device`` the server runs on the card: with none, the
    engine refuses instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "tiny-test", "--synthetic", "--port", "0"], block=False)
