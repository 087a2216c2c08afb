"""The port's HTTP completions server (``nf4_tpu_torch/serve/api.py``) over
localhost sockets on the CPU, the cases of ``tests/test_api.py``.

Responses through the network boundary must be exactly what
``Engine.generate`` gives directly — token ids, budgets, logprobs,
streaming order — also when concurrent requests with different
parameters share a wave; bad bodies get 400.

The same bodies also go to the JAX package's server over its Engine with
the same weights: the payloads' keys, finish reasons, usage and status
codes must be equal, the tokens equal up to the first step whose top-2 gap
in the JAX logits is within LOGIT_TOL (``test_torch_engine.py``'s rule:
the port rounds weights to bf16, JAX's CPU path does not), and the
logprobs within LOGIT_TOL up to that step.  Seeded stochastic choices
cannot reproduce ``jax.random``'s bits; only their shape is compared.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import config_to_dict
from nf4_tpu.serve.api import CompletionServer as JaxCompletionServer
from nf4_tpu.serve.engine import Engine as JaxEngine
from nf4_tpu_torch.models.convert import config_from_dict, params_from_numpy
from nf4_tpu_torch.serve.api import CompletionServer
from nf4_tpu_torch.serve.engine import Engine
from nf4_tpu_torch.serve.sampling import SamplingParams


class ToyTokenizer:
    """Byte-level stand-in with the encode/decode duck type HF uses."""

    def encode(self, text):
        return [ord(c) % 256 for c in text]

    def decode(self, ids):
        return "".join(chr(i % 128 + 32) for i in ids)


class TemplateTokenizer(ToyTokenizer):
    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        return [200 + len(messages)] + self.encode(messages[-1]["content"])


@pytest.fixture(scope="module")
def params():
    cfg = jconfigs.TINY_TEST
    tcfg = config_from_dict(config_to_dict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jllama.init_params(cfg, seed=0)), tcfg, device="cpu")
    return tcfg, tparams


def _engine(params):
    tcfg, tparams = params
    return Engine(tparams, tcfg, batch_size=2, eos_token=-1, device="cpu")


@pytest.fixture(scope="module")
def served(params):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    server = CompletionServer(_engine(params), tokenizer=ToyTokenizer())
    port = server.start(port=0)
    yield f"http://127.0.0.1:{port}", _engine(params), server
    server.stop()
    torch.set_num_threads(threads)


def _slow(server, seconds=0.05):
    """Make each decode launch of the server's engine take ``seconds``
    longer, so a test's second request reliably arrives mid-wave."""
    dec = server.engine.state()[1]
    launch = dec.launch

    def slow(*args, **kw):
        time.sleep(seconds)
        return launch(*args, **kw)

    dec.launch = slow


def _post(url, body, path="/v1/completions", timeout=120):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            if resp.headers.get("Content-Type") == "text/event-stream":
                return resp.status, [json.loads(line[6:]) for line in raw.decode().split("\n")
                                     if line.startswith("data: ") and line != "data: [DONE]"]
            return resp.status, json.loads(raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_models_metrics(served):
    url, _, _ = served
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
        assert json.loads(r.read())["data"][0]["id"] == "nf4-tpu"
    _post(url, {"prompt": [1, 2], "max_tokens": 2})
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    values = dict(line.split() for line in text.splitlines() if not line.startswith("#"))
    assert int(values["nf4tpu_requests_total"]) >= 1 and int(values["nf4tpu_tokens_out_total"]) >= 2
    assert values["nf4tpu_batch_slots"] == "2" and "nf4tpu_graphs_captured_total" in values
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(url + "/nope", timeout=30)


def test_metrics_count_speculation(params):
    """A server over a speculative Engine: /metrics carries the JAX server's
    spec counters, at 0 before a request and moving with it (verify rounds
    and the tokens they emitted), and the answer is a plain Engine's."""
    tcfg, tparams = params
    eng = Engine(tparams, tcfg, batch_size=2, eos_token=-1, device="cpu", spec_k=3)
    eng.spec_min_accept = 0.0
    server = CompletionServer(eng)
    url = f"http://127.0.0.1:{server.start(port=0)}"

    def counters():
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            values = dict(line.split() for line in r.read().decode().splitlines() if not line.startswith("#"))
        return int(values["nf4tpu_spec_steps_total"]), int(values["nf4tpu_spec_emitted_total"])

    try:
        assert counters() == (0, 0)
        code, body = _post(url, {"prompt": [1, 2, 3, 1, 2, 3, 1, 2], "max_tokens": 12})
        steps, emitted = counters()
    finally:
        server.stop()
    assert code == 200 and 0 < steps <= emitted <= 11
    assert (steps, emitted) == (eng.spec_stats["steps"], eng.spec_stats["emitted"])
    assert body["choices"][0]["tokens"] == _engine(params).generate([[1, 2, 3, 1, 2, 3, 1, 2]], max_new_tokens=12)[0].tokens


def test_completion_matches_engine(served):
    url, twin, _ = served
    want = twin.generate([[3, 5, 7]], max_new_tokens=6)[0]
    code, body = _post(url, {"prompt": [3, 5, 7], "max_tokens": 6})
    assert code == 200
    choice = body["choices"][0]
    assert choice["tokens"] == want.tokens and choice["finish_reason"] == "length"
    assert body["usage"] == {"prompt_tokens": 3, "completion_tokens": 6, "total_tokens": 9}
    assert choice["text"] == ToyTokenizer().decode(want.tokens)


def test_string_prompt(served):
    url, twin, _ = served
    want = twin.generate([ToyTokenizer().encode("hi!")], max_new_tokens=4)[0]
    code, body = _post(url, {"prompt": "hi!", "max_tokens": 4})
    assert code == 200 and body["choices"][0]["tokens"] == want.tokens


def test_logprobs_and_top_logprobs(served):
    url, twin, _ = served
    want = twin.generate([[2, 4, 6]], max_new_tokens=4, return_logprobs=True,
                         sampling=SamplingParams(max_new_tokens=4, top_logprobs=3))[0]
    code, body = _post(url, {"prompt": [2, 4, 6], "max_tokens": 4, "logprobs": 3})
    assert code == 200
    lp = body["choices"][0]["logprobs"]
    assert lp["token_logprobs"] == pytest.approx(want.logprobs, abs=1e-6)
    for tok, v, row in zip(body["choices"][0]["tokens"], lp["token_logprobs"], lp["top_logprobs"]):
        assert len(row) == 3 and abs(max(row.values()) - v) < 1e-5
    code, body = _post(url, {"prompt": [2, 4, 6], "max_tokens": 4, "logprobs": True})
    assert "top_logprobs" not in body["choices"][0]["logprobs"]


def test_concurrent_requests_share_a_wave(served):
    """Requests with different budgets and temperatures resolve as direct
    generate calls would (per-request params in one wave, or two)."""
    url, twin, _ = served
    w3 = twin.generate([[3, 5, 7]], max_new_tokens=3)[0]
    w6 = twin.generate([[2, 4, 6]], max_new_tokens=6)[0]
    out = {}

    def post(tag, body):
        out[tag] = _post(url, body)

    threads = [threading.Thread(target=post, args=("a", {"prompt": [3, 5, 7], "max_tokens": 3})),
               threading.Thread(target=post, args=("b", {"prompt": [2, 4, 6], "max_tokens": 6})),
               threading.Thread(target=post, args=("c", {"prompt": [9, 9], "max_tokens": 5, "temperature": 0.9}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert out["a"][1]["choices"][0]["tokens"] == w3.tokens
    assert out["b"][1]["choices"][0]["tokens"] == w6.tokens
    assert len(out["c"][1]["choices"][0]["tokens"]) == 5


def test_streaming_sse_equals_the_reply(served):
    url, twin, _ = served
    want = twin.generate([[1, 2, 3]], max_new_tokens=5)[0]
    code, events = _post(url, {"prompt": [1, 2, 3], "max_tokens": 5, "stream": True})
    assert code == 200 and [e["token"] for e in events] == want.tokens
    assert all(e["text"] == ToyTokenizer().decode([e["token"]]) for e in events)


def test_seeded_and_n_choices(served):
    url, twin, _ = served
    body = {"prompt": [4, 4, 4], "max_tokens": 8, "temperature": 1.0, "seed": 17}
    a, b = _post(url, body)[1], _post(url, body)[1]
    assert a["choices"][0]["tokens"] == b["choices"][0]["tokens"]
    code, many = _post(url, dict(body, n=3))
    assert code == 200 and len(many["choices"]) == 3
    for i, ch in enumerate(many["choices"]):
        want = twin.generate([[4, 4, 4]], max_new_tokens=8, sampling=SamplingParams(temperature=1.0, seed=17 + i))
        assert ch["index"] == i and ch["tokens"] == want[0].tokens
    assert many["choices"][0]["tokens"] == a["choices"][0]["tokens"]


@pytest.mark.parametrize("body", [
    b"{not json", b"[1, 2]", {"prompt": 5}, {"prompt": [1, "x"]}, {"prompt": [1], "n": 0},
    {"prompt": [1], "n": 2, "stream": True}, {"prompt": [1], "logprobs": 21}, {"prompt": [1], "echo": True},
    {"prompt": [1], "max_tokens": 0}, {"prompt": [1], "temperature": "hot"}, {"prompt": [1, 256]},
    {"prompt": [-1, 2]}, {"prompt": [1], "logit_bias": {"300": 1.0}}, {"prompt": [1], "logit_bias": {"-3": 1.0}},
])
def test_bad_requests(served, body):
    url, _, _ = served
    code, reply = _post(url, body)
    assert code == 400 and reply["error"]


def test_logit_bias_and_guided_choice(served):
    url, twin, _ = served
    base = twin.generate([[6, 7, 8]], max_new_tokens=5)[0].tokens
    code, body = _post(url, {"prompt": [6, 7, 8], "max_tokens": 5, "logit_bias": {str(base[0]): -100}})
    assert code == 200 and base[0] not in body["choices"][0]["tokens"]
    code, body = _post(url, {"prompt": [6, 7, 8], "max_tokens": 5, "logit_bias": {"42": 100}})
    assert body["choices"][0]["tokens"] == [42] * 5
    code, body = _post(url, {"prompt": [6, 7, 8], "max_tokens": 2, "guided_choice": [[9, 8, 7], [5], "ab"]})
    assert tuple(body["choices"][0]["tokens"]) in {(9, 8, 7), (5,), (97, 98)}
    assert body["choices"][0]["finish_reason"] == "stop"


def test_chat_fallback_template_and_streaming(served):
    url, twin, _ = served
    messages = [{"role": "user", "content": "hey"}]
    text = "<|user|>\nhey\n<|assistant|>\n"
    want = twin.generate([ToyTokenizer().encode(text)], max_new_tokens=3)[0]
    code, body = _post(url, {"messages": messages, "max_tokens": 3}, path="/v1/chat/completions")
    assert code == 200 and body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert body["choices"][0]["tokens"] == want.tokens and msg == {"role": "assistant",
                                                                   "content": ToyTokenizer().decode(want.tokens)}
    assert body["usage"]["prompt_tokens"] == len(text)
    code, events = _post(url, {"messages": messages, "max_tokens": 3, "stream": True}, path="/v1/chat/completions")
    assert [e["choices"][0]["token"] for e in events] == body["choices"][0]["tokens"]
    assert all(e["object"] == "chat.completion.chunk" for e in events)
    for bad in ({"messages": []}, {"messages": [{"role": "user"}]}, {}):
        assert _post(url, bad, path="/v1/chat/completions")[0] == 400


def test_chat_uses_the_tokenizer_template(params):
    server = CompletionServer(_engine(params), tokenizer=TemplateTokenizer())
    port = server.start(port=0)
    try:
        code, body = _post(f"http://127.0.0.1:{port}",
                           {"messages": [{"role": "user", "content": "ab"}], "max_tokens": 2},
                           path="/v1/chat/completions")
        assert code == 200 and body["usage"]["prompt_tokens"] == 3
    finally:
        server.stop()


def test_disconnect_cancels_within_a_chunk(params):
    """A streaming client that hangs up after its first event cancels its
    request: counted from the close, it takes at most one more chunk."""
    server = CompletionServer(_engine(params))
    seen = []
    submit = server.submit
    server.submit = lambda *a, **k: seen.append(submit(*a, **k)) or seen[-1]
    _slow(server)
    port = server.start(port=0)
    try:
        data = json.dumps({"prompt": [1, 2, 3], "max_tokens": 50, "stream": True}).encode()
        with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
            sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(data) + data)
            buf = b""
            while b"data: " not in buf:
                buf += sock.recv(4096)
            at_close = seen[0].emitted
        deadline = time.monotonic() + 60
        while not seen[0].done.is_set() and time.monotonic() < deadline:
            time.sleep(0.02)
        p = seen[0]
        assert p.done.is_set() and p.cancelled and not p.result.finished
        assert len(p.result.tokens) - at_close <= 8 and len(p.result.tokens) < 50
        assert server.stats["cancelled"] == 1
        code, body = _post(f"http://127.0.0.1:{port}", {"prompt": [1, 2, 3], "max_tokens": 4})
        assert code == 200 and len(body["choices"][0]["tokens"]) == 4
    finally:
        server.stop()


def test_request_joins_the_running_wave(params):
    """A request sent while a long wave decodes joins it (admission) and
    gets its solo tokens; one the wave cannot serve leads the next."""
    server = CompletionServer(_engine(params))
    _slow(server)
    port = server.start(port=0)
    url = f"http://127.0.0.1:{port}"
    out = {}
    try:
        long = threading.Thread(target=lambda: out.setdefault("long", _post(url, {"prompt": [1, 2], "max_tokens": 60})))
        long.start()
        while server.stats["waves"] < 1:
            time.sleep(0.01)
        out["short"] = _post(url, {"prompt": [9, 8, 7], "max_tokens": 5})
        out["penalized"] = _post(url, {"prompt": [9, 8], "max_tokens": 3, "repetition_penalty": 1.5})
        long.join(timeout=120)
        assert not long.is_alive()
    finally:
        server.stop()
    twin = _engine(params)
    assert out["short"][1]["choices"][0]["tokens"] == twin.generate([[9, 8, 7]], max_new_tokens=5)[0].tokens
    assert out["penalized"][0] == 200 and len(out["penalized"][1]["choices"][0]["tokens"]) == 3
    assert server.stats["admitted"] >= 1 and server.stats["waves"] >= 2


# -- against the JAX package's server ------------------------------------------

LOGIT_TOL = 0.2  # test_torch_engine.py's


@pytest.fixture(scope="module")
def both(params):
    """(JAX server's URL, the port's URL, JAX weights, JAX config, the port's
    server), both over batch-2 engines with the same weights and ToyTokenizer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = jconfigs.TINY_TEST
    jparams = jllama.init_params(cfg, seed=0)
    jserver = JaxCompletionServer(JaxEngine(jparams, cfg, batch_size=2, eos_token=-1), tokenizer=ToyTokenizer())
    tserver = CompletionServer(_engine(params), tokenizer=ToyTokenizer())
    urls = [f"http://127.0.0.1:{srv.start(port=0)}" for srv in (jserver, tserver)]
    yield urls[0], urls[1], jparams, cfg, tserver
    jserver.stop()
    tserver.stop()
    torch.set_num_threads(threads)


def _shape(x, key=None):
    """A JSON value's structure: dicts by their keys, lists by their items,
    a top_logprobs row by its size, anything else by its type."""
    if key == "top_logprobs" and isinstance(x, list):
        return [len(row) for row in x]
    if isinstance(x, dict):
        return {k: _shape(v, k) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    return type(x).__name__


def _agree(jparams, cfg, prompt, got, want):
    """Tokens equal up to the first step whose JAX top-2 gap is within
    LOGIT_TOL; returns that step (or the length)."""
    seq = list(prompt) + list(want)
    logits, _ = jllama.prefill(jparams, cfg, jax.numpy.asarray([seq], jax.numpy.int32))
    rows = np.asarray(logits[0], np.float32)[len(prompt) - 1:]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            top2 = np.sort(rows[i])[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL, f"diverged at step {i} where JAX's choice was clear"
            return i
    assert len(got) == len(want)
    return len(got)


_CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello"}]
_GREEDY_BODIES = [
    ("/v1/completions", {"prompt": [3, 5, 7], "max_tokens": 6}),
    ("/v1/completions", {"prompt": "hi!", "max_tokens": 4}),
    ("/v1/completions", {"prompt": [2, 4, 6], "max_tokens": 4, "logprobs": 3}),
    ("/v1/completions", {"prompt": [2, 4, 6], "max_tokens": 4, "logprobs": True}),
    ("/v1/chat/completions", {"messages": _CHAT, "max_tokens": 5}),
    ("/v1/chat/completions", {"messages": _CHAT, "max_tokens": 3, "logprobs": True, "top_logprobs": 2}),
    ("/v1/completions", {"prompt": [3, 5, 7], "max_tokens": 4, "stream": True}),
    ("/v1/chat/completions", {"messages": _CHAT, "max_tokens": 3, "stream": True}),
]


@pytest.mark.parametrize("path,body", _GREEDY_BODIES)
def test_greedy_bodies_match_the_jax_server(both, path, body):
    """Completions (token ids, a string), logprobs as an int and as a bool,
    chat through the generic template fallback
    with and without logprobs, and both streams: the JAX server's payload
    keys, finish reasons, usage and prompt tokens, its tokens under the
    near-tie rule and its logprobs within LOGIT_TOL."""
    jurl, turl, jparams, cfg, tserver = both
    jcode, want = _post(jurl, body, path=path)
    tcode, got = _post(turl, body, path=path)
    assert jcode == tcode == 200
    assert _shape(got) == _shape(want)
    chat = path.endswith("chat/completions")
    prompt = tserver.chat_tokens(body) if chat else (ToyTokenizer().encode(body["prompt"])
                                                       if isinstance(body["prompt"], str) else body["prompt"])
    if body.get("stream"):
        tokens = lambda events: [e["choices"][0]["token"] if chat else e["token"] for e in events]  # noqa: E731
        _agree(jparams, cfg, prompt, tokens(got), tokens(want))
        return
    assert got["usage"] == want["usage"] and got["usage"]["prompt_tokens"] == len(prompt)
    g, w = got["choices"][0], want["choices"][0]
    assert g["finish_reason"] == w["finish_reason"]
    upto = _agree(jparams, cfg, prompt, g["tokens"], w["tokens"])
    if "logprobs" in w:
        np.testing.assert_allclose(g["logprobs"]["token_logprobs"][:upto], w["logprobs"]["token_logprobs"][:upto],
                                   atol=LOGIT_TOL)
        for grow, wrow in zip(g["logprobs"].get("top_logprobs", [])[:upto], w["logprobs"].get("top_logprobs", [])):
            assert abs(max(grow.values()) - max(wrow.values())) <= LOGIT_TOL


def test_chat_fallback_prompt_equals_the_jax_server(both):
    """The generic chat template gives the JAX server's prompt tokens."""
    _, _, _, _, tserver = both
    jserver = JaxCompletionServer.__new__(JaxCompletionServer)
    jserver.tokenizer = ToyTokenizer()
    for messages in (_CHAT, [{"role": "user", "content": "x"}], _CHAT + [{"role": "assistant", "content": "ok"}]):
        body = {"messages": messages}
        assert tserver.chat_tokens(body) == JaxCompletionServer.chat_tokens(jserver, body)


@pytest.mark.parametrize("body", [
    {},
    {"temperature": 0.7, "top_k": 5, "top_p": 0.9, "min_p": 0.05, "seed": 3, "max_tokens": 9, "min_tokens": 2},
    {"repetition_penalty": 1.2, "presence_penalty": 0.5, "frequency_penalty": 0.25, "stop": [4, 2]},
    {"logit_bias": {"17": -100, "3": 0.5}, "logprobs": 3},
    {"logprobs": True, "top_logprobs": 2},
    {"logprobs": True},
    {"logprobs": False, "top_logprobs": 4, "seed": None},
])
def test_request_fields_parse_as_the_jax_servers(body):
    """Every body field gives the JAX server's SamplingParams, with the
    seed offset choice i of ``n`` takes."""
    import dataclasses

    from nf4_tpu.serve.api import _params_from_body as jax_params
    from nf4_tpu_torch.serve.api import _params_from_body

    for offset in (0, 2):
        assert dataclasses.asdict(_params_from_body(body, offset)) == dataclasses.asdict(jax_params(body, offset))


def test_n_with_seed_has_the_jax_servers_shape(both):
    """``n`` seeded stochastic choices: the JAX server's payload shape,
    indexes, finish reasons and usage (the draws themselves differ); the
    port's choices are reproducible and differ from each other."""
    jurl, turl, _, _, _ = both
    body = {"prompt": [2, 4, 6], "max_tokens": 5, "n": 2, "seed": 3, "temperature": 0.9}
    (jcode, want), (tcode, got) = _post(jurl, body), _post(turl, body)
    assert jcode == tcode == 200 and _shape(got) == _shape(want) and got["usage"] == want["usage"]
    assert [(c["index"], c["finish_reason"]) for c in got["choices"]] == \
        [(c["index"], c["finish_reason"]) for c in want["choices"]]
    again = _post(turl, body)[1]
    assert [c["tokens"] for c in again["choices"]] == [c["tokens"] for c in got["choices"]]
    assert got["choices"][0]["tokens"] != got["choices"][1]["tokens"]


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", b"{nope"),
    ("/v1/completions", {"max_tokens": 3}),
    ("/v1/completions", {"prompt": 5}),
    ("/v1/completions", {"prompt": [1, 2], "n": 0}),
    ("/v1/completions", {"prompt": [1, 2], "max_tokens": "x"}),
    ("/v1/completions", {"prompt": [1, 2], "logit_bias": {"x": 1}}),
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": [{"role": "user"}]}),
    ("/v1/nope", {"prompt": [1]}),
])
def test_bad_bodies_get_the_jax_servers_status(both, path, body):
    jurl, turl, _, _, _ = both
    (jcode, want), (tcode, got) = _post(jurl, body, path=path), _post(turl, body, path=path)
    assert jcode == tcode and jcode in (400, 404) and set(got) == set(want) == {"error"}
