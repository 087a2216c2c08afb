"""The serving CLI over ranks (``python -m nf4_tpu_torch.serve --tp N --dp
M``, ``serve/ranks.py``) on the CPU: a subprocess on ``--device cpu`` whose
ranks are processes joined over gloo, serving ``TINY_TP`` from a
checkpoint the JAX package's ``save_packed`` wrote with tp_shards = 2.

* At ``--tp 2`` (shard-on-read) and ``--tp 1 --dp 2`` (the checkpoint
  repacked to tp_shards 1 in memory), greedy answers equal the JAX CLI's
  ``build_engine`` on the same arguments over its 8-device CPU mesh, and
  ``Engine(mesh=)`` driven through ``Ranks``, under the near-tie rule (a
  difference must start where the JAX logits' top-2 gap is at most 2e-2).
* A request admitted into a running call (``/metrics`` ``admitted``) and
  a stream closed mid-call (``cancelled``) leave every rank in step: no
  wave fails its digest check, both answers equal the same requests
  served alone, and the server answers afterwards.
* A prompt past ``max_seq_len`` and an ``echo`` + ``logprobs`` request
  (``Engine.score`` over a mesh) are answered as the JAX CLI's server
  answers them, and the server goes on serving.
* SIGTERM stops the server and every rank (exit 0); a rank that dies ends
  the server (exit 1); no rank process outlives it.
* ``--draft-model`` over ranks is refused as the JAX CLI refuses it,
  before any rank starts.
* The JAX CLI at ``--tp 1 --dp 2`` refuses a checkpoint packed for
  tp_shards 2, which the port repacks (ROADMAP section 3).
"""

import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import _torch_dist as td
from nf4_tpu.models import configs as jconfigs
from nf4_tpu.models import llama as jllama
from nf4_tpu.models.loader import save_packed as jax_save_packed
from nf4_tpu.serve.__main__ import main as jax_main
from nf4_tpu_torch.models import configs
from nf4_tpu_torch.parallel.launch import Ranks
from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[3, 1, 4, 1, 5], [11, 13], [200, 100, 50, 25]]
NEW = 6
NEAR_TIE = 2e-2
FLAGS = ["--port", "0", "--batch-size", "2", "--eos", "-1", "--model-name", "tiny-tp"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The JAX package's TINY_TP weights (seed 0) packed for tp_shards 2, and
    the same weights packed for tp_shards 1: (paths, params by tp_shards)."""
    tmp = tmp_path_factory.mktemp("ranks")
    paths, params = {}, {}
    for shards in (2, 1):
        cfg = dataclasses.replace(jconfigs.TINY_TP, tp_shards=shards)
        params[shards] = jllama.init_params(cfg, seed=0)
        paths[shards] = str(tmp / f"tp{shards}.npz")
        jax_save_packed(paths[shards], params[shards], cfg)
    return paths, params


@pytest.fixture(scope="module")
def ranks():
    with Ranks(2, backend="gloo", device="cpu", threads=1, timeout=td.RUN_TIMEOUT_S) as r:
        yield r


class Server:
    """``python -m nf4_tpu_torch.serve`` as a subprocess, its port read from
    its "serving on" line."""

    def __init__(self, argv):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen([sys.executable, "-m", "nf4_tpu_torch.serve", *argv], cwd=ROOT, env=env,
                                     stderr=subprocess.PIPE, text=True)
        self.log = []
        while True:
            line = self.proc.stderr.readline()
            if not line:
                raise RuntimeError(f"the server exited ({self.proc.wait()}): {''.join(self.log)}")
            self.log.append(line)
            m = re.search(r"serving on http://[^:]+:(\d+)", line)
            if m:
                self.port = int(m.group(1))
                break
        threading.Thread(target=lambda: self.log.extend(self.proc.stderr), daemon=True).start()
        self.children = [int(p) for p in subprocess.run(["pgrep", "-P", str(self.proc.pid)], capture_output=True,
                                                         text=True).stdout.split()]

    def metrics(self) -> dict:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/metrics", timeout=60) as r:
            rows = [ln.split() for ln in r.read().decode().splitlines() if not ln.startswith("#")]
        return {name.removeprefix("nf4tpu_"): float(v) for name, v in rows}

    def alive(self) -> list:
        return [p for p in [self.proc.pid, *self.children] if os.path.exists(f"/proc/{p}")
                and "zombie" not in open(f"/proc/{p}/status").read()]


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _tokens(port, prompt, n=NEW):
    code, body = _post(port, {"prompt": prompt, "max_tokens": n})
    assert code == 200, body
    return body["choices"][0]["tokens"]


class _Stream:
    """A streamed request on a raw socket: :meth:`first` reads its first SSE
    event; :meth:`rest` reads to ``[DONE]``; :meth:`close` hangs up."""

    def __init__(self, port, body):
        data = json.dumps(dict(body, stream=True)).encode()
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                          b"Content-Length: %d\r\n\r\n" % len(data) + data)
        self.buf = b""

    def _events(self):
        return [e[6:] for e in self.buf.decode().split("\n") if e.startswith("data: ")]

    def first(self):
        while b"\n\n" not in self.buf:  # one whole event (the headers end in CR LF pairs)
            self.buf += self.sock.recv(4096)
        return self._events()

    def rest(self):
        while b"data: [DONE]" not in self.buf:
            chunk = self.sock.recv(4096)
            assert chunk, "the stream ended without [DONE]"
            self.buf += chunk
        self.sock.close()
        return [json.loads(e)["token"] for e in self._events()[:-1]]

    def close(self):
        self.sock.close()


def _agree_until_near_tie(params, jcfg, prompts, got, want):
    """Each request's tokens equal the reference's, or first differ where the
    JAX logits' top-2 gap after the common tokens is at most NEAR_TIE."""
    for prompt, g, w in zip(prompts, got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                seq = jax.numpy.asarray([list(prompt) + list(w[:i])], jax.numpy.int32)
                row = np.asarray(jllama.prefill(params, jcfg, seq)[0], np.float32)[0, -1]
                top2 = np.sort(row)[-2:]
                assert top2[1] - top2[0] <= NEAR_TIE, "diverged where the JAX choice was clear"
                break
        else:
            assert len(g) == len(w) == NEW


def _jax_server(argv):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jax_main(argv, block=False)


@pytest.mark.parametrize("mesh,ending", [((2, 1), "sigterm"), ((1, 2), "rank dies")], ids=["tp2", "tp1xdp2"])
def test_cli_over_ranks(checkpoints, ranks, mesh, ending):
    paths, jparams = checkpoints
    tp, dp = mesh
    argv = ["--packed", paths[2], *FLAGS, "--tp", str(tp), "--dp", str(dp)]
    # The JAX CLI on the same arguments (at tp 1 x dp 2 on the tp_shards = 1
    # pack of the same weights: it refuses the tp_shards = 2 one there).
    jsrv = _jax_server(["--packed", paths[tp], *argv[2:]])
    try:
        want = [r.tokens for r in jsrv.engine.generate(PROMPTS, max_new_tokens=NEW)]
        long_prompt = list(range(40))  # past TINY_TP's max_seq_len of 32
        jax_long = _post(jsrv.port, {"prompt": long_prompt, "max_tokens": 4})
        jax_echo = _post(jsrv.port, {"prompt": PROMPTS[0], "max_tokens": 0, "echo": True, "logprobs": True})
    finally:
        jsrv.stop()
    cfg = dataclasses.replace(configs.TINY_TP, tp_shards=tp)
    mesh_tokens = [t for t, *_ in ranks.run(td.generate_mesh, cfg, 0, PROMPTS, NEW, batch_size=2, tp=tp, dp=dp)][0]

    server = Server(argv + ["--device", "cpu"])
    try:
        assert any(("shard-on-read" if tp == 2 else "repacked tp_shards -> 1") in ln for ln in server.log)
        got = [_tokens(server.port, p) for p in PROMPTS]
        jcfg = dataclasses.replace(jconfigs.TINY_TP, tp_shards=tp)
        _agree_until_near_tie(jparams[tp], jcfg, PROMPTS, got, want)
        _agree_until_near_tie(jparams[tp], jcfg, PROMPTS, got, mesh_tokens)

        # A request admitted while a streamed one runs in the other slot.
        a = _Stream(server.port, {"prompt": [7, 7, 7], "max_tokens": 20})
        a.first()
        b = {}
        t = threading.Thread(target=lambda: b.update(tokens=_tokens(server.port, PROMPTS[0])))
        t.start()
        a_tokens = a.rest()
        t.join(timeout=120)
        assert server.metrics()["admitted_total"] >= 1
        assert b["tokens"] == got[0] and a_tokens == _tokens(server.port, [7, 7, 7], 20)

        # A stream closed after its first token is cancelled on every rank.
        c = _Stream(server.port, {"prompt": [9, 8, 7], "max_tokens": 20})
        c.first()
        c.close()
        end = time.monotonic() + 60
        while server.metrics()["cancelled_total"] < 1 and time.monotonic() < end:
            time.sleep(0.05)
        assert server.metrics()["cancelled_total"] == 1
        assert _tokens(server.port, PROMPTS[1]) == got[1]

        # Answered as the JAX CLI's server answers them, and serving goes on.
        code, body = _post(server.port, {"prompt": long_prompt, "max_tokens": 4})
        assert code == jax_long[0] == 200 and body["choices"] == jax_long[1]["choices"]
        code, body = _post(server.port, {"prompt": PROMPTS[0], "max_tokens": 0, "echo": True, "logprobs": True})
        assert code == jax_echo[0] == 500 and "single-device" in body["error"] and "single-device" in jax_echo[1]["error"]
        assert _tokens(server.port, PROMPTS[2]) == got[2]
        m = server.metrics()
        assert m["channel_waves_total"] >= 8 and m["channel_polls_total"] > 0
        assert len(server.children) == tp * dp - 1
    except BaseException:
        server.proc.kill()
        raise
    if ending == "sigterm":
        server.proc.send_signal(signal.SIGTERM)
        assert server.proc.wait(timeout=120) == 0, "".join(server.log)
    else:
        os.kill(server.children[0], signal.SIGKILL)
        assert server.proc.wait(timeout=120) == 1
        time.sleep(0.5)
        assert any("a rank failed" in ln for ln in server.log)
    end = time.monotonic() + 30
    while server.alive() and time.monotonic() < end:
        time.sleep(0.1)
    assert server.alive() == [], "a rank process outlived the server"


def test_draft_model_over_ranks_is_refused_as_the_jax_cli_refuses_it(checkpoints, monkeypatch):
    """The same message, and no rank starts (``Ranks`` is never made)."""
    from nf4_tpu_torch.parallel import launch
    from nf4_tpu_torch.serve.__main__ import main

    paths, _ = checkpoints
    argv = ["--packed", paths[2], *FLAGS, "--tp", "2", "--spec-k", "3", "--draft-model", "tiny-tp"]
    monkeypatch.setattr(launch, "Ranks", lambda *a, **k: pytest.fail("a rank started"))
    with pytest.raises(SystemExit) as ours:
        main(argv + ["--device", "cpu"], block=False)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    with pytest.raises(AssertionError) as theirs:
        jax_main(argv, block=False)
    assert str(ours.value) == str(theirs.value) == "draft-model speculation is single-device"


def test_the_reference_cli_refuses_a_tp_packed_checkpoint_over_dp(checkpoints):
    """The JAX CLI over a tp = 1 x dp = 2 mesh repacks nothing (its rule is
    tp > 1) and its Engine then refuses the tp_shards = 2 checkpoint; the
    port repacks it to tp_shards 1 (``test_cli_over_ranks[tp1xdp2]``)."""
    paths, _ = checkpoints
    with pytest.raises(AssertionError, match="row-parallel weight must be packed with shards=1, got 2"):
        _jax_server(["--packed", paths[2], *FLAGS, "--tp", "1", "--dp", "2"])
