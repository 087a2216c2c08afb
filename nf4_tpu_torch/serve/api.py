"""HTTP serving front door: an OpenAI-style completions endpoint.

The port of the JAX package's ``serve/api.py``.  Stdlib-only
(``http.server`` + threads), on top of :class:`serve.engine.Engine`:

* ``POST /v1/completions`` — ``{"prompt": [ids] | "text", "max_tokens",
  "temperature", "top_k", "top_p", "min_p", "repetition_penalty",
  "presence_penalty", "frequency_penalty", "logit_bias": {"id": bias},
  "stop": [ids], "min_tokens", "seed": int, "n": int, "logprobs": bool |
  int, "top_logprobs": int, "guided_choice": [[ids] | "text", ...],
  "stream": bool, "echo": bool}``.  ``echo`` puts the prompt before the
  completion's tokens and, with ``logprobs``, the prompt's teacher-forced
  log-probabilities (``Engine.score``) before the completion's:
  ``token_logprobs`` is ``[None] + prompt + completion``, and
  ``top_logprobs`` has ``None`` at the prompt's positions.  ``echo`` with
  ``max_tokens: 0`` scores the prompt and generates nothing.  String
  prompts need the server to be constructed with a tokenizer (anything with ``encode(str) -> ids`` /
  ``decode(ids) -> str`` — a HF tokenizer fits).  ``seed`` makes the
  response reproducible (choice ``i`` of ``n`` uses ``seed + i``).
* ``POST /v1/chat/completions`` — same sampling fields with
  ``"messages": [{"role", "content"}, ...]``.  The prompt is rendered by
  the tokenizer's ``apply_chat_template`` when it has one (HF
  tokenizers), else by a minimal generic template; responses carry the
  OpenAI chat shape (``message.content``; streaming sends
  ``delta.content`` chunks).
* ``GET /v1/models`` (the base model's name and every adapter's),
  ``GET /health`` and ``GET /metrics`` (Prometheus text).
* Multi-LoRA model routing: with ``adapters={name: bank index}`` over an
  ``Engine(lora_bank=)``, a request's ``"model"`` names the adapter that
  serves it (the base model's name, or none, serves the base); an unknown
  name is a 400.  Requests of different adapters batch into one wave, and
  their ``echo`` scores run through the same adapters.
* ``"stream": true`` responds with server-sent events (one ``data:`` JSON
  line per token, then ``data: [DONE]``), fed by the engine's
  ``on_token`` callback.  A client that goes away (its socket closes, or a
  write fails) cancels its request: the engine retires it at its next
  host sync, within one decode chunk.

Scheduling: HTTP handler threads enqueue requests; ONE dispatcher thread
drains the queue and runs each wave as a single ``Engine.generate`` call
with per-request SamplingParams.  Requests arriving while a wave runs join
it through the engine's ``admit`` hook whenever a slot frees up, provided
the running call can serve them (``Engine.admissible``); the rest lead the
next wave.  All CUDA work stays on the dispatcher thread (a CUDA call from
another thread while a decode graph is being captured would invalidate
the capture); handler threads only parse, tokenize, wait and serialize.
Scoring-only requests (``echo`` with ``max_tokens: 0``) never generate and
never join a running wave; a wave's ``echo`` + ``logprobs`` requests are
scored in one batched ``Engine.score`` after its ``generate``.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import select
import socket
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

from .engine import MAX_TOP_LOGPROBS, Engine, GenerationResult
from .sampling import SamplingParams

__all__ = ["CompletionServer", "serve_http"]


@dataclasses.dataclass
class _Pending:
    """One queued completion request and its rendezvous state."""

    tokens: List[int]
    params: SamplingParams
    logprobs: bool
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Any = None
    error: Optional[str] = None
    # Streaming: tokens are pushed here as emitted; None terminates.
    stream_q: Optional[queue.Queue] = None
    # Set when the client goes away; the dispatcher's cancel callback
    # reports it to the engine, which takes no more of its tokens and
    # frees the slot at its next host sync.  ``emitted`` counts the tokens
    # handed to on_token so far.
    cancelled: bool = False
    emitted: int = 0
    # OpenAI "echo": the prompt (and, with logprobs, its teacher-forced
    # logprobs) in the response; with max_tokens=0, scoring only.
    echo: bool = False
    prompt_logprobs: Optional[List[float]] = None
    # The bank index of the adapter serving the request (None: the base
    # model), from its "model" field.
    adapter: Optional[int] = None


def _params_from_body(body: Dict[str, Any], seed_offset: int = 0) -> SamplingParams:
    seed = body.get("seed")
    # OpenAI wire formats: classic completions take an INTEGER "logprobs"
    # (top-k alternatives per position); chat takes "logprobs": true plus
    # "top_logprobs": k.  A bare true records only the chosen token's
    # logprob (the engine's return_logprobs) with no alternatives.
    lp = body.get("logprobs", 0)
    top_k_lp = int(body.get("top_logprobs", 0) or 0)
    if not isinstance(lp, bool) and isinstance(lp, int):
        top_k_lp = max(top_k_lp, lp)
    return SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        # OpenAI wire format: {"<token_id>": bias} (JSON keys are strings).
        logit_bias=tuple(sorted((int(t), float(b)) for t, b in (body.get("logit_bias") or {}).items())),
        stop_tokens=tuple(int(t) for t in body.get("stop", ()) or ()),
        max_new_tokens=int(body.get("max_tokens", 64)),
        min_new_tokens=int(body.get("min_tokens", 0) or 0),
        # "n" completions with a seed get distinct derived seeds so the
        # whole response is reproducible; unseeded choices diverge through
        # the engine's shared key stream.
        seed=None if seed is None else int(seed) + seed_offset,
        top_logprobs=top_k_lp,
    )


def _client_gone(sock: socket.socket) -> bool:
    """Has the peer closed ``sock``?  (Readable with nothing to read.)"""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable) and sock.recv(1, socket.MSG_PEEK) == b""
    except OSError:
        return True


class CompletionServer:
    """Engine + dispatcher + HTTP server (see module docstring).

    ``tokenizer`` is optional; without it, prompts must be token-id
    lists and responses carry only token ids.  ``batch_window`` (s): after
    the first request of a fresh wave, wait this long for more before
    launching it, so a burst starts as one wave.  ``adapters`` maps served
    model names to bank indices of an ``Engine(lora_bank=)``."""

    def __init__(
        self,
        engine: Engine,
        tokenizer=None,
        model_name: str = "nf4-tpu",
        max_wave: int = 64,
        adapters: Optional[Dict[str, int]] = None,
        batch_window: float = 0.01,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.max_wave = max_wave
        self.batch_window = batch_window
        self.adapters = dict(adapters or {})
        if self.adapters:
            if getattr(engine, "_bank", None) is None:
                raise ValueError("adapters= requires an Engine built with lora_bank=...")
            bad = {k: v for k, v in self.adapters.items() if not 0 <= v < engine.num_adapters}
            if bad:
                raise ValueError(f"adapter indices out of range [0, {engine.num_adapters}): {bad}")
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._shutdown = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, name="nf4-dispatcher", daemon=True)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "waves": 0, "tokens_out": 0, "admitted": 0, "cancelled": 0, "scored": 0}
        self.port: Optional[int] = None

    def _count(self, name: str, k: int = 1) -> None:
        with self._lock:
            self.stats[name] += k

    # -- dispatcher ---------------------------------------------------------

    def _dispatch_loop(self):
        carry: List[_Pending] = []  # deferred by the previous wave
        while not self._shutdown.is_set():
            wave, carry = carry, []
            if not wave:
                try:
                    wave.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    continue
                deadline = time.monotonic() + self.batch_window
                while len(wave) < self.max_wave:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        wave.append(self._queue.get(timeout=left))
                    except queue.Empty:
                        break
            while len(wave) < self.max_wave:
                try:
                    wave.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            carry = self._run_wave(wave)

    def _run_wave(self, wave: List[_Pending]) -> List[_Pending]:
        """Run one engine call over ``wave``'s generating requests, then
        score its ``echo`` + ``logprobs`` prompts in one batched
        ``Engine.score``.  Requests arriving mid-wave join the call through
        the engine's ``admit`` hook when it can serve them
        (``Engine.admissible``) and they generate; the rest are returned
        deferred, to lead the next wave.  The engine's request indices are
        positions in ``gen_wave``, the wave's generating requests."""
        self._count("waves")
        deferred: List[_Pending] = []
        gen_wave = [p for p in wave if p.params.max_new_tokens != 0]

        def on_token(req_idx: int, tok: int):
            p = gen_wave[req_idx]
            p.emitted += 1
            if p.stream_q is not None:
                if p.cancelled:
                    # The SSE handler returned on disconnect and nothing
                    # will drain this queue again.
                    p.stream_q = None
                    return
                p.stream_q.put(tok)

        def cancel(req_idx: int) -> bool:
            """Engine request indices are gen_wave positions (admitted
            requests are appended to it and to the wave)."""
            return gen_wave[req_idx].cancelled

        def admit(features):
            """Drain the HTTP queue into the running engine call."""
            admitted = []
            while len(gen_wave) < self.max_wave:
                try:
                    p = self._queue.get_nowait()
                except queue.Empty:
                    break
                if p.params.max_new_tokens == 0 or not Engine.admissible(features, p.tokens, p.params,
                                                                         logprobs=p.logprobs, adapter=p.adapter):
                    deferred.append(p)
                    continue
                gen_wave.append(p)
                wave.append(p)
                admitted.append((p.tokens, p.params, p.adapter))
                self._count("admitted")
            return admitted

        # The engine's pipelined chunk loop polls this between chunks and
        # breaks out to refill an idle slot as soon as a request waits.
        admit.peek = lambda: not self._queue.empty()

        def adapters(ps):
            """The requests' adapters for the engine, None when all are the base's."""
            return [p.adapter for p in ps] if any(p.adapter is not None for p in ps) else None

        try:
            for p in wave:
                if p.params.max_new_tokens == 0:
                    p.result = GenerationResult(list(p.tokens), [], True, [])
            results = []
            if gen_wave:
                results = self.engine.generate(
                    [p.tokens for p in gen_wave],
                    # Per-request budgets ride SamplingParams.max_new_tokens;
                    # the call-level value is a fallback.
                    max_new_tokens=max(p.params.max_new_tokens or 64 for p in gen_wave),
                    sampling=[p.params for p in gen_wave],
                    adapter=adapters(gen_wave),
                    return_logprobs=any(p.logprobs for p in gen_wave),
                    # Always wired: a request admitted mid-wave may stream
                    # even when none of the initial ones do.
                    on_token=on_token,
                    admit=admit,
                    cancel=cancel,
                )
            # The prompts' logprobs of echo + logprobs requests, one
            # batched teacher-forced pass.
            need = [p for p in wave if p.echo and p.logprobs]
            if need:
                for p, lp in zip(need, self.engine.score([p.tokens for p in need], adapter=adapters(need))):
                    p.prompt_logprobs = lp
                self._count("scored", len(need))
        except Exception as e:  # the dispatcher keeps serving: report to every waiter
            traceback.print_exc(file=sys.stderr)
            for p in wave:
                p.error = f"{type(e).__name__}: {e}"
                if p.stream_q is not None:
                    p.stream_q.put(None)
                p.done.set()
            return deferred
        for p, r in zip(gen_wave, results):
            p.result = r
            self._count("tokens_out", len(r.tokens))
            # A socket can close after its request finished normally; only
            # an unfinished result was cut short by the cancel.
            if p.cancelled and not r.finished:
                self._count("cancelled")
        for p in wave:
            if p.stream_q is not None:
                p.stream_q.put(None)
            p.done.set()
        return deferred

    # -- request entry ------------------------------------------------------

    def submit(self, body: Dict[str, Any], seed_offset: int = 0, tokens: Optional[List[int]] = None) -> _Pending:
        if tokens is None:
            prompt = body.get("prompt")
            if isinstance(prompt, str):
                if self.tokenizer is None:
                    raise ValueError("string prompt but the server has no tokenizer; send token ids")
                tokens = list(self.tokenizer.encode(prompt))
            elif isinstance(prompt, (list, tuple)) and all(isinstance(t, int) for t in prompt):
                tokens = list(prompt)
            else:
                raise ValueError("prompt must be a string or a list of token ids")
        model = body.get("model")
        adapter = None
        # Without an adapter map the field is informational (OpenAI SDKs
        # always send one); with one it routes, and an unknown name is the
        # client's error.
        if model is not None and model != self.model_name and self.adapters:
            if model not in self.adapters:
                raise ValueError(f"unknown model {model!r}; served models: {[self.model_name, *self.adapters]}")
            adapter = self.adapters[model]
        vocab = self.engine.cfg.vocab_size
        if not all(0 <= t < vocab for t in tokens):
            raise ValueError(f"prompt token ids must be in [0, {vocab})")
        echo = bool(body.get("echo", False))
        if echo and len(tokens) > self.engine.cfg.max_seq_len:
            raise ValueError(f"prompt length {len(tokens)} exceeds the model context {self.engine.cfg.max_seq_len}")
        params = _params_from_body(body, seed_offset)
        if not all(0 <= t < vocab for t, _ in params.logit_bias):
            raise ValueError(f"logit_bias token ids must be in [0, {vocab})")
        if not 0 <= params.top_logprobs <= MAX_TOP_LOGPROBS:
            # An unbounded k would fail the whole wave on the device.
            raise ValueError(f"logprobs/top_logprobs must be in [0, {MAX_TOP_LOGPROBS}]")
        if params.max_new_tokens < 0:
            raise ValueError("max_tokens must be >= 0")
        if params.max_new_tokens == 0 and not echo:
            raise ValueError("max_tokens=0 requires echo=true (scoring)")
        gc = body.get("guided_choice")
        if gc:
            # vLLM-style guided choice: each option is a token-id list, or
            # a string when the server has a tokenizer.
            opts = []
            for c in gc:
                if isinstance(c, str):
                    if self.tokenizer is None:
                        raise ValueError("string guided_choice needs a tokenizer; send token-id lists")
                    opts.append(tuple(self.tokenizer.encode(c)))
                else:
                    opts.append(tuple(int(t) for t in c))
            params = dataclasses.replace(params, choices=tuple(opts))
        pending = _Pending(
            tokens=tokens,
            params=params,
            logprobs=bool(body.get("logprobs", False)) or int(body.get("top_logprobs", 0) or 0) > 0,
            stream_q=queue.Queue() if body.get("stream") else None,
            echo=echo,
            adapter=adapter,
        )
        self._count("requests")
        self._queue.put(pending)
        return pending

    def submit_n(self, body: Dict[str, Any], tokens: Optional[List[int]] = None) -> List[_Pending]:
        """Submit ``n`` independent completions of one prompt (they batch
        into the same wave; with a seed, choice i uses seed+i)."""
        n = int(body.get("n", 1))
        if n < 1:
            raise ValueError("n must be >= 1")
        if n > 1 and body.get("stream"):
            raise ValueError("streaming is single-choice; use n=1")
        return [self.submit(body, seed_offset=i, tokens=tokens) for i in range(n)]

    def chat_tokens(self, body: Dict[str, Any]) -> List[int]:
        """Render ``messages`` to prompt token ids: the tokenizer's own chat
        template when it has one (``apply_chat_template(messages,
        tokenize=True, add_generation_prompt=True) -> ids``), else a
        minimal ChatML-like fallback."""
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m or "content" not in m:
                raise ValueError("each message needs role and content")
        if self.tokenizer is None:
            raise ValueError("chat completions need a tokenizer")
        if hasattr(self.tokenizer, "apply_chat_template"):
            return list(self.tokenizer.apply_chat_template(messages, tokenize=True, add_generation_prompt=True))
        text = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in messages) + "<|assistant|>\n"
        return list(self.tokenizer.encode(text))

    def _decode_text(self, ids: Sequence[int]) -> Optional[str]:
        if self.tokenizer is None:
            return None
        return self.tokenizer.decode(list(ids))

    def _token_key(self, t: int) -> str:
        """Dict key for one token in top_logprobs rows: its decoded text,
        or the stringified id without a tokenizer."""
        txt = self._decode_text([t])
        return txt if txt is not None else str(t)

    def _choice(self, p: _Pending, index: int) -> Dict[str, Any]:
        r = p.result
        out_tokens = (list(p.tokens) if p.echo else []) + list(r.tokens)
        if r.finished:
            finish = "stop"
        elif p.cancelled:
            finish = "abort"  # cut short by a client disconnect (vLLM's name)
        else:
            finish = "length"
        choice: Dict[str, Any] = {"index": index, "tokens": out_tokens, "finish_reason": finish}
        text = self._decode_text(out_tokens)
        if text is not None:
            choice["text"] = text
        if p.echo and p.logprobs:
            # The first prompt token has no conditional probability (null),
            # then the prompt's teacher-forced logprobs, then the
            # completion's; alternatives exist for generated positions only.
            lp_block = {"token_logprobs": [None] + list(p.prompt_logprobs or []) + list(r.logprobs or [])}
            if r.top_logprobs is not None:
                lp_block["top_logprobs"] = [None] * len(p.tokens) + [
                    {self._token_key(t): v for t, v in row} for row in r.top_logprobs]
            choice["logprobs"] = lp_block
        elif r.logprobs is not None and p.logprobs:
            lp_block: Dict[str, Any] = {"token_logprobs": list(r.logprobs)}
            if r.top_logprobs is not None:
                # OpenAI shape: one {token: logprob} dict per position.
                lp_block["top_logprobs"] = [{self._token_key(t): v for t, v in row} for row in r.top_logprobs]
            choice["logprobs"] = lp_block
        return choice

    def completion_payload(self, pendings: Sequence[_Pending], chat: bool = False) -> Dict[str, Any]:
        out = sum(len(p.result.tokens) for p in pendings)
        choices = [self._choice(p, i) for i, p in enumerate(pendings)]
        if chat:
            for c in choices:
                c["message"] = {"role": "assistant", "content": c.pop("text", None)}
        return {
            "object": "chat.completion" if chat else "text_completion",
            "model": self.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": len(pendings[0].tokens),
                "completion_tokens": out,
                "total_tokens": len(pendings[0].tokens) + out,
            },
        }

    def metrics_text(self) -> str:
        """The Prometheus text exposition of the server's and the engine's
        counters."""
        eng = self.engine
        with self._lock:
            stats = dict(self.stats)
        rows = [
            ("requests_total", "counter", stats["requests"]),
            ("waves_total", "counter", stats["waves"]),
            ("tokens_out_total", "counter", stats["tokens_out"]),
            ("admitted_total", "counter", stats["admitted"]),
            ("cancelled_total", "counter", stats["cancelled"]),
            ("scored_total", "counter", stats["scored"]),
            ("graphs_captured_total", "counter", eng.graph_stats["captured"]),
            ("graph_replays_total", "counter", eng.graph_stats["replayed"]),
            ("pipeline_launched_total", "counter", eng.pipeline_stats["launched"]),
            ("pipeline_discarded_total", "counter", eng.pipeline_stats["discarded"]),
            ("spec_steps_total", "counter", eng.spec_stats["steps"]),
            ("spec_emitted_total", "counter", eng.spec_stats["emitted"]),
            ("prefix_tokens_saved_total", "counter", eng.prefix_stats.get("tokens_saved", 0)),
            ("batch_slots", "gauge", eng.batch_size),
        ]
        # Over ranks (serve/ranks.py): the control channel's waves, polls
        # and seconds, and the seconds its waves took.
        rows += [(f"channel_{name}_total", "counter", value)
                 for name, value in getattr(eng, "channel_stats", {}).items()]
        return "".join(f"# TYPE nf4tpu_{name} {kind}\nnf4tpu_{name} {value}\n" for name, kind, value in rows)

    # -- lifecycle ----------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 8000) -> int:
        """Start the dispatcher and HTTP server (non-blocking); returns the
        bound port (pass ``port=0`` for an ephemeral one)."""
        self._dispatcher.start()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # the engine is the interesting part
                pass

            def _json(self, code: int, payload: Dict[str, Any]):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/health":
                    with server._lock:
                        stats = dict(server.stats)
                    self._json(200, {"status": "ok", **stats})
                elif self.path == "/metrics":
                    body = server.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/v1/models":
                    names = (server.model_name, *server.adapters)
                    self._json(200, {"object": "list", "data": [{"id": n, "object": "model"} for n in names]})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                chat = self.path == "/v1/chat/completions"
                if self.path != "/v1/completions" and not chat:
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("the body must be a JSON object")
                    tokens = server.chat_tokens(body) if chat else None
                    pendings = server.submit_n(body, tokens=tokens)
                except (ValueError, TypeError) as e:  # json.JSONDecodeError is a ValueError
                    self._json(400, {"error": str(e)})
                    return
                pending = pendings[0]
                if pending.stream_q is None:
                    for p in pendings:
                        p.done.wait()
                    errs = [p.error for p in pendings if p.error is not None]
                    if errs:
                        self._json(500, {"error": errs[0]})
                    else:
                        self._json(200, server.completion_payload(pendings, chat=chat))
                    return
                self._stream(pending, chat)

            def _stream(self, pending: _Pending, chat: bool):
                """SSE: one data: line per emitted token."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                while True:
                    try:
                        tok = pending.stream_q.get(timeout=0.02)
                    except queue.Empty:
                        if _client_gone(self.connection):
                            pending.cancelled = True
                            return
                        continue
                    if tok is None:
                        break
                    text = server._decode_text([int(tok)])
                    if chat:
                        chunk = {"object": "chat.completion.chunk",
                                 "choices": [{"index": 0, "delta": {"content": text}, "token": int(tok)}]}
                    else:
                        chunk = {"token": int(tok)}
                        if text is not None:
                            chunk["text"] = text
                    try:
                        self.wfile.write(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                        self.wfile.flush()
                    except OSError:
                        # The client went away mid-stream: the dispatcher's
                        # cancel callback retires its slot.
                        pending.cancelled = True
                        return
                pending.done.wait()
                if pending.error is not None:
                    self.wfile.write(b"data: " + json.dumps({"error": pending.error}).encode() + b"\n\n")
                self.wfile.write(b"data: [DONE]\n\n")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._httpd.serve_forever, name="nf4-http", daemon=True).start()
        self.port = self._httpd.server_address[1]
        return self.port

    def stop(self):
        """Stop the HTTP server and the dispatcher (after its wave)."""
        self._shutdown.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._dispatcher.is_alive():
            self._dispatcher.join()


def serve_http(engine: Engine, tokenizer=None, host: str = "127.0.0.1", port: int = 8000,
               model_name: str = "nf4-tpu") -> CompletionServer:
    """Convenience constructor: build, start, and return the server."""
    server = CompletionServer(engine, tokenizer, model_name=model_name)
    server.start(host, port)
    return server
