"""Serving CLI: load a checkpoint and expose the OpenAI-compatible HTTP API.

    # packed artifact (self-describing; from save_packed of either package)
    python -m nf4_tpu_torch.serve --packed llama-nf4.npz --port 8000

    # the int8 serving mode: weights recoded to int8, an int8 KV cache
    python -m nf4_tpu_torch.serve --packed llama-nf4.npz --int8 --kv8

    # an HF checkpoint directory, quantized on the card as it loads (a
    # "*-bnb-4bit" one repacked); its tokenizer files, if any, serve too
    python -m nf4_tpu_torch.serve --hf-dir /path/to/llama

    # registry config with random weights (load test / smoke)
    python -m nf4_tpu_torch.serve --model llama3-8b --synthetic

    # speculative decoding: prompt-lookup drafts, or a draft model's
    python -m nf4_tpu_torch.serve --packed llama-nf4.npz --spec-k 3
    python -m nf4_tpu_torch.serve --packed llama-nf4.npz --spec-k 3 --draft-packed draft-nf4.npz

Endpoints (``serve/api.py``): ``/v1/completions``,
``/v1/chat/completions`` (incl. ``"stream": true`` SSE), ``/v1/models``,
``/health``, ``/metrics`` (Prometheus).  A tokenizer directory
(``--tokenizer``, by default ``--hf-dir``) enables string prompts and chat
templating; without one the API accepts token-id lists.  The server runs on the CUDA card;
``--device cpu`` runs the plain PyTorch path (tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

# Flags of the JAX package's CLI whose machinery is not ported yet: each
# parses, and exits with a clear message when set.
_UNPORTED = {
    "prefix_cache": "--prefix-cache (shared-prefix prefill)",
}


def build_engine(args):
    """Construct (engine, tokenizer) from parsed CLI args."""
    from ..models import configs
    from ..models.llama import recode_params_int8
    from ..models.loader import hf_config_to_llama, load_hf_llama, load_packed_auto
    from ..models.synthetic import synthetic_params
    from .engine import Engine
    from .sampling import SamplingParams

    for name, what in _UNPORTED.items():
        if getattr(args, name):
            raise SystemExit(f"{what} is not ported yet")
    if args.tp > 1 or args.dp > 1:
        raise SystemExit("--tp / --dp > 1 (multi-GPU serving) is not ported yet")
    if sum(map(bool, (args.packed, args.hf_dir, args.synthetic))) != 1:
        raise SystemExit("pick exactly one weight source: --packed PATH, --hf-dir DIR, or --model NAME --synthetic")

    overrides = {}
    if args.kv8:
        overrides["kv_quant"] = True
    if args.max_seq_len:
        overrides["max_seq_len"] = args.max_seq_len

    t0 = time.monotonic()
    if args.packed:
        params, cfg = load_packed_auto(args.packed, device=args.device, **overrides)
        src = args.packed
    elif args.hf_dir:
        # Quantized on load, on the serving device.
        if args.model:
            cfg = dataclasses.replace(configs.get_config(args.model), **overrides)
        else:
            cfg = hf_config_to_llama(os.path.join(args.hf_dir, "config.json"), **overrides)
        params, cfg = load_hf_llama(args.hf_dir, cfg, device=args.device)
        src = args.hf_dir
    else:
        if not args.model:
            raise SystemExit("--synthetic requires --model NAME")
        cfg = dataclasses.replace(configs.get_config(args.model), **overrides)
        params = synthetic_params(cfg, seed=0, device=args.device)
        src = f"synthetic:{args.model}"
    print(f"weights: {src} ({time.monotonic() - t0:.1f}s)", file=sys.stderr)

    if args.int8:
        t0 = time.monotonic()
        params = recode_params_int8(params)
        print(f"int8 recode: {time.monotonic() - t0:.1f}s (2x weight bytes; values stay on the NF4 grid)",
              file=sys.stderr)

    tokenizer = None
    tok_dir = args.tokenizer or args.hf_dir
    if tok_dir:
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(tok_dir)
        except (ImportError, OSError, ValueError) as e:  # no transformers / no tokenizer files
            print(f"tokenizer unavailable ({e}); token-id API only", file=sys.stderr)

    eos = args.eos
    if eos is None:
        eos = getattr(tokenizer, "eos_token_id", None)
    if eos is None:
        eos = 2  # Llama convention

    draft = None
    if args.draft_packed or args.draft_model:
        if args.spec_k <= 0:
            raise SystemExit("--draft-* requires --spec-k > 0")
        t0 = time.monotonic()
        # The draft covers the target's context.
        if args.draft_packed:
            dparams, dcfg = load_packed_auto(args.draft_packed, device=args.device, max_seq_len=cfg.max_seq_len)
            dsrc = args.draft_packed
        else:  # --draft-model NAME: synthetic draft weights (testing)
            dcfg = dataclasses.replace(configs.get_config(args.draft_model), max_seq_len=cfg.max_seq_len)
            dparams = synthetic_params(dcfg, seed=0, device=args.device)
            dsrc = f"synthetic:{args.draft_model}"
        draft = (dparams, dcfg)
        print(f"draft model: {dsrc} ({time.monotonic() - t0:.1f}s)", file=sys.stderr)

    engine = Engine(
        params,
        cfg,
        batch_size=args.batch_size,
        eos_token=int(eos),
        sampling=SamplingParams(temperature=args.temperature),
        decode_chunk=args.decode_chunk,
        device=args.device,
        spec_k=args.spec_k,
        draft=draft,
    )
    return engine, tokenizer


def main(argv=None, block=True):
    ap = argparse.ArgumentParser(prog="python -m nf4_tpu_torch.serve")
    src = ap.add_argument_group("weights (pick one)")
    src.add_argument("--packed", help="packed checkpoint (.npz/.safetensors) from save_packed")
    src.add_argument("--hf-dir", help="HF checkpoint dir (dense: quantized on load; *-bnb-4bit: repacked)")
    src.add_argument("--synthetic", action="store_true",
                     help="random packed weights for --model (smoke/load test): models/synthetic.py's "
                     "synthetic_params, whose draws differ from the JAX package's init_params")
    ap.add_argument("--model", default=None,
                    help="registry config name (models/configs.py); required with --synthetic; with --hf-dir it "
                    "replaces config.json")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer dir (needs transformers; default --hf-dir); enables string prompts + chat "
                    "templates")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--model-name", default="nf4-tpu", help="model id reported by /v1/models")
    ap.add_argument("--batch-size", type=int, default=8, help="continuous-batching slot count")
    ap.add_argument("--max-seq-len", type=int, default=None, help="KV-cache length cap (defaults to the config's)")
    ap.add_argument("--int8", action="store_true",
                    help="int8-recode serving mode (2x weight bytes; values stay on the NF4 grid)")
    ap.add_argument("--kv8", action="store_true", help="int8 KV cache (halves KV memory)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree (not ported yet)")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel degree (not ported yet)")
    ap.add_argument("--decode-chunk", type=int, default=8, help="decode steps per host sync (one CUDA graph)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft length (prompt-lookup n-gram drafts unless --draft-* gives a "
                    "draft model)")
    ap.add_argument("--draft-packed", default=None,
                    help="packed checkpoint of a small draft model for draft-model speculation (same vocabulary)")
    ap.add_argument("--draft-model", default=None,
                    help="registry config name for a synthetic draft model (testing; real serving should use "
                    "--draft-packed)")
    ap.add_argument("--prefix-cache", action="store_true", help="shared-prefix prefill (not ported yet)")
    ap.add_argument("--batch-window", type=float, default=0.01,
                    help="dispatcher dynamic-batching grace (s): wait this long after a fresh wave's first "
                    "request for more arrivals")
    ap.add_argument("--temperature", type=float, default=0.0, help="default sampling temperature (0 = greedy)")
    ap.add_argument("--eos", type=int, default=None, help="EOS token id (default: tokenizer's, else 2)")
    ap.add_argument("--device", default=None, help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)

    engine, tokenizer = build_engine(args)

    from .api import CompletionServer

    server = CompletionServer(engine, tokenizer, model_name=args.model_name, batch_window=args.batch_window)
    port = server.start(args.host, args.port)
    print(f"serving on http://{args.host}:{port} (model={args.model_name}, slots={args.batch_size})",
          file=sys.stderr)
    if not block:
        return server
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
