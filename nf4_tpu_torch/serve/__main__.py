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

    # shared-prefix caching: a wave's common prompt prefix prefilled once
    python -m nf4_tpu_torch.serve --packed llama-nf4.npz --prefix-cache

    # tensor and data parallel over tp x dp ranks, one process each: NCCL
    # with one card per rank, or every rank on one card over gloo
    python -m nf4_tpu_torch.serve --packed llama-nf4.npz --tp 2 --dp 2
    python -m nf4_tpu_torch.serve --packed llama-nf4.npz --tp 2 --dp 2 --dist-backend gloo

Endpoints (``serve/api.py``): ``/v1/completions``,
``/v1/chat/completions`` (incl. ``"stream": true`` SSE), ``/v1/models``,
``/health``, ``/metrics`` (Prometheus).  A tokenizer directory
(``--tokenizer``, by default ``--hf-dir``) enables string prompts and chat
templating; without one the API accepts token-id lists.  The server runs on the CUDA card;
``--device cpu`` runs the plain PyTorch path (tests).

``--tp N --dp M`` serves over N x M ranks (``serve/ranks.py``): this process
is rank 0, holds the HTTP front and starts the others on the same
arguments; each loads the weights as the JAX CLI does over its mesh (the
rank's slices of a checkpoint packed for tp, else the whole checkpoint
and ``repack_tp``) into ``Engine(mesh=)``, eager (CUDA graphs over a
process group are not ported).  ``--dist-backend`` is the counterpart of
``make_mesh(backend=)``: ``nccl`` (the default on CUDA) needs one card per
rank; ``gloo`` puts every rank on ``cuda:0``; ``--device cpu`` runs gloo on
the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

def _check_source(args) -> None:
    if sum(map(bool, (args.packed, args.hf_dir, args.synthetic))) != 1:
        raise SystemExit("pick exactly one weight source: --packed PATH, --hf-dir DIR, or --model NAME --synthetic")
    if args.synthetic and not args.model:
        raise SystemExit("--synthetic requires --model NAME")


def build_engine(args, mesh=None):
    """Construct (engine, tokenizer) from parsed CLI args; ``mesh`` (this
    rank's ``parallel.mesh.Mesh`` under ``--tp`` / ``--dp``) loads the
    weights as the JAX CLI does over its mesh and serves them on
    ``Engine(mesh=)``."""
    from ..models import configs
    from ..models.llama import recode_params_int8
    from ..models.loader import hf_config_to_llama, load_hf_llama, load_packed_auto, load_packed_sharded
    from ..models.synthetic import synthetic_params
    from ..parallel.tp import repack_tp
    from .engine import Engine
    from .sampling import SamplingParams

    _check_source(args)
    overrides = {}
    if args.kv8:
        overrides["kv_quant"] = True
    if args.max_seq_len:
        overrides["max_seq_len"] = args.max_seq_len
    device = args.device if mesh is None else mesh.device

    t0 = time.monotonic()
    if args.packed:
        src = args.packed
        if mesh is not None and not args.int8:
            # Shard-on-read: each rank reads only its slices; eager load and
            # an in-memory repack when the checkpoint was packed for another
            # tp degree.
            try:
                params, cfg = load_packed_sharded(args.packed, mesh, **overrides)
                src = f"{args.packed} (shard-on-read over the mesh)"
            except ValueError as e:
                if "tp_shards" not in str(e):
                    raise
                print(f"sharded load unavailable ({e}); loading eagerly", file=sys.stderr)
                params, cfg = load_packed_auto(args.packed, device=device, **overrides)
        else:
            params, cfg = load_packed_auto(args.packed, device=device, **overrides)
        # (The JAX CLI repacks only for tp > 1; over a tp = 1 mesh its Engine
        # then refuses a checkpoint packed for tp_shards > 1.)
        if mesh is not None and cfg.tp_shards != args.tp:
            params, cfg = repack_tp(params, cfg, args.tp)
            print(f"repacked tp_shards -> {args.tp} (pure indexing)", file=sys.stderr)
    elif args.hf_dir:
        # Quantized on load, on the serving device, packed for the serving tp
        # degree.
        if args.tp > 1:
            overrides["tp_shards"] = args.tp
        if args.model:
            cfg = dataclasses.replace(configs.get_config(args.model), **overrides)
        else:
            cfg = hf_config_to_llama(os.path.join(args.hf_dir, "config.json"), **overrides)
        params, cfg = load_hf_llama(args.hf_dir, cfg, device=device)
        src = args.hf_dir
    else:
        if args.tp > 1:
            overrides["tp_shards"] = args.tp
        cfg = dataclasses.replace(configs.get_config(args.model), **overrides)
        params = synthetic_params(cfg, seed=0, device=device)
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
        _check_draft(args)
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
        device=device,
        cuda_graphs=mesh is None,
        mesh=mesh,
        spec_k=args.spec_k,
        draft=draft,
        prefix_cache=args.prefix_cache,
    )
    return engine, tokenizer


def _check_draft(args) -> None:
    """The JAX CLI's refusals of draft-model speculation."""
    if args.spec_k <= 0:
        raise SystemExit("--draft-* requires --spec-k > 0")
    if args.tp > 1 or args.dp > 1:
        raise SystemExit("draft-model speculation is single-device")


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
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree (one process per rank; tp*dp ranks)")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel degree: slots shard over dp")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' torch.distributed backend under --tp/--dp: nccl (default on CUDA; one card per "
                    "rank) or gloo (every rank on cuda:0; the only one with --device cpu)")
    ap.add_argument("--decode-chunk", type=int, default=8, help="decode steps per host sync (one CUDA graph)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft length (prompt-lookup n-gram drafts unless --draft-* gives a "
                    "draft model)")
    ap.add_argument("--draft-packed", default=None,
                    help="packed checkpoint of a small draft model for draft-model speculation (same vocabulary)")
    ap.add_argument("--draft-model", default=None,
                    help="registry config name for a synthetic draft model (testing; real serving should use "
                    "--draft-packed)")
    ap.add_argument("--prefix-cache", action="store_true", help="prefill shared prompt prefixes once per wave")
    ap.add_argument("--batch-window", type=float, default=0.01,
                    help="dispatcher dynamic-batching grace (s): wait this long after a fresh wave's first "
                    "request for more arrivals")
    ap.add_argument("--temperature", type=float, default=0.0, help="default sampling temperature (0 = greedy)")
    ap.add_argument("--eos", type=int, default=None, help="EOS token id (default: tokenizer's, else 2)")
    ap.add_argument("--device", default=None, help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)

    if args.tp > 1 or args.dp > 1:
        _check_source(args)
        if args.draft_packed or args.draft_model:
            _check_draft(args)  # before any rank starts
        if args.batch_size % args.dp:
            raise SystemExit(f"--batch-size {args.batch_size} must be a multiple of --dp {args.dp}")
        cpu = args.device is not None and args.device.split(":")[0] == "cpu"
        if args.dist_backend is None:
            args.dist_backend = "gloo" if cpu else "nccl"
        elif cpu and args.dist_backend != "gloo":
            raise SystemExit("--device cpu runs the ranks over gloo, the only backend on the CPU")
        from .ranks import serve_ranks

        return serve_ranks(args, block)

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
