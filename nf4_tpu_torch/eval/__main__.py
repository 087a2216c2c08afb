"""Perplexity evaluation CLI.

    python -m nf4_tpu_torch.eval --model tinyllama-1.1b --checkpoint packed.npz \
        --tokens tokens.npy [--baseline-ppl 7.95] [--gate 0.1] [--batch-size 8]

    python -m nf4_tpu_torch.eval --model llama3-8b --hf-dir /path/to/llama --tokens tokens.npy

``tokens.npy`` holds a 2D int array [n_seqs, seq_len], or a 1D stream cut
into ``max_seq_len`` windows.  Prints one JSON line: ``perplexity`` and,
with a baseline, ``baseline_perplexity``, ``delta`` and ``within_gate``;
exits 1 outside the gate.  Runs on the CUDA card; ``--device cpu`` runs
the plain PyTorch path (tests).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nf4_tpu_torch.eval")
    ap.add_argument("--model", required=True, help="config name (models/configs.py)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="packed .npz / .safetensors from save_packed")
    src.add_argument("--hf-dir", help="HF checkpoint dir (dense: quantized on load; *-bnb-4bit: repacked)")
    ap.add_argument("--tokens", required=True, help=".npy token array")
    ap.add_argument("--baseline-ppl", type=float, default=None)
    ap.add_argument("--gate", type=float, default=0.1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)

    from ..models import configs
    from ..models.loader import load_hf_llama, load_packed
    from .ppl import perplexity_report

    cfg = configs.get_config(args.model)
    if args.checkpoint:
        params = load_packed(args.checkpoint, cfg, device=args.device)
    else:
        params, cfg = load_hf_llama(args.hf_dir, cfg, device=args.device)

    toks = np.load(args.tokens)
    if toks.ndim == 1:
        n = (toks.shape[0] // cfg.max_seq_len) * cfg.max_seq_len
        toks = toks[:n].reshape(-1, cfg.max_seq_len)
    sequences = [list(map(int, row)) for row in toks]

    report = perplexity_report(params, cfg, sequences, baseline_ppl=args.baseline_ppl, gate=args.gate,
                               batch_size=args.batch_size, device=args.device)
    print(json.dumps(report))
    return 1 if "within_gate" in report and not report["within_gate"] else 0


if __name__ == "__main__":
    sys.exit(main())
