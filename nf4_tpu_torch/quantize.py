"""One-shot checkpoint quantization CLI.

    python -m nf4_tpu_torch.quantize --hf-dir /path/to/llama --out llama-nf4.npz \
        [--model llama3-8b] [--quant-type nf4|fp4] [--force-cpu]

Loads an HF safetensors checkpoint (dense: quantized on the card as it
loads, one layer at a time; or a pre-quantized "*-bnb-4bit" one: repacked
without requantization) and writes the packed format
(``models.loader.save_packed``: ``.npz`` or ``.safetensors`` by extension),
which either package reloads in seconds (``load_packed_auto``).
``--force-cpu`` quantizes on the CPU (the same bytes).  ``--tp > 1``
(re-packing for tensor parallelism) is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nf4_tpu_torch.quantize")
    ap.add_argument("--hf-dir", required=True, help="HF checkpoint directory")
    ap.add_argument("--out", required=True, help="output path (.npz or .safetensors)")
    ap.add_argument("--model", default=None, help="config name (models/configs.py); default: from config.json")
    ap.add_argument("--quant-type", default=None, choices=("nf4", "fp4"),
                    help="4-bit codebook (default: config.json's quantization_config, else nf4)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree to pack for (not ported yet)")
    ap.add_argument("--force-cpu", action="store_true", help="quantize on the CPU even when a card is present")
    args = ap.parse_args(argv)
    if args.tp > 1:
        raise SystemExit("--tp > 1 (packing for tensor parallelism) is not ported yet")

    from .models import configs
    from .models.loader import hf_config_to_llama, load_hf_llama, save_packed

    overrides = {"quant_type": args.quant_type} if args.quant_type else {}
    if args.model:
        cfg = dataclasses.replace(configs.get_config(args.model), **overrides)
    else:
        cfg = hf_config_to_llama(os.path.join(args.hf_dir, "config.json"), **overrides)
    device = "cpu" if args.force_cpu else None

    t0 = time.monotonic()
    stats = {}
    params, cfg = load_hf_llama(args.hf_dir, cfg, stats=stats, device=device)
    t_load = time.monotonic() - t0
    t1 = time.monotonic()
    save_packed(args.out, params, cfg)
    t_save = time.monotonic() - t1
    print(json.dumps({
        "out": args.out,
        "device": str(params.embed.device),
        "quant_type": cfg.quant_type,
        "tp_shards": cfg.tp_shards,
        "load_quantize_s": round(t_load, 1),
        "save_s": round(t_save, 1),
        "packed_bytes": os.path.getsize(args.out),
        "peak_dense_bytes": stats.get("peak_dense_bytes"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
