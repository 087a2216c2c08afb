"""End-to-end quality gate: the NF4 perplexity delta of a model trained in place.

The port of ``tools/quality_gate.py``.  With no checkpoint and no
download, it trains a small byte-level LM (dense fp32 weights, through
``models.llama.train_forward``) on text it makes itself, then reports the
held-out perplexity of the same weights four ways: dense fp32, dense bf16,
NF4-quantized (``quantize_for_tpu`` per fused projection, bf16
activations: the serving path's fused kernels) and int8-recoded
(``recode_params_int8``), and whether the NF4 delta is within the gate.

    python -m nf4_tpu_torch.eval.quality_gate [--corpus repo|synthetic] [--steps 600] [--gate 0.1]

Corpora: ``repo``, the repository's own ``.py`` and ``.md`` text (small:
it overfits); ``synthetic``, procedurally generated ledger lines (no
memorizing its way to a low loss).  Defaults are the tool's: 600 AdamW
steps (lr 3e-4, weight decay 0.01) of batch 32 x 256 bytes on hidden 256,
4 layers.  Prints one JSON line with the tool's keys (``ppl_dense_fp32``,
``ppl_dense_bf16``, ``ppl_nf4``, ``ppl_nf4_int8_recode``, ``delta``,
``delta_int8_recode``, ``delta_nf4_vs_bf16``, ``gate``, ``within_gate``,
``trained_steps``, ``params_m``, ``eval_tokens``); exits 1 outside the
gate.  Runs on the CUDA card; ``--device cpu`` runs the plain path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..models.llama import LlamaConfig, LlamaParams, init_params, recode_params_int8
from ..nf4.format import quantize_for_tpu
from ..train.trainer import lm_loss
from ..utils.device import resolve_device
from .ppl import perplexity

__all__ = ["synthetic_corpus", "load_corpus", "quality_gate", "main"]

_PROJECTIONS = ("wqkv", "wo", "w_gateup", "w_down")


def synthetic_corpus(n_bytes: int, seed: int = 7) -> np.ndarray:
    """Procedurally generated structured text (arithmetic ledger lines),
    the tool's: unlimited data, so the held-out delta measures how the
    quantization moves a model that generalizes, not memorized lookups."""
    rng = np.random.default_rng(seed)
    lines = []
    total = 0
    while total < n_bytes:
        a, b = rng.integers(0, 10000, size=2)
        op = rng.choice(["+", "-", "*"])
        r = {"+": a + b, "-": a - b, "*": a * b}[op]
        tag = rng.choice(["acct", "item", "txn", "ref"])
        line = f"{tag}:{a}{op}{b}={r};bal={r % 977}\n"
        lines.append(line)
        total += len(line)
    return np.frombuffer("".join(lines).encode(), dtype=np.uint8)[:n_bytes]


def load_corpus(root: str, max_bytes: int = 2_000_000) -> np.ndarray:
    """The ``.py`` and ``.md`` files under ``root`` in sorted order, as
    bytes (at most ``max_bytes``)."""
    chunks = []
    total = 0
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames[:] = sorted(d for d in dirnames if d not in (".git", "__pycache__", ".claude"))
        for fn in sorted(filenames):
            if not fn.endswith((".py", ".md")):
                continue
            with open(os.path.join(dirpath, fn), "rb") as f:
                data = f.read()
            chunks.append(np.frombuffer(data, dtype=np.uint8))
            total += len(data)
            if total >= max_bytes:
                return np.concatenate(chunks)[:max_bytes]
    return np.concatenate(chunks)


def _leaves(params: LlamaParams) -> list:
    """Every tensor of a dense model (what the tool's optax state holds)."""
    out = [params.embed, params.final_norm, params.lm_head]
    for lp in params.layers:
        out += [getattr(lp, f.name) for f in dataclasses.fields(lp) if getattr(lp, f.name) is not None]
    return out


def _cast(params: LlamaParams, dtype) -> LlamaParams:
    """A detached copy of a dense model with every fp32 tensor in
    ``dtype``."""
    def cast(t):
        return t.detach().to(dtype) if t.dtype == torch.float32 else t.detach()

    layers = [dataclasses.replace(lp, **{f.name: cast(getattr(lp, f.name)) for f in dataclasses.fields(lp)
                                         if getattr(lp, f.name) is not None}) for lp in params.layers]
    return LlamaParams(embed=cast(params.embed), layers=layers, final_norm=cast(params.final_norm),
                       lm_head=cast(params.lm_head))


def _quantized(params: LlamaParams, device) -> LlamaParams:
    """The trained weights as the serving path holds them (the tool's): each
    fused projection quantized to NF4 with bf16 compute, the embedding and
    lm_head in bf16, the norms fp32."""
    base = _cast(params, torch.float32)  # detached
    layers = [dataclasses.replace(lp, **{n: quantize_for_tpu(getattr(lp, n), dtype=torch.bfloat16, device=device)
                                         for n in _PROJECTIONS}) for lp in base.layers]
    return dataclasses.replace(base, embed=base.embed.to(torch.bfloat16), layers=layers,
                               lm_head=base.lm_head.to(torch.bfloat16))


def quality_gate(steps: int = 600, seq_len: int = 256, batch: int = 32, lr: float = 3e-4, gate: float = 0.1,
                 eval_seqs: int = 64, hidden: int = 256, layers: int = 4, corpus: str = "repo",
                 corpus_bytes: int = 8_000_000, device=None, log=sys.stderr) -> dict:
    """Train, evaluate and return the report (the keys of the module
    docstring)."""
    dev = resolve_device(device)
    cfg = LlamaConfig(vocab_size=256, hidden_size=hidden, intermediate_size=2 * hidden, num_layers=layers,
                      num_heads=hidden // 32, num_kv_heads=hidden // 64, head_dim=32, max_seq_len=seq_len,
                      quantize=False, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)

    if corpus == "synthetic":
        data = synthetic_corpus(corpus_bytes)
    else:
        data = load_corpus(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    n_eval = eval_seqs * seq_len
    train_bytes, eval_bytes = data[:-n_eval], data[-n_eval:]
    print(f"corpus: {len(data)} bytes ({len(train_bytes)} train / {len(eval_bytes)} eval)", file=log)

    n_windows = (len(train_bytes) - 1) // seq_len
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for step in range(steps):
        idx = rng.integers(0, n_windows, size=batch)
        toks = np.stack([train_bytes[i * seq_len : i * seq_len + seq_len] for i in idx])
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(params, None, cfg, torch.as_tensor(toks, dtype=torch.int32, device=dev))
        loss.backward()
        opt.step()
        if step % 100 == 0 or step == steps - 1:
            print(f"step {step}: loss {float(loss.detach()):.4f} ({time.time() - t0:.0f}s)", file=log)

    held_out = [[int(t) for t in eval_bytes[i * seq_len : (i + 1) * seq_len]]
                for i in range(len(eval_bytes) // seq_len)]
    ppl_dense = perplexity(params, cfg, held_out, device=dev)
    bf16_cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    ppl_bf16 = perplexity(_cast(params, torch.bfloat16), bf16_cfg, held_out, device=dev)
    qcfg = dataclasses.replace(cfg, quantize=True, dtype=torch.bfloat16)
    qparams = _quantized(params, dev)
    ppl_nf4 = perplexity(qparams, qcfg, held_out, device=dev)
    ppl_int8 = perplexity(recode_params_int8(qparams), qcfg, held_out, device=dev)

    delta = ppl_nf4 - ppl_dense
    return {
        "ppl_dense_fp32": round(float(ppl_dense), 4),
        "ppl_dense_bf16": round(float(ppl_bf16), 4),
        "ppl_nf4": round(float(ppl_nf4), 4),
        "ppl_nf4_int8_recode": round(float(ppl_int8), 4),
        "delta": round(float(delta), 4),
        "delta_int8_recode": round(float(ppl_int8 - ppl_dense), 4),
        "delta_nf4_vs_bf16": round(float(ppl_nf4 - ppl_bf16), 4),
        "gate": gate,
        "within_gate": bool(abs(delta) <= gate),
        "trained_steps": steps,
        "params_m": round(sum(t.numel() for t in leaves) / 1e6, 1),
        "eval_tokens": len(held_out) * (seq_len - 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nf4_tpu_torch.eval.quality_gate")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gate", type=float, default=0.1)
    ap.add_argument("--eval-seqs", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--corpus", choices=["repo", "synthetic"], default="repo",
                    help="repo = this repository's source text (small, overfits); synthetic = unlimited "
                    "procedurally generated structured text")
    ap.add_argument("--corpus-bytes", type=int, default=8_000_000)
    ap.add_argument("--device", default=None, help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    report = quality_gate(args.steps, args.seq_len, args.batch, args.lr, args.gate, args.eval_seqs, args.hidden,
                          args.layers, args.corpus, args.corpus_bytes, args.device)
    print(json.dumps(report))
    return 0 if report["within_gate"] else 1


if __name__ == "__main__":
    sys.exit(main())
