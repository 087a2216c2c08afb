"""Perplexity and teacher-forced token log-probabilities.

The port of the JAX package's ``eval/ppl.py``: next-token NLL over token
sequences, with the same functions, batching and truncation.  Every
log-probability is fp32: the log-softmax of the fp32 logits.

Two things differ, so that a batch of long sequences fits beside a large
model on one card:

* Each batch gets a KV cache only as long as its bucket ``T`` (the JAX
  package allocates one of ``max_seq_len``).  Attention's dispatch reads
  the cache length, so a batch of ``B`` rows takes kernel C (the prefill
  flash kernel, on CUDA with bf16 activations) when ``B * H * T * T >=
  2**27`` and ``T >= 256``, the plain chunked path when only the first
  holds (or off the card), and the plain naive path below it
  (``ops/attention.py:attention``).
* The head runs one row at a time on the last layer's hidden states
  (``forward(hidden=True)``, then ``lm_head``), and only the target
  tokens' log-probabilities are kept: ``[T, V]`` fp32 logits live for one
  row, never ``[B, T, V]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.llama import LlamaConfig, LlamaParams, forward, init_kv_cache, lm_head
from ..utils.device import resolve_device
from ..utils.shapes import bucket_len

__all__ = ["sequence_nll", "perplexity", "perplexity_report", "token_logprobs"]


def _bucket_len(n: int, cap: int) -> int:
    """A sequence length padded to the serving engine's power-of-two
    buckets (at least 16), at most ``cap``."""
    return min(bucket_len(n), cap)


def _batch_token_logp(params: LlamaParams, cfg: LlamaConfig, toks: np.ndarray, lens: np.ndarray,
                      device, lora=None, ids=None) -> torch.Tensor:
    """log P(token_t | prefix) for a padded batch ``toks`` [B, T] of true
    lengths ``lens``: fp32 [B, T-1] on ``device`` (entry t-1 predicts token
    t; entries at or past a row's length are left as they come); ``lora``
    and the rows' adapters ``ids`` as in ``forward``."""
    b, t = toks.shape
    cache = init_kv_cache(dataclasses.replace(cfg, max_seq_len=t), b, device)
    tokens = torch.as_tensor(toks, dtype=torch.int32, device=device)
    positions = torch.arange(t, dtype=torch.int32, device=device).expand(b, t)
    seq_lens = torch.as_tensor(lens, dtype=torch.int32, device=device)
    adapter_ids = None if ids is None else torch.as_tensor(ids, dtype=torch.int32, device=device)
    with torch.no_grad():
        x, _ = forward(params, cfg, tokens, cache, positions, seq_lens, kv_len=t, hidden=True, lora=lora,
                       adapter_ids=adapter_ids)
        del cache
        out = torch.empty((b, t - 1), dtype=torch.float32, device=device)
        targets = tokens[:, 1:].long()
        for j in range(b):
            logp = torch.log_softmax(lm_head(params, cfg, x[j : j + 1, :-1]).float(), dim=-1)
            out[j] = logp[0].gather(-1, targets[j, :, None])[:, 0]
    return out


def _batches(cfg: LlamaConfig, sequences, batch_size: int):
    """(indices, padded tokens [B, T], lengths [B]) of each batch of the
    sequences with at least 2 tokens, truncated to ``cfg.max_seq_len``;
    T is the batch's bucket."""
    todo = [(i, list(s)[: cfg.max_seq_len]) for i, s in enumerate(sequences) if len(s) >= 2]
    for i0 in range(0, len(todo), batch_size):
        chunk = todo[i0 : i0 + batch_size]
        t = _bucket_len(max(len(s) for _, s in chunk), cfg.max_seq_len)
        toks = np.zeros((len(chunk), t), dtype=np.int32)
        lens = np.zeros(len(chunk), dtype=np.int32)
        for j, (_, s) in enumerate(chunk):
            toks[j, : len(s)] = s
            lens[j] = len(s)
        yield [i for i, _ in chunk], toks, lens


def token_logprobs(params: LlamaParams, cfg: LlamaConfig, sequences: Sequence[Sequence[int]], batch_size: int = 8,
                   lora=None, adapter_ids=None, device=None) -> list:
    """Teacher-forced per-token log-probabilities for each sequence.

    One list per sequence of length ``len(seq) - 1``: entry ``i`` is
    log P(seq[i+1] | seq[:i+1]) (the first token has none; OpenAI's
    completions API reports it as null).  Sequences are truncated to
    ``cfg.max_seq_len``; those of length 0 or 1 give ``[]``.  ``params``
    live on ``device`` (default ``cuda``).  ``lora`` is an unmerged
    adapter, or a multi-LoRA bank (``train.lora.stack_adapters``, or its
    serving form ``models.llama.prepare_bank``) with ``adapter_ids`` one
    bank index per sequence (-1: the base model)."""
    dev = resolve_device(device)
    out = [[] for _ in sequences]
    for idx, toks, lens in _batches(cfg, sequences, batch_size):
        ids = None if adapter_ids is None else [adapter_ids[i] for i in idx]
        lp = _batch_token_logp(params, cfg, toks, lens, dev, lora, ids).cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = [float(v) for v in lp[j, : lens[j] - 1]]
    return out


def sequence_nll(params: LlamaParams, cfg: LlamaConfig, sequences: Sequence[Sequence[int]], batch_size: int = 8,
                 device=None) -> tuple:
    """(total next-token negative log-likelihood, predicted tokens) over
    the sequences, truncated to ``cfg.max_seq_len``."""
    dev = resolve_device(device)
    total, count = 0.0, 0
    for _, toks, lens in _batches(cfg, sequences, batch_size):
        lp = _batch_token_logp(params, cfg, toks, lens, dev)
        mask = torch.arange(toks.shape[1] - 1, device=dev)[None, :] < torch.as_tensor(lens - 1, device=dev)[:, None]
        total -= float(torch.where(mask, lp, 0.0).sum(dtype=torch.float64))
        count += int(mask.sum())
    return total, count


def perplexity(params: LlamaParams, cfg: LlamaConfig, sequences: Sequence[Sequence[int]], batch_size: int = 8,
               device=None) -> float:
    """exp(mean next-token NLL) over all predicted tokens (NaN for none)."""
    nll, ntok = sequence_nll(params, cfg, sequences, batch_size=batch_size, device=device)
    if ntok == 0:
        return float("nan")
    return float(np.exp(nll / ntok))


def perplexity_report(params: LlamaParams, cfg: LlamaConfig, sequences: Sequence[Sequence[int]],
                      baseline_ppl: Optional[float] = None, gate: float = 0.1, batch_size: int = 8,
                      device=None) -> dict:
    """Perplexity, and with a baseline (the dense model's, say) the delta
    and whether it is within ``gate``."""
    ppl = perplexity(params, cfg, sequences, batch_size=batch_size, device=device)
    report = {"perplexity": ppl}
    if baseline_ppl is not None:
        report["baseline_perplexity"] = baseline_ppl
        report["delta"] = ppl - baseline_ppl
        report["within_gate"] = bool(abs(ppl - baseline_ppl) <= gate)
    return report
