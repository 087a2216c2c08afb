"""The plain reference of the served models: fp32 PyTorch, TF32 off.

It decodes the packed bytes and scales itself, through the benchmark's own
frozen copy of the 16 NF4 code values (``weights.NF4_VALUES``), and runs the published Llama-family forward
(Qwen2's q/k/v biases, Mixtral's top-2 router and experts) over whole
sequences, layer by layer, drawing each layer's weights again from the run's
seed (``weights.py``): it takes nothing that the program made.  Attention is
causal and computed in query blocks, the projections in row blocks, so that
it fits beside nothing else on the card.

``precision="fp8"`` is the control: every projection (q/k/v, o, gate/up,
down, each expert's, the lm_head) takes both operands rounded to float8
e4m3, the activations with a scale per row and the weights one per output
channel, and sums in fp32; the router, the norms, RoPE and attention stay
fp32.  It is the step below the bf16 that the configurations serve in.

Departures from the published description: none in the arithmetic.  RoPE's
angles are computed in float64 before their cosines are rounded to fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .model import Model
from .weights import NF4_BLOCK, NF4_VALUES, Head, Layer

PRECISIONS = ("fp32", "fp8")
ROW_BLOCK = 4096  # rows per projection call
QUERY_BLOCK = 1024  # queries per attention block
VOCAB_BLOCK = 32768  # lm_head rows per call
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def exact_fp32():
    """fp32 matrix products in full fp32 (TF32 off) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def dequant_t(packed: torch.Tensor, scales: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """W^T [n, m] in fp32 from one packed weight: code[nibble] * scale."""
    code = torch.tensor(NF4_VALUES, dtype=torch.float32, device=packed.device)
    b = packed.to(torch.int64)
    khalf, m_pad = b.shape
    idx = torch.stack((b & 0xF, b >> 4), dim=1).reshape(2 * khalf, m_pad)
    w = code[idx[:n, :m]]
    return w * scales[: -(-n // NF4_BLOCK), :m].repeat_interleave(NF4_BLOCK, dim=0)[:n]


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), returned in fp32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Weight:
    """A projection's fp32 W^T and, for the control, its fp8 rounding."""

    def __init__(self, wt: torch.Tensor, precisions):
        self.by = {p: (wt if p == "fp32" else fp8_round(wt, 0)) for p in precisions}

    def __call__(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        wt = self.by[precision]
        out = torch.empty((x.shape[0], wt.shape[1]), dtype=torch.float32, device=x.device)
        for r0 in range(0, x.shape[0], ROW_BLOCK):
            xb = x[r0 : r0 + ROW_BLOCK]
            out[r0 : r0 + ROW_BLOCK] = (xb if precision == "fp32" else fp8_round(xb, 1)) @ wt
        return out


def _rms(x: torch.Tensor, w, eps: float) -> torch.Tensor:
    out = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return out if w is None else out * w


def _rope_tables(model: Model, length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    half = model.head_dim // 2
    inv = 1.0 / (model.rope_theta ** (torch.arange(half, dtype=torch.float64, device=device) / half))
    ang = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv
    emb = torch.cat((ang, ang), dim=-1)
    return torch.cos(emb).float(), torch.sin(emb).float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [L, heads, D], the rotate-half convention."""
    half = x.shape[-1] // 2
    rot = torch.cat((-x[..., half:], x[..., :half]), dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _attention(model: Model, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention of one sequence: q [L, H, D], k/v [L, KV, D] ->
    [L, H * D]; query head h reads KV head h // group."""
    length, g, d = q.shape[0], model.group, model.head_dim
    kt = k.permute(1, 2, 0)  # [KV, D, L]
    vv = v.permute(1, 0, 2)  # [KV, L, D]
    out = torch.empty((length, model.q_dim), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(d)
    for a in range(0, length, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, length)
        qb = q[a:b].permute(1, 0, 2).reshape(model.kv_heads, g * (b - a), d)
        scores = torch.bmm(qb, kt[:, :, :b]) * scale  # [KV, G * qb, b]
        pos = torch.arange(a, b, device=q.device)
        hide = torch.arange(b, device=q.device)[None, :] > pos[:, None]  # [qb, b]
        scores = scores.masked_fill(hide.repeat(g, 1)[None], float("-inf"))
        o = torch.bmm(torch.softmax(scores, dim=-1), vv[:, :b])  # [KV, G * qb, D]
        out[a:b] = o.reshape(model.heads, b - a, d).permute(1, 0, 2).reshape(b - a, model.q_dim)
    return out


def _layer(model: Model, lw: Layer, spans, tables, precisions, xs: Dict[str, torch.Tensor]):
    """Run every precision's hidden states ``xs`` [N, hidden] through one
    layer (in place), with one dequantization of its weights."""
    w = {name: _Weight(dequant_t(p.packed, p.scales, p.n, p.m), precisions)
         for name, p in lw.weights.items() if p.packed.dim() == 2}
    experts = None
    if lw.router is not None:
        gu, dn = lw.weights["w_gateup"], lw.weights["w_down"]
        experts = [(_Weight(dequant_t(gu.packed[e], gu.scales[e], gu.n, gu.m), precisions),
                    _Weight(dequant_t(dn.packed[e], dn.scales[e], dn.n, dn.m), precisions))
                   for e in range(model.experts)]
    q_dim, kv_dim = model.q_dim, model.kv_dim
    for p in precisions:
        h = xs[p]
        qkv = w["wqkv"](_rms(h, None, model.eps), p)  # the input norm's weight is 1
        if lw.qkv_bias is not None:
            qkv = qkv + lw.qkv_bias
        attn = torch.empty((h.shape[0], q_dim), dtype=torch.float32, device=h.device)
        for (a, b), (cos, sin) in zip(spans, tables):
            length = b - a
            q = _rope(qkv[a:b, :q_dim].reshape(length, model.heads, -1), cos[:length], sin[:length])
            k = _rope(qkv[a:b, q_dim : q_dim + kv_dim].reshape(length, model.kv_heads, -1), cos[:length], sin[:length])
            v = qkv[a:b, q_dim + kv_dim :].reshape(length, model.kv_heads, -1)
            attn[a:b] = _attention(model, q, k, v)
        del qkv
        h = h + w["wo"](attn, p)
        del attn
        mlp_in = _rms(h, None, model.eps)  # the post-attention norm's weight is 1
        if experts is None:
            h = h + _dense_mlp(model, w["w_gateup"], w["w_down"], mlp_in, p)
        else:
            h = h + _moe_mlp(model, lw.router, experts, mlp_in, p)
        xs[p] = h


def _gated(model: Model, gateup: torch.Tensor) -> torch.Tensor:
    gate, up = gateup[:, : model.inter], gateup[:, model.inter :]
    return torch.nn.functional.silu(gate) * up


def _dense_mlp(model: Model, gu: _Weight, dn: _Weight, x: torch.Tensor, p: str) -> torch.Tensor:
    out = torch.empty_like(x)
    for r0 in range(0, x.shape[0], ROW_BLOCK):
        xb = x[r0 : r0 + ROW_BLOCK]
        out[r0 : r0 + ROW_BLOCK] = dn(_gated(model, gu(xb, p)), p)
    return out


def _moe_mlp(model: Model, router: torch.Tensor, experts, x: torch.Tensor, p: str) -> torch.Tensor:
    """Mixtral's MLP: fp32 router logits, the top ``top_k`` experts (ties to
    the lower index), softmax over their logits, their outputs' weighted sum."""
    logits = x @ router.t()
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_i = order.indices[:, : model.top_k]
    weights = torch.softmax(order.values[:, : model.top_k], dim=-1)
    out = torch.zeros_like(x)
    for e, (gu, dn) in enumerate(experts):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel():
            y = _dense_mlp(model, gu, dn, x[rows], p)
            out.index_add_(0, rows, y * weights[rows, slot][:, None])
    return out


def logits(model: Model, seed: int, seqs: Sequence[Tuple[Sequence[int], int]], device,
           precisions: Sequence[str] = ("fp32",)) -> Dict[str, List[torch.Tensor]]:
    """For each ``(tokens, first)`` of ``seqs``, the fp32 logits [len(tokens) -
    first, vocab] at positions ``first`` .. ``len(tokens) - 1``, in every
    precision of ``precisions`` (each a list in ``seqs``' order)."""
    for p in precisions:
        if p not in PRECISIONS:
            raise ValueError(f"unknown precision {p!r}; {'|'.join(PRECISIONS)}")
    with exact_fp32(), torch.no_grad():
        head = Head(model, device).fill(seed)
        toks = torch.as_tensor(np.concatenate([np.asarray(t, dtype=np.int64) for t, _ in seqs]), device=device)
        spans, a = [], 0
        for t, _ in seqs:
            spans.append((a, a + len(t)))
            a += len(t)
        longest = max(b - a for a, b in spans)
        cos, sin = _rope_tables(model, longest, device)
        tables = [(cos, sin)] * len(spans)
        x0 = head.embed[toks].float()
        xs = {p: x0.clone() for p in precisions}
        del x0
        lw = Layer(model, device)
        for i in range(model.layers):
            _layer(model, lw.fill(seed, i), spans, tables, precisions, xs)
        del lw
        rows = torch.cat([torch.arange(a + first, b, device=device) for (a, b), (_, first) in zip(spans, seqs)])
        out = {}
        for p in precisions:
            hn = _rms(xs[p][rows], head.final_norm, model.eps)
            lg = torch.empty((hn.shape[0], model.vocab), dtype=torch.float32, device=device)
            for v0 in range(0, model.vocab, VOCAB_BLOCK):
                lg[:, v0 : v0 + VOCAB_BLOCK] = _Weight(head.lm_head[v0 : v0 + VOCAB_BLOCK].float().t(), (p,))(hn, p)
            sizes = [b - a - first for (a, b), (_, first) in zip(spans, seqs)]
            out[p] = list(torch.split(lg, sizes))
        return out


def token_gaps(ref: torch.Tensor, tokens) -> torch.Tensor:
    """Per position, the gap by which a served token's logit lies below the
    reference's best: ref [T, V], tokens [T] -> [T]."""
    tok = torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=ref.device)
    return ref.max(dim=-1).values - ref.gather(-1, tok[:, None])[:, 0]


def control_gaps(ref: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    """The control's per-position gaps: in the reference's logits, those of
    the token that the lower precision puts first."""
    return token_gaps(ref, lower.argmax(dim=-1).cpu().numpy())
