"""Packed 4-bit weights, drawn on the device from the run's seed.

Each projection is what NF4 quantization makes of a Gaussian weight: W^T
drawn normal with std in_features^-0.5 (the init ``models/synthetic.py``
uses for dense weights), each block of 64 K rows stored as its absmax (the
fp32 scale) and each value as the index of the NF4 code nearest to it over
that absmax.  The q/k/v biases are normal with std 0.02, the MoE router
normal with std hidden^-0.5, the embedding normal with std 0.02 and the
lm_head with std hidden^-0.5 (both bf16), the final norm 1 + normal with std
0.1, the other norms 1: ``models/synthetic.py``'s arithmetic, copied so that
the yardstick does not move with the program.

Its packed bytes, uniform over 0..255 with scales uniform in [0.001, 0.02],
are not used: the NF4 codes' mean is +0.0235, so every such projection has
a positive mean, which the layers amplify along the all-ones direction until
every position's logits are one fixed vector.  Served greedily, such a model
emits one token forever, and no comparison of served tokens could tell a
sound program from one in fp8.  Quantized Gaussians have the code
statistics of a real checkpoint and a mean of zero.

The layout is the program's packed NF4 format: ``packed`` uint8 ``[n_pad/2,
m_pad]`` (K-major; the low nibble holds K row 2j, the high nibble K row
2j+1), ``scales`` fp32 ``[n_pad/64, m_pad]``, n padded to a multiple of
1024 and m to a multiple of 128, the padding with scale 0; an MoE layer's
experts stack on a leading axis.  Each layer is drawn from a generator of
its own, so that the reference can draw layer i again without the others.
Filling the same buffers again for another seed keeps every pointer, so a
process can serve several seeds through one set of CUDA graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .model import Model

NF4_BLOCK = 64
# bitsandbytes' NF4 code values, index 0..15: the benchmark's own frozen copy.
NF4_VALUES = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
)
_MASK64 = (1 << 64) - 1


def pad_to(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def stream_seed(seed: int, k: int) -> int:
    """A 63-bit generator seed for stream ``k`` of run ``seed`` (splitmix64)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (k + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x & ((1 << 63) - 1)


@dataclasses.dataclass
class Packed:
    """One projection W [m, n] (out, in) in the packed layout; with a leading
    ``[E]`` axis for an MoE layer's experts."""

    packed: torch.Tensor  # uint8 [(E,) n_pad/2, m_pad]
    scales: torch.Tensor  # fp32 [(E,) n_pad/64, m_pad]
    m: int
    n: int

    @property
    def m_pad(self) -> int:
        return self.packed.shape[-1]

    @property
    def n_pad(self) -> int:
        return 2 * self.packed.shape[-2]


def projections(model: Model) -> List[Tuple[str, int, int, Optional[int]]]:
    """(name, m, n, experts or None) of a layer's four packed weights: q+k+v
    and gate+up fused, as the program holds them."""
    e = model.experts if model.experts > 1 else None
    h = model.hidden
    return [
        ("wqkv", model.q_dim + 2 * model.kv_dim, h, None),
        ("wo", h, model.q_dim, None),
        ("w_gateup", 2 * model.inter, h, e),
        ("w_down", h, model.inter, e),
    ]


def quantize_normal(packed: torch.Tensor, scales: torch.Tensor, n: int, m: int, std: float, gen) -> None:
    """Fill one packed weight (``packed`` [n_pad/2, m_pad], ``scales`` [n_pad/64,
    m_pad]) with the NF4 quantization of W^T [n, m] drawn normal with ``std``;
    the padding gets scale 0."""
    n_pad, m_pad = 2 * packed.shape[0], packed.shape[1]
    g = torch.randn((n_pad, m_pad), generator=gen, device=packed.device)
    g[n:] = 0.0
    g[:, m:] = 0.0
    blocks = g.view(n_pad // NF4_BLOCK, NF4_BLOCK, m_pad)
    absmax = blocks.abs().amax(dim=1)
    blocks /= torch.where(absmax > 0, absmax, 1.0)[:, None, :]
    code = torch.tensor(NF4_VALUES, device=packed.device)
    idx = torch.bucketize(g, (code[1:] + code[:-1]) / 2, out_int32=True)  # the nearest code
    packed.copy_((idx[0::2] | (idx[1::2] << 4)).to(torch.uint8))
    scales.copy_(absmax * std)


class Layer:
    """One decoder layer's weights on ``device``; :meth:`fill` draws them."""

    def __init__(self, model: Model, device):
        self.model = model
        specs = []
        nb = ns = 0
        for name, m, n, e in projections(model):
            m_pad, n_pad = pad_to(m, 128), pad_to(n, 1024)
            lead = () if e is None else (e,)
            specs.append((name, m, n, lead, m_pad, n_pad, nb, ns))
            count = e or 1
            nb += count * (n_pad // 2) * m_pad
            ns += count * (n_pad // NF4_BLOCK) * m_pad
        self.bytes = torch.empty(nb, dtype=torch.uint8, device=device)
        self.scales = torch.empty(ns, dtype=torch.float32, device=device)
        self.weights: Dict[str, Packed] = {}
        for name, m, n, lead, m_pad, n_pad, ob, os_ in specs:
            count = lead[0] if lead else 1
            kb, ks = (n_pad // 2) * m_pad, (n_pad // NF4_BLOCK) * m_pad
            self.weights[name] = Packed(
                packed=self.bytes[ob : ob + count * kb].view(*lead, n_pad // 2, m_pad),
                scales=self.scales[os_ : os_ + count * ks].view(*lead, n_pad // NF4_BLOCK, m_pad),
                m=m,
                n=n,
            )
        h = model.hidden
        self.qkv_bias = torch.empty(model.q_dim + 2 * model.kv_dim, device=device) if model.qkv_bias else None
        self.router = torch.empty((model.experts, h), device=device) if model.experts > 1 else None

    def fill(self, seed: int, index: int) -> "Layer":
        """Draw layer ``index`` of run ``seed`` into this layer's buffers."""
        gen = torch.Generator(device=self.bytes.device)
        gen.manual_seed(stream_seed(seed, index + 1))
        for w in self.weights.values():
            for packed, scales in zip(w.packed.view(-1, *w.packed.shape[-2:]), w.scales.view(-1, *w.scales.shape[-2:])):
                quantize_normal(packed, scales, w.n, w.m, w.n**-0.5, gen)
        if self.qkv_bias is not None:
            self.qkv_bias.normal_(0.0, 0.02, generator=gen)
        if self.router is not None:
            self.router.normal_(0.0, self.model.hidden**-0.5, generator=gen)
        return self


class Head:
    """The embedding and the lm_head (bf16 [vocab, hidden]) and the final
    norm (fp32 [hidden])."""

    ROW_BLOCK = 32768  # rows drawn per call, bounding the fp32 temporary

    def __init__(self, model: Model, device):
        self.model = model
        self.embed = torch.empty((model.vocab, model.hidden), dtype=torch.bfloat16, device=device)
        self.lm_head = torch.empty_like(self.embed)
        self.final_norm = torch.empty(model.hidden, device=device)

    def fill(self, seed: int) -> "Head":
        gen = torch.Generator(device=self.embed.device)
        gen.manual_seed(stream_seed(seed, 0))
        for t, std in ((self.embed, 0.02), (self.lm_head, self.model.hidden**-0.5)):
            for r0 in range(0, t.shape[0], self.ROW_BLOCK):
                rows = t[r0 : r0 + self.ROW_BLOCK]
                rows.copy_(torch.empty(rows.shape, device=t.device).normal_(0.0, std, generator=gen))
        self.final_norm.normal_(0.0, 0.1, generator=gen).add_(1.0)
        return self

