"""Full-width random packed weights, built on the device from a seed.

The counterpart of ``synthetic_params`` in the JAX package's
``benchmarks/benchmark_serving.py``: structurally exact params (packed
bytes uniform over 0..255, block scales uniform in [0.001, 0.02]) with the
compute and memory traffic of a real model.  An MoE model's experts are
stacked per layer (``[E, ...]``); ``quantize=False`` gives dense
``cfg.dtype`` projections, normal with std in_features^-0.5.  The
variants' layer vectors come from the same seed, drawn after each layer's
weights: q/k/v biases (``attn_bias``) normal with std 0.02, as the JAX
package's ``init_params`` draws them; q/k head norms (``qk_norm``) and
Gemma-2/3's output norms 1 + normal with std 0.1; the MoE router normal
with std hidden^-0.5, as ``init_params`` draws it.  The final norm is 1 +
normal with std 0.1 too, drawn last, so an ignored field shows.  With
``tp_shards > 1`` the row-parallel weights (``wo``, ``w_down``; an expert
``w_down`` in "tensor" mode) are packed in that many K chunks, each padded
on its own, so the params serve over a mesh of that tensor-parallel
degree (random bytes need no interleave).  The outputs are not a language
model's; use them to drive and time the serving path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nf4.format import PackedNF4, pad_to
from ..nf4.reference import NF4_BLOCK
from ..utils.device import resolve_device
from .llama import LayerParams, LlamaConfig, LlamaParams, check_supported

__all__ = ["synthetic_params"]


def _has_post_norms(cfg: LlamaConfig) -> bool:
    """Gemma-2/3's block shape, as the JAX package's ``init_params`` decides it."""
    return cfg.attn_logit_softcapping is not None or cfg.sliding_window_pattern > 1


def synthetic_params(cfg: LlamaConfig, seed: int = 0, device=None) -> LlamaParams:
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    experts = cfg.num_experts if cfg.num_experts > 1 else None

    def weight(m, n, e: Optional[int] = None, shards: int = 1):
        """A projection [m, n]; with ``e``, ``e`` of them stacked; its K in
        ``shards`` chunks."""
        lead = () if e is None else (e,)
        if not cfg.quantize:
            return (torch.randn(lead + (m, n), generator=gen, device=dev) * n**-0.5).to(cfg.dtype)
        m_pad, n_pad = pad_to(m, 128), shards * pad_to(n // shards, 1024)
        return PackedNF4(
            packed=torch.randint(0, 256, lead + (n_pad // 2, m_pad), generator=gen, device=dev, dtype=torch.uint8),
            scales=torch.empty(lead + (n_pad // NF4_BLOCK, m_pad), device=dev).uniform_(0.001, 0.02, generator=gen),
            shape=(m, n),
            padded_shape=(m_pad, n_pad),
            dtype=cfg.dtype,
            shards=shards,
            quant_type=cfg.quant_type,
        )

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(cfg.dtype)

    def near_one(n):
        return 1.0 + torch.randn(n, generator=gen, device=dev) * 0.1

    def vectors():
        """The layer's optional fp32 vectors, drawn after its weights."""
        out = {}
        if cfg.attn_bias:
            out["qkv_bias"] = torch.randn(cfg.q_dim + 2 * cfg.kv_dim, generator=gen, device=dev) * 0.02
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                out[name] = near_one(cfg.head_dim)
        if experts:
            out["router"] = torch.randn((experts, h), generator=gen, device=dev) * h**-0.5
        if _has_post_norms(cfg):
            for name in ("post_attn_out_norm", "post_ffw_norm"):
                out[name] = near_one(h)
        return out

    h, inter = cfg.hidden_size, cfg.intermediate_size
    layers = [
        LayerParams(
            wqkv=weight(cfg.q_dim + 2 * cfg.kv_dim, h),
            wo=weight(h, cfg.q_dim, shards=cfg.tp_shards),
            w_gateup=weight(2 * inter, h, experts),
            w_down=weight(h, inter, experts, cfg.moe_groups if experts else cfg.tp_shards),
            input_norm=torch.ones(h, device=dev),
            post_attn_norm=torch.ones(h, device=dev),
            **vectors(),
        )
        for _ in range(cfg.num_layers)
    ]
    embed = normal((cfg.vocab_size, h), 0.02)
    lm_head = weight(cfg.vocab_size, h) if cfg.quantize_lm_head else normal((cfg.vocab_size, h), h**-0.5)
    return LlamaParams(embed=embed, layers=layers, final_norm=near_one(h), lm_head=lm_head)
