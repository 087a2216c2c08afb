"""Full-width random packed weights, built on the device from a seed.

The counterpart of ``synthetic_params`` in the JAX package's
``benchmarks/benchmark_serving.py``: structurally exact params (packed
bytes uniform over 0..255, block scales uniform in [0.001, 0.02]) with the
compute and memory traffic of a real model.  The variants' layer vectors
come from the same seed: q/k/v biases (``attn_bias``) normal with std
0.02, as the JAX package's ``init_params`` draws them, and q/k head norms
(``qk_norm``) 1 + normal with std 0.1.  The outputs are not a language
model's; use them to drive and time the serving path.
"""

from __future__ import annotations

import torch

from ..nf4.format import PackedNF4, pad_to
from ..nf4.reference import NF4_BLOCK
from ..utils.device import resolve_device
from .llama import LayerParams, LlamaConfig, LlamaParams, check_supported

__all__ = ["synthetic_params"]


def synthetic_params(cfg: LlamaConfig, seed: int = 0, device=None) -> LlamaParams:
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def packed(m, n):
        m_pad, n_pad = pad_to(m, 128), pad_to(n, 1024)
        return PackedNF4(
            packed=torch.randint(0, 256, (n_pad // 2, m_pad), generator=gen, device=dev, dtype=torch.uint8),
            scales=torch.empty((n_pad // NF4_BLOCK, m_pad), device=dev).uniform_(0.001, 0.02, generator=gen),
            shape=(m, n),
            padded_shape=(m_pad, n_pad),
            dtype=cfg.dtype,
            quant_type=cfg.quant_type,
        )

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(cfg.dtype)

    def vectors():
        """The layer's optional fp32 vectors, drawn after its weights."""
        out = {}
        if cfg.attn_bias:
            out["qkv_bias"] = torch.randn(cfg.q_dim + 2 * cfg.kv_dim, generator=gen, device=dev) * 0.02
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                out[name] = 1.0 + torch.randn(cfg.head_dim, generator=gen, device=dev) * 0.1
        return out

    h, inter = cfg.hidden_size, cfg.intermediate_size
    layers = [
        LayerParams(
            wqkv=packed(cfg.q_dim + 2 * cfg.kv_dim, h),
            wo=packed(h, cfg.q_dim),
            w_gateup=packed(2 * inter, h),
            w_down=packed(h, inter),
            input_norm=torch.ones(h, device=dev),
            post_attn_norm=torch.ones(h, device=dev),
            **vectors(),
        )
        for _ in range(cfg.num_layers)
    ]
    embed = normal((cfg.vocab_size, h), 0.02)
    lm_head = packed(cfg.vocab_size, h) if cfg.quantize_lm_head else normal((cfg.vocab_size, h), h**-0.5)
    return LlamaParams(embed=embed, layers=layers, final_norm=torch.ones(h, device=dev), lm_head=lm_head)
