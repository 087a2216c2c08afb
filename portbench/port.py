"""The program under test, ``nf4_tpu_torch``, as the benchmark uses it: the
benchmark's weights wrapped in its ``LlamaParams`` / ``PackedNF4`` and one
``Engine``.  The only module here, with ``harness.py``, that imports the
program."""

from __future__ import annotations

from typing import List

import torch

from nf4_tpu_torch.models.llama import LayerParams, LlamaConfig, LlamaParams
from nf4_tpu_torch.nf4.format import PackedNF4
from nf4_tpu_torch.serve.engine import Engine

from .model import Model
from .weights import Head, Layer

# The Engine's settings in every cell: greedy, a bf16 cache, CUDA graphs and
# pipelined decode on, decode chunks of 8, no end token, so that every
# request runs to its drawn length on the plain greedy body.
DECODE_CHUNK = 8
NO_EOS = -1


def llama_config(model: Model) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=model.vocab,
        hidden_size=model.hidden,
        intermediate_size=model.inter,
        num_layers=model.layers,
        num_heads=model.heads,
        num_kv_heads=model.kv_heads,
        head_dim=model.head_dim,
        rope_theta=model.rope_theta,
        rms_norm_eps=model.eps,
        max_seq_len=model.max_seq,
        attn_bias=model.qkv_bias,
        num_experts=model.experts,
        experts_per_token=model.top_k,
        moe_norm_topk=True,
        dtype=torch.bfloat16,
        quantize=True,
    )


def _packed(layer: Layer, name: str) -> PackedNF4:
    w = layer.weights[name]
    return PackedNF4(packed=w.packed, scales=w.scales, shape=(w.m, w.n), padded_shape=(w.m_pad, w.n_pad),
                     dtype=torch.bfloat16)


def params(model: Model, layers: List[Layer], head: Head) -> LlamaParams:
    """The program's params over the benchmark's buffers (views, no copy)."""
    dev = head.embed.device
    ones = torch.ones(model.hidden, device=dev)
    return LlamaParams(
        embed=head.embed,
        layers=[
            LayerParams(
                wqkv=_packed(lw, "wqkv"), wo=_packed(lw, "wo"), w_gateup=_packed(lw, "w_gateup"),
                w_down=_packed(lw, "w_down"), input_norm=ones, post_attn_norm=ones,
                qkv_bias=lw.qkv_bias, router=lw.router,
            )
            for lw in layers
        ],
        final_norm=head.final_norm,
        lm_head=head.lm_head,
    )


def engine(model: Model, p: LlamaParams, slots: int, device) -> Engine:
    return Engine(p, llama_config(model), batch_size=slots, eos_token=NO_EOS, decode_chunk=DECODE_CHUNK,
                  device=device, pipeline_decode=True, cuda_graphs=True)
