"""Model configurations (the JAX package's ``models/configs.py`` values)."""

from __future__ import annotations

from .llama import LlamaConfig

__all__ = [
    "TINY_TEST",
    "TINYLLAMA_1_1B",
    "MISTRAL_7B",
    "GEMMA_7B",
    "QWEN2_7B",
    "LLAMA3_8B",
    "LLAMA3_1_8B",
    "QWEN3_8B",
    "TINY_GEMMA2",
    "GEMMA2_9B",
    "GEMMA3_4B",
    "PHI3_MINI",
    "TINY_MOE",
    "MIXTRAL_8X7B",
    "QWEN3_MOE_A3B",
    "get_config",
]

# A miniature config for unit tests.
TINY_TEST = LlamaConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    max_seq_len=64,
)

# TinyLlama-1.1B.
TINYLLAMA_1_1B = LlamaConfig(
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=22,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    rope_theta=10000.0,
    max_seq_len=2048,
)

# Mistral-7B v0.1: Llama architecture + sliding-window attention.
MISTRAL_7B = LlamaConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10000.0,
    max_seq_len=8192,
    sliding_window=4096,
)

# Gemma-7B: GeGLU activation, (1+w) RMSNorm, sqrt(hidden) embedding scale.
GEMMA_7B = LlamaConfig(
    vocab_size=256000,
    hidden_size=3072,
    intermediate_size=24576,
    num_layers=28,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    max_seq_len=8192,
    activation="gelu_tanh",
    rmsnorm_one_plus=True,
    scale_embeddings=True,
)

# Qwen2-7B: Llama architecture + q/k/v projection biases.
QWEN2_7B = LlamaConfig(
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    max_seq_len=8192,
    attn_bias=True,
)

# Llama-3-8B.
LLAMA3_8B = LlamaConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500000.0,
    max_seq_len=8192,
)

# Llama-3.1-8B: Llama-3 + llama3 RoPE scaling to a 128k context.
LLAMA3_1_8B = LlamaConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500000.0,
    rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192),
    max_seq_len=131072,
)

# Qwen3-8B (Qwen2-style GQA without biases + per-head q/k RMSNorm).
QWEN3_8B = LlamaConfig(
    vocab_size=151936,
    hidden_size=4096,
    intermediate_size=12288,
    num_layers=36,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1000000.0,
    max_seq_len=32768,
    qk_norm=True,
)

# A tiny Gemma-2-style config for tests (softcaps, four-norm blocks,
# alternating local/global attention).
TINY_GEMMA2 = LlamaConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=256,
    num_layers=4,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    max_seq_len=64,
    activation="gelu_tanh",
    rmsnorm_one_plus=True,
    scale_embeddings=True,
    attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0,
    query_pre_attn_scalar=64.0,
    sliding_window=16,
    sliding_window_pattern=2,
)

# Gemma-2-9B: four-norm blocks, tanh softcaps, a 4096 window on every
# other layer.
GEMMA2_9B = LlamaConfig(
    vocab_size=256000,
    hidden_size=3584,
    intermediate_size=14336,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    rope_theta=10000.0,
    max_seq_len=8192,
    activation="gelu_tanh",
    rmsnorm_one_plus=True,
    scale_embeddings=True,
    attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0,
    query_pre_attn_scalar=256.0,
    sliding_window=4096,
    sliding_window_pattern=2,
)

# Gemma-3-4B (text): local layers rotate at 10k unscaled, global ones at 1M
# with linear x8 scaling; 5 local layers to 1 global; q/k head norms;
# four-norm blocks; no softcaps.
GEMMA3_4B = LlamaConfig(
    vocab_size=262144,
    hidden_size=2560,
    intermediate_size=10240,
    num_layers=34,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    rope_theta=1000000.0,
    rope_local_theta=10000.0,
    rope_scaling=("linear", 8.0),
    max_seq_len=32768,
    activation="gelu_tanh",
    rmsnorm_one_plus=True,
    scale_embeddings=True,
    qk_norm=True,
    query_pre_attn_scalar=256.0,
    sliding_window=1024,
    sliding_window_pattern=6,
)

# Phi-3-mini at its original 4k context (unscaled RoPE); D = 96 keeps it on
# the plain attention paths.
PHI3_MINI = LlamaConfig(
    vocab_size=32064,
    hidden_size=3072,
    intermediate_size=8192,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    rope_theta=10000.0,
    max_seq_len=4096,
)

# A tiny MoE config for tests (Mixtral-style routing).
TINY_MOE = LlamaConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    max_seq_len=64,
    num_experts=4,
    experts_per_token=2,
)

# Mixtral-8x7B: 8 experts, top-2 routing, Mistral-style attention.
MIXTRAL_8X7B = LlamaConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1000000.0,
    max_seq_len=32768,
    num_experts=8,
    experts_per_token=2,
)

# Qwen3-30B-A3B: 128 experts, top-8 renormalized routing, expert width 768
# (HF moe_intermediate_size), q/k head norms; max_seq_len bounds the cache.
QWEN3_MOE_A3B = LlamaConfig(
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=768,
    num_layers=48,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    max_seq_len=32768,
    qk_norm=True,
    num_experts=128,
    experts_per_token=8,
    moe_norm_topk=True,
)

_REGISTRY = {
    "tiny-test": TINY_TEST,
    "tinyllama-1.1b": TINYLLAMA_1_1B,
    "mistral-7b": MISTRAL_7B,
    "gemma-7b": GEMMA_7B,
    "qwen2-7b": QWEN2_7B,
    "llama3-8b": LLAMA3_8B,
    "llama3.1-8b": LLAMA3_1_8B,
    "qwen3-8b": QWEN3_8B,
    "tiny-gemma2": TINY_GEMMA2,
    "gemma2-9b": GEMMA2_9B,
    "gemma3-4b": GEMMA3_4B,
    "phi3-mini": PHI3_MINI,
    "tiny-moe": TINY_MOE,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "qwen3-30b-a3b": QWEN3_MOE_A3B,
}


def get_config(name: str) -> LlamaConfig:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None
