"""Model configurations (the JAX package's ``models/configs.py`` values)."""

from __future__ import annotations

from .llama import LlamaConfig

__all__ = ["TINY_TEST", "TINYLLAMA_1_1B", "LLAMA3_8B", "get_config"]

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

_REGISTRY = {
    "tiny-test": TINY_TEST,
    "tinyllama-1.1b": TINYLLAMA_1_1B,
    "llama3-8b": LLAMA3_8B,
}


def get_config(name: str) -> LlamaConfig:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None
