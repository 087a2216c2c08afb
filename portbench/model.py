"""A model configuration file read into the sizes the benchmark uses.

A configuration file (``configs/<name>.json``) holds the model's published
``config.json`` keys, with each changed key listed under ``reduced`` and
each size the published file leaves to convention under ``assumed``.  This
module knows the Llama-family reading of those keys (Qwen2, Mixtral) and
nothing of the program under test.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    vocab: int
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float
    max_seq: int
    qkv_bias: bool
    experts: int  # 1: a dense MLP
    top_k: int

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def group(self) -> int:
        return self.heads // self.kv_heads


def from_config(name: str, cfg: dict) -> Model:
    """The sizes of a configuration file's keys (Hugging Face names)."""
    heads = cfg["num_attention_heads"]
    return Model(
        name=name,
        vocab=cfg["vocab_size"],
        hidden=cfg["hidden_size"],
        inter=cfg["intermediate_size"],
        layers=cfg["num_hidden_layers"],
        heads=heads,
        kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        eps=float(cfg["rms_norm_eps"]),
        max_seq=cfg["max_position_embeddings"],
        qkv_bias=bool(cfg.get("qkv_bias", False)),
        experts=cfg.get("num_local_experts", 1),
        top_k=cfg.get("num_experts_per_tok", 1),
    )


def load(path: Path) -> Model:
    path = Path(path)
    return from_config(path.stem, json.loads(path.read_text()))
