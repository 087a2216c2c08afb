"""QLoRA fine-tuning on frozen packed 4-bit weights.

The counterpart of the JAX package's ``train/``: low-rank adapters over the
packed weights (``lora``), a training step with optional per-layer
rematerialization and gradient accumulation over a torch optimizer, on one
device or over a dp x tp mesh of ranks (``trainer``; the adapters' slices
``shard_lora`` / ``gather_lora``), resumable training state (``state``),
SFT batching (``data``), multi-LoRA banks (``stack_adapters``) and merging
an adapter into the packed weights (``merge_lora``).
"""

from .data import SFTBatch, pack_sft, pad_sft
from .lora import (
    LoraAB, LoraConfig, LoraLayer, LoraParams, gather_lora, init_lora, load_lora, lora_partition_specs, merge_lora,
    save_lora, shard_lora, stack_adapters,
)
from .state import load_train_state, save_train_state
from .trainer import lm_loss, make_train_step

__all__ = [
    "LoraConfig",
    "LoraAB",
    "LoraLayer",
    "LoraParams",
    "init_lora",
    "stack_adapters",
    "merge_lora",
    "save_lora",
    "load_lora",
    "lora_partition_specs",
    "shard_lora",
    "gather_lora",
    "lm_loss",
    "make_train_step",
    "save_train_state",
    "load_train_state",
    "SFTBatch",
    "pad_sft",
    "pack_sft",
]
