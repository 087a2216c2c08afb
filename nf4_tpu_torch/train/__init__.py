"""QLoRA fine-tuning on frozen packed 4-bit weights (one device).

The counterpart of the JAX package's ``train/``: low-rank adapters over the
packed weights (``lora``), a training step with optional per-layer
rematerialization and gradient accumulation over a torch optimizer
(``trainer``), resumable training state (``state``) and SFT batching
(``data``).  Still to port: ``merge_lora`` (it needs the quantizer),
``stack_adapters`` (multi-LoRA serving), and data- and tensor-parallel
training.
"""

from .data import SFTBatch, pack_sft, pad_sft
from .lora import LoraAB, LoraConfig, LoraLayer, LoraParams, init_lora, load_lora, save_lora
from .state import load_train_state, save_train_state
from .trainer import lm_loss, make_train_step

__all__ = [
    "LoraConfig",
    "LoraAB",
    "LoraLayer",
    "LoraParams",
    "init_lora",
    "save_lora",
    "load_lora",
    "lm_loss",
    "make_train_step",
    "save_train_state",
    "load_train_state",
    "SFTBatch",
    "pad_sft",
    "pack_sft",
]
