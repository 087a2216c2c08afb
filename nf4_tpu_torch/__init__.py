"""nf4_tpu_torch -- the NF4 engine in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of the JAX package ``nf4_tpu`` that keeps its packed weight layout
byte for byte and its public names.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; on the CPU every kernel is replaced by its
plain PyTorch version (the tests' path), and without a card they raise
rather than fall back.

* :func:`dequantize_nf4_module` -- dequantize a bitsandbytes-style
  ``Linear4bit`` module (duck-typed), bit-exact.
* :func:`quantize_nf4` / :func:`dequantize_nf4` -- the bit-exact NumPy
  oracle of bitsandbytes' flat 4-bit format (the JAX package's code).
* :class:`PackedNF4`, :func:`quantize_for_tpu`, :func:`pack_for_tpu` -- the
  packed layout (the names are the JAX package's; the layout is the same
  here); ``quantize_for_tpu`` quantizes on the card, the oracle's bytes.
* :func:`dequantize` / :func:`dequantize_t` -- exact dequant (kernel
  ``csrc/dequant.cu``).
* :func:`dequantize_fast` / :func:`dequantize_t_fast` -- bf16 dequant
  through the byte table (``csrc/dequant.cu``'s second kernel).
* :func:`nf4_matmul` -- fused dequant-matmul: bf16 activations on kernel
  ``csrc/matmul.cu``, fp32/fp16 on ``csrc/matmul_exact.cu``;
  differentiable in the activations (the weight stays frozen).

* :func:`init_params` -- a seeded random model (the JAX package's draws).

Serving lives in ``models/`` (Llama; HF checkpoint directories and packed
checkpoints in ``models/loader.py``; the int8 recode ``recode_params_int8``) and
``serve/engine.py`` (``Engine.score`` too); perplexity and scoring in
``eval/``; QLoRA fine-tuning in ``train/``.
"""

from .nf4.format import PackedNF4, pack_for_tpu, quantize_for_tpu
from .nf4.lut import FP4_CODE, NF4_CODE, dynamic_code, get_code
from .nf4.reference import QuantState, dequantize_nf4, quantize_nf4
from .ops.dequant import dequantize, dequantize_fast, dequantize_t, dequantize_t_fast
from .models.llama import init_params
from .ops.matmul import nf4_matmul

__version__ = "0.1.0"

__all__ = [
    "NF4_CODE",
    "FP4_CODE",
    "get_code",
    "dynamic_code",
    "QuantState",
    "quantize_nf4",
    "dequantize_nf4",
    "PackedNF4",
    "quantize_for_tpu",
    "pack_for_tpu",
    "dequantize",
    "dequantize_t",
    "dequantize_fast",
    "dequantize_t_fast",
    "nf4_matmul",
    "init_params",
    "dequantize_nf4_module",
    "reset_dequantize_state",
]


def dequantize_nf4_module(module, device=None):
    """Dequantize a bitsandbytes-style ``Linear4bit`` module to its [m, n]
    weight on ``device`` (default ``cuda``): fp16 when the module's
    quant_state says fp16, else bf16 (the JAX package's rule)."""
    import torch

    from .nf4.adapters import quant_state_from_module

    state = quant_state_from_module(module)
    dtype = torch.float16 if state.dtype == torch.float16 else torch.bfloat16
    return dequantize(pack_for_tpu(state, dtype=dtype, device=device))


def reset_dequantize_state():
    """A no-op kept for API parity: the port caches nothing that needs
    clearing (its kernels build once per source into ``_build/`` and load
    once per process; PyTorch runs eagerly, so there are no traced
    programs to drop)."""
