"""Codebook evaluation: the 16-entry nibble lookup and the byte table.

The JAX package evaluates the codebook as a select tree or a per-vreg
gather (``nf4_tpu/ops/lut_eval.py``), both TPU vector-unit tricks.  Here
the lookup is a plain 16-entry gather in fp32, and the fused matmul kernel
receives the 256-entry byte table as a uint32 tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..nf4.lut import get_code

__all__ = ["code_tensor", "nf4_lookup", "byte_word_table"]


@functools.lru_cache(maxsize=None)
def _code_cached(quant_type: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(get_code(quant_type).copy()).to(device)


def code_tensor(quant_type: str, device) -> torch.Tensor:
    """The 16-entry fp32 codebook on ``device`` (cached per device)."""
    return _code_cached(quant_type, torch.device(device))


def nf4_lookup(nibble: torch.Tensor, quant_type: str = "nf4") -> torch.Tensor:
    """Map integer nibbles (0..15) to fp32 codebook values."""
    return code_tensor(quant_type, nibble.device)[nibble.long()]


@functools.lru_cache(maxsize=None)
def _byte_table_np(quant_type: str) -> np.ndarray:
    # bf16 bits of each code value: round-to-nearest-even of the fp32 bits.
    code = get_code(quant_type).astype(np.float32)
    bits = torch.from_numpy(code.copy()).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    t = np.zeros(256, np.uint32)
    for byte in range(256):
        t[byte] = (np.uint32(bits[byte >> 4]) << 16) | np.uint32(bits[byte & 0xF])
    return t


@functools.lru_cache(maxsize=None)
def _byte_table_cached(quant_type: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_byte_table_np(quant_type).view(np.int32).copy()).to(device)


def byte_word_table(quant_type: str, device) -> torch.Tensor:
    """The 256-entry byte -> packed bf16 pair table as int32 [256] (the
    kernel reads it as uint32): ``T[b] = bits(code[b >> 4]) << 16 |
    bits(code[b & 15])`` -- low half K row 2j, high half K row 2j+1."""
    return _byte_table_cached(quant_type, torch.device(device))
