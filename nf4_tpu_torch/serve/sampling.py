"""Token sampling: the greedy branch of the JAX package's ``serve/sampling.py``.

:class:`SamplingParams` keeps the JAX package's fields so requests carry
over; only greedy decoding (``temperature=0``, no penalties, biases or
constraints) is ported yet, and anything else raises.  ``stop_tokens`` and
``max_new_tokens`` are host-side scheduler fields and are honoured.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingParams", "sample", "check_greedy"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: tuple = ()
    stop_tokens: tuple = ()  # extra end-of-sequence ids (host-side)
    max_new_tokens: Optional[int] = None  # budget override (host-side)
    choices: tuple = ()
    min_new_tokens: int = 0
    top_logprobs: int = 0
    seed: Optional[int] = None


def check_greedy(params: SamplingParams) -> None:
    """Raise unless ``params`` asks for plain greedy decoding."""
    default = SamplingParams()
    extra = [
        f.name
        for f in dataclasses.fields(SamplingParams)
        if f.name not in ("stop_tokens", "max_new_tokens")
        and getattr(params, f.name) != getattr(default, f.name)
    ]
    if extra:
        raise NotImplementedError(f"not ported yet: sampling with {', '.join(extra)}")


def sample(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Next tokens [B] from logits [B, V]: fp32 argmax, the first index on
    ties (as ``jnp.argmax``)."""
    check_greedy(params)
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
