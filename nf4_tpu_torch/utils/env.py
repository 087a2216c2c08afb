"""Runtime configuration through environment variables: the JAX package's
``utils/env.py`` for the port.

* ``NF4TPU_BACKEND``: ``auto`` (default) | ``pallas`` | ``jnp`` (the JAX
  package's names, which users already set).  ``auto`` runs each
  hand-written CUDA kernel on a CUDA tensor and its plain PyTorch version
  on a CPU tensor; ``jnp`` runs the plain version on every device, the
  card included; ``pallas`` runs the kernel and raises on a CPU tensor
  (the JAX package interprets its kernels there; the port has no
  interpreter, and falls back to nothing).  Read by the ops at every call
  (``ops/matmul.py``, ``ops/int8_serve.py``, ``ops/dequant.py``,
  ``ops/attention.py``), as the JAX ops read it at trace time; a CUDA graph
  keeps the choice that was in force when it was captured, as a jitted
  JAX function keeps the one of its trace.
* ``NF4TPU_MATMUL_TILE=bm,bks,bo``: the fused matmul's tiles (kernels B, D
  and E): ``bm`` the batch rows of a block (16: the decode kernel; 128 or
  256: that prefill block layout), ``bks`` the K rows of a split (the K
  split is ``n_pad / bks``), ``bo`` the output columns of a block, which
  must be the chosen layout's.  A triple a kernel's built code lacks
  raises a ``ValueError`` that names the ones it has
  (``ops/matmul.py:_tile_plan``).
* ``NF4TPU_COLLECTIVE_MATMUL``: row-parallel projections in this many
  chunks of output columns, each reduced on its own (``models/llama.py:
  _reduced_matmul``).
* ``NF4TPU_NATIVE``: the C++ host quantizer; read in ``nf4/native.py``.

``NF4TPU_INTERPRET`` (the Pallas interpreter) and ``NF4TPU_LUT`` (the TPU's
gather unit or a select tree for the codebook) have no meaning on the
H100 and are not read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["backend", "backend_choice", "use_kernel", "matmul_tile_override", "collective_chunks"]

_VALID_BACKENDS = ("auto", "pallas", "jnp")


def backend_choice() -> str:
    """The raw NF4TPU_BACKEND setting: 'auto', 'pallas', or 'jnp'."""
    choice = os.environ.get("NF4TPU_BACKEND", "auto").lower()
    if choice not in _VALID_BACKENDS:
        raise ValueError(f"NF4TPU_BACKEND={choice!r} invalid; expected one of {_VALID_BACKENDS}")
    return choice


def backend(device=None) -> str:
    """The compute backend for tensors on ``device``: 'pallas' (the
    hand-written kernels) or 'jnp' (their plain PyTorch versions).  ``auto``
    resolves to 'pallas' on a CUDA device; ``device`` defaults to CUDA when
    a card is present, else the CPU (the JAX package's ``on_tpu()``)."""
    choice = backend_choice()
    if choice != "auto":
        return choice
    if device is None:
        return "pallas" if torch.cuda.is_available() else "jnp"
    return "pallas" if torch.device(device).type == "cuda" else "jnp"


def use_kernel(t: torch.Tensor) -> bool:
    """Does an op on ``t`` launch its CUDA kernel (else its plain version)?
    Under ``pallas`` a tensor off the card raises: no kernel runs there."""
    if backend(t.device) == "jnp":
        return False
    if not t.is_cuda:
        raise RuntimeError(f"NF4TPU_BACKEND=pallas runs the CUDA kernels, and this tensor is on {t.device}: "
                           "move it to the card, or set NF4TPU_BACKEND=auto or jnp for the plain versions")
    return True


def collective_chunks() -> int:
    """``NF4TPU_COLLECTIVE_MATMUL`` (the JAX package's flag): compute each
    row-parallel projection in this many chunks of output columns, each
    reduced on its own as soon as it is computed (a collective matmul, so
    chunk c's reduction can overlap chunk c+1's product); 0 or unset is one
    reduction.  It changes no value: each element sees the same sum."""
    raw = os.environ.get("NF4TPU_COLLECTIVE_MATMUL", "0")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"NF4TPU_COLLECTIVE_MATMUL={raw!r}; expected an integer chunk count") from None
    if n < 0:
        raise ValueError(f"NF4TPU_COLLECTIVE_MATMUL={n} must be >= 0")
    return n


def matmul_tile_override() -> Optional[tuple]:
    """``NF4TPU_MATMUL_TILE`` as ``(bm, bks, bo)``, or None when unset."""
    raw = os.environ.get("NF4TPU_MATMUL_TILE")
    if not raw:
        return None
    parts = tuple(int(p) for p in raw.split(","))
    if len(parts) != 3:
        raise ValueError("NF4TPU_MATMUL_TILE must be 'bm,bks,bo'")
    return parts
