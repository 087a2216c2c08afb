"""Process groups for tensor and data parallelism, on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py``.  JAX drives
every device from one program; here every rank is a process of its own
running the same program (SPMD), and a :class:`Mesh` is this rank's view
of the ``("dp", "tp")`` layout: its coordinates, the process groups of its
tensor-parallel and data-parallel axes, its device and the backend.
Ranks are laid out tp-fastest, ``rank = dp_rank * tp + tp_rank``, so the
tensor-parallel groups (a reduction per layer) are neighbouring ranks, as
the JAX package keeps its tp axis on the fastest links.

Launch recipe (one process per rank; :mod:`~nf4_tpu_torch.parallel.launch`
starts them on one host):

    from nf4_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    initialize_distributed("localhost:29500", num_processes=N, process_id=rank)
    mesh = make_mesh(tp=N)

The backend rule: ``nccl`` (the default) puts each rank on a GPU of its
own and raises where the host has fewer GPUs than ranks.  ``gloo`` runs
only where the caller names it: with ``device="cuda"`` every rank shares
``cuda:0`` (gloo's ``all_reduce`` and ``broadcast`` take CUDA tensors and
move them through the host; it measures no scaling), with ``device="cpu"``
the plain versions run on the CPU (the tests).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["Mesh", "initialize_distributed", "make_mesh"]

BACKENDS = ("nccl", "gloo")
# How long a rank waits in a rendezvous or a collective for the others.
TIMEOUT_S = 600


@dataclasses.dataclass
class Mesh:
    """One rank's place in a ``(dp, tp)`` layout of processes.
    ``tp_group`` / ``dp_group`` are the process groups of its tensor- and
    data-parallel axes; ``stats`` counts the collectives the
    tensor-parallel path runs over it (``calls``, ``bytes``; ``seconds``
    when ``timed``, each collective then waited for on the device)."""

    tp: int
    dp: int
    rank: int
    tp_rank: int
    dp_rank: int
    tp_group: Any
    dp_group: Any
    device: torch.device
    backend: str
    timed: bool = False
    stats: dict = dataclasses.field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})


def _check_backend(backend: str, ranks: int, device: Optional[torch.device]) -> None:
    """Raise where ``backend`` cannot give ``ranks`` ranks a device each."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; expected one of {BACKENDS}")
    if backend == "nccl":
        if device is not None and device.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; name backend='gloo' for the CPU")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < ranks:
            raise RuntimeError(f"nccl needs one GPU per rank: {ranks} ranks, {have} GPU(s) on this host; "
                               "name backend='gloo' to run the ranks on a shared device")


def initialize_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: str = "nccl") -> None:
    """Join this process to the job (``torch.distributed.
    init_process_group``, which reaches the rendezvous of every rank at a
    TCP store on ``coordinator_address``, "host:port"); idempotent.  With
    no arguments, the environment a launcher such as ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is read,
    and without it this is a single process and nothing is done.  ``nccl``
    with fewer GPUs on the host than ranks on it raises."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return
        world = int(os.environ["WORLD_SIZE"])
        _check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)), None)
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("pass coordinator_address, num_processes and process_id together")
    _check_backend(backend, num_processes, None)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=timeout)


def make_mesh(tp: Optional[int] = None, dp: int = 1, backend: Optional[str] = None, device=None) -> Optional[Mesh]:
    """This rank's :class:`Mesh` of a ``(dp, tp)`` layout over the first
    ``dp * tp`` ranks of the job (``tp`` defaults to the world size over
    ``dp``); None on a rank outside it.  Every rank of the job must call
    it, with the same arguments: it reaches ``torch.distributed.new_group``
    once per group of each axis, a collective call of the whole job.

    ``backend`` defaults to the job's; ``device`` defaults to ``cuda``
    (``nccl``: the GPU of this rank's place on the host; ``gloo``:
    ``cuda:0`` for every rank, or the CPU with ``device="cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp is None:
        tp = world // dp
    if tp < 1 or dp < 1 or dp * tp > world:
        raise ValueError(f"a mesh of dp={dp} x tp={tp} needs {dp * tp} ranks; the job has {world}")
    backend = backend or dist.get_backend()
    dev = resolve_device(device)
    _check_backend(backend, dp * tp, dev)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count() if backend == "nccl" else 0)
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)), backend=backend) for d in range(dp)]
    dp_groups = [dist.new_group(list(range(t, dp * tp, tp)), backend=backend) for t in range(tp)]
    if rank >= dp * tp:
        return None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dp_rank, tp_rank = divmod(rank, tp)
    return Mesh(tp=tp, dp=dp, rank=rank, tp_rank=tp_rank, dp_rank=dp_rank, tp_group=tp_groups[dp_rank],
                dp_group=dp_groups[tp_rank], device=dev, backend=backend)
