"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``nf4_tpu_torch/_build/`` (listed in
``.gitignore``) at first use, then bound with ``ctypes``.  A C entry point
launches on the stream it is given and returns ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["Kernel", "KERNELS", "build", "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("dequant", "matmul", "matmul_exact", "int8_matmul", "flash_attn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    """The library for source ``name``, keyed by the source's and headers'
    content and the flags, so an edited source rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: ptxas report}`` for the sources it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        reports[name] = stderr
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    build((name,))
    return ctypes.CDLL(str(_lib_path(name)))


class Kernel:
    """One C entry point of a ``csrc`` library and its launch count.

    ``launches`` grows by one per successful launch and nowhere else, so a
    run can show that its main path went through the kernel."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name, self.source, self.symbol = name, source, symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + the stream
        self.launches = 0
        self._lib = self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        lib = _load(self.source)
        if lib is not self._lib:  # bound once per library
            fn = getattr(lib, self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._lib, self._fn = lib, fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with error {err}")
        self.launches += 1


KERNELS: dict = {}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
