"""The port's installer.

    python -m nf4_tpu_torch.install [--skip-install]

Detects the platform (``"cuda"``: an sm_90 card and ``nvcc`` found, so the
hand-written kernels build and run; ``"cpu"`` otherwise: entry points need
``device="cpu"`` and run the kernels' plain PyTorch versions), runs
``pip install -e .`` unless ``--skip-install`` is given, and finishes with a
64 x 64 quantize / dequantize round trip through the public API on the CPU,
and on the card when there is one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def detect_platform() -> str:
    """``"cuda"`` for an sm_90 card with ``nvcc`` found, else ``"cpu"``."""
    print("=== Platform detection ===")
    import torch

    from .ops import _cuda

    print(f"  torch {torch.__version__} (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        print("  -> no CUDA device: entry points take device='cpu' (the kernels' plain PyTorch versions).")
        return "cpu"
    name, cc = torch.cuda.get_device_name(0), torch.cuda.get_device_capability(0)
    print(f"  card: {name}, compute capability {cc[0]}.{cc[1]}, x{torch.cuda.device_count()}")
    if cc[0] != 9:
        print("  -> not an sm_90 (Hopper) card: the kernels are built for sm_90a only; use device='cpu'.")
        return "cpu"
    try:
        print(f"  nvcc: {_cuda._nvcc()}")
    except RuntimeError as e:
        print(f"  -> {e}; use device='cpu' until the toolkit is installed.")
        return "cpu"
    print("  -> Hopper card and nvcc: the CUDA kernels build at first use into nf4_tpu_torch/_build/.")
    return "cuda"


def run_install() -> bool:
    print("\n=== Installing (pip install -e .) ===")
    proc = subprocess.run(
        # --no-build-isolation: the host's setuptools, nothing fetched.
        [sys.executable, "-m", "pip", "install", "-e", ".", "--no-deps", "--no-build-isolation"],
        capture_output=True, text=True, cwd=REPO,
    )
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-3:]:
        print(f"  {line}")
    return proc.returncode == 0


def smoke_test() -> bool:
    """A 64 x 64 quantize / dequantize round trip through the public API,
    bit for bit the oracle's, on the CPU and (with a card) on the card."""
    print("\n=== Smoke test ===")
    try:
        import numpy as np
        import torch

        import nf4_tpu_torch
        from nf4_tpu_torch.nf4.reference import dequantize_nf4, quantize_nf4

        w = np.linspace(-1, 1, 64 * 64, dtype=np.float32).reshape(64, 64)
        want = torch.from_numpy(dequantize_nf4(quantize_nf4(w), np.float32)).to(torch.bfloat16)
        devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
        for dev in devices:
            pw = nf4_tpu_torch.quantize_for_tpu(w, dtype=torch.bfloat16, device=dev)
            out = nf4_tpu_torch.dequantize(pw).cpu()
            if out.shape != (64, 64) or not torch.equal(out.view(torch.int16), want.view(torch.int16)):
                raise RuntimeError(f"{dev}: the round trip is not bit-exact vs the oracle")
        err = float((out.float() - torch.from_numpy(w)).abs().max())
        print(f"  import ok, 64x64 round trip ok on {' and '.join(devices)} (max quantization err {err:.4f})")
        return True
    except Exception as e:  # the installer reports any failure and exits 1
        print(f"  FAILED: {e!r}")
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nf4_tpu_torch.install")
    ap.add_argument("--skip-install", action="store_true", help="do not run pip install -e .")
    args = ap.parse_args(argv)

    detect_platform()
    if not args.skip_install and not run_install():
        print("install failed")
        return 1
    if not smoke_test():
        return 1
    print("\nnf4_tpu_torch is ready.  Next steps:")
    print("  python -m nf4_tpu_torch.diagnostics   # environment and kernel checks")
    print("  python -m nf4_tpu_torch.serve --model llama3-8b --synthetic   # an OpenAI-compatible server")
    return 0


if __name__ == "__main__":
    sys.exit(main())
