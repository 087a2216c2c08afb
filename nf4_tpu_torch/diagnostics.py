"""Environment and kernel diagnostics for the port.

    python -m nf4_tpu_torch.diagnostics

The sections, in order:

1. Environment: Python, torch, CUDA, ``nvcc`` and ``g++`` versions; the
   card's name and power limit (``nvidia-smi``); free and total memory; the
   port's environment flag (``NF4TPU_NATIVE``).
2. Kernel build smoke: ``ops._cuda.build()`` (one ``nvcc`` per source, in
   parallel), its first call's time against a cached call's, and kernel A's
   first launch against a steady-state launch.
3. 1024 x 1024 dequant: kernel A (``dequantize``) against its plain
   version and the NumPy oracle, bit for bit, NF4 and FP4; kernel F
   (``dequantize_fast``) bit for bit against its plain version and within
   1.1e-2 of the oracle; each kernel's time beside its plain version's
   (CUDA events).
4. Routes: the ``device="cpu"`` route gives the oracle's bytes (and the
   card's, where there is one), the C++ host quantizer too; an entry
   point that defaults to CUDA raises when no card is present rather than
   running on the CPU; an invalid ``NF4TPU_NATIVE`` is rejected.
5. Triage: exit code 0 only if every check passed.

A kernel that fails to build or launch raises: nothing here catches it and
carries on.  Without a card, sections 2 and 3 record a failure.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

PASS, FAIL, WARN = "[ok]", "[FAIL]", "[warn]"
failures = []


def section(title):
    print(f"\n=== {title} ===")


def check(ok: bool, msg: str, warn_only: bool = False):
    tag = PASS if ok else (WARN if warn_only else FAIL)
    print(f"  {tag} {msg}")
    if not ok and not warn_only:
        failures.append(msg)


def _version(cmd, marker: str = "") -> str:
    """The line of a tool's version output that holds ``marker`` (else its
    first line), or why there is none."""
    if shutil.which(cmd[0]) is None:
        return "not found"
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not run ({e})"
    lines = [ln.strip() for ln in (out.stdout + out.stderr).splitlines() if ln.strip()]
    return next((ln for ln in lines if marker in ln), "no output")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def env_report():
    section("Environment")
    from .ops import _cuda

    print(f"  python:  {sys.version.split()[0]}")
    print(f"  torch:   {torch.__version__} (CUDA {torch.version.cuda})")
    try:
        nvcc = _version([_cuda._nvcc(), "--version"], "release")
    except RuntimeError as e:
        nvcc = str(e)
    print(f"  nvcc:    {nvcc}")
    print(f"  g++:     {_version(['g++', '--version'])}")
    if torch.cuda.is_available():
        print(f"  card:    {card_line()} (x{torch.cuda.device_count()})")
        free, total = torch.cuda.mem_get_info()
        print(f"  memory:  {free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB")
    else:
        print("  card:    none (torch.cuda.is_available() is False)")
    print(f"  NF4TPU_NATIVE = {os.environ.get('NF4TPU_NATIVE', '<unset>')}")
    check(True, "environment readable")


def _event_ms(fn, iters: int = 10) -> float:
    """Mean ms of ``fn`` over ``iters`` eager calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_build_smoke():
    """Build every kernel library; a cached call's time; kernel A's first
    launch against a steady-state launch."""
    section("Kernel build smoke (nvcc, sm_90a)")
    if not torch.cuda.is_available():
        check(False, "no CUDA device: the kernels cannot be built and launched here")
        return
    from . import dequantize, quantize_for_tpu
    from .ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = _cuda.build()
    cached_s = time.perf_counter() - t0
    check(not again, f"every library cached after the first build (rebuilt {sorted(again)})")
    print(f"  first build() {first_s:.2f} s (built {sorted(built) or 'nothing: cached'}), "
          f"cached {cached_s * 1e3:.2f} ms")

    pw = quantize_for_tpu(np.eye(128, 1024, dtype=np.float32), method="oracle")
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = dequantize(pw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    steady_ms = _event_ms(lambda: dequantize(pw))
    check(_cuda.launch_counts()["dequant_t"] == 11, "kernel A launched once per call")
    check(torch.equal(out.float().cpu(), torch.eye(128, 1024)), "kernel A dequantizes the identity exactly")
    print(f"  kernel A first launch (library load included) {first_ms:.2f} ms, steady state {steady_ms:.4f} ms")


def dequant_check():
    section("Dequant: kernels A and F against their plain versions and the oracle (1024x1024)")
    if not torch.cuda.is_available():
        check(False, "no CUDA device: kernels A and F cannot run here")
        return
    from . import dequantize, dequantize_fast, pack_for_tpu
    from .nf4.reference import dequantize_nf4, quantize_nf4
    from .ops import _cuda
    from .ops.dequant import _bf16_weight_t, _dequant_t_plain

    rng = np.random.default_rng(0)
    w = (rng.standard_normal((1024, 1024)) * 0.02).astype(np.float32)
    for qt in ("nf4", "fp4"):
        state = quantize_nf4(w, quant_type=qt)
        pw = pack_for_tpu(state, dtype=torch.bfloat16)
        oracle = torch.from_numpy(dequantize_nf4(state, np.float32)).to(torch.bfloat16)
        _cuda.reset_launch_counts()
        got = dequantize(pw)
        plain = _dequant_t_plain(pw.packed, pw.scales, torch.bfloat16, qt).T
        fast = dequantize_fast(pw)
        fast_plain = _bf16_weight_t(pw.packed, pw.scales, qt).T
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        check(counts["dequant_t"] == 1 and counts["dequant_t_fast"] == 1,
              f"{qt}: kernels A and F each launched once ({counts['dequant_t']}, {counts['dequant_t_fast']})")
        bits = lambda t: t.contiguous().cpu().view(torch.int16)  # noqa: E731
        check(torch.equal(bits(got), bits(plain)), f"{qt}: kernel A bit-exact vs its plain version")
        check(torch.equal(bits(got), bits(oracle)), f"{qt}: kernel A bit-exact vs the NumPy oracle")
        check(torch.equal(bits(fast), bits(fast_plain)), f"{qt}: kernel F bit-exact vs its plain version")
        ref = oracle.float()
        rel = ((fast.float().cpu() - ref).abs() / (ref.abs() + 1e-12)).where(ref != 0, fast.float().cpu().abs())
        check(bool(rel.max() <= 1.1e-2), f"{qt}: kernel F within 1.1e-2 of the oracle (max {rel.max():.2e})")
        if qt == "nf4":
            ms = _event_ms(lambda: dequantize(pw))
            plain_ms = _event_ms(lambda: _dequant_t_plain(pw.packed, pw.scales, torch.bfloat16, qt))
            fast_ms = _event_ms(lambda: dequantize_fast(pw))
            fast_plain_ms = _event_ms(lambda: _bf16_weight_t(pw.packed, pw.scales, qt))
            print(f"  kernel A {ms:.4f} ms, plain {plain_ms:.4f} ms; kernel F {fast_ms:.4f} ms, plain "
                  f"{fast_plain_ms:.4f} ms (eager calls, CUDA events)")


@contextlib.contextmanager
def _env(name, value):
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


@contextlib.contextmanager
def _no_card():
    """Within it the process sees no CUDA device."""
    saved = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        yield
    finally:
        torch.cuda.is_available = saved


def backend_check():
    section("Routes: device='cpu', the C++ host quantizer, no card, NF4TPU_NATIVE")
    from . import dequantize, quantize_for_tpu
    from .nf4 import native
    from .nf4.reference import dequantize_nf4, quantize_nf4

    w = np.eye(128, 128, dtype=np.float32)
    cpu = quantize_for_tpu(w, method="oracle", device="cpu")
    out = dequantize(cpu, torch.float32).numpy()
    check(bool(np.array_equal(out, dequantize_nf4(quantize_nf4(w), np.float32))),
          "device='cpu' dequantizes the identity to the oracle's values")
    check(native.available(), f"the C++ host quantizer builds and loads ({native.lib_path().name})")
    if native.available():
        nat = quantize_for_tpu(w, method="native", device="cpu")
        check(torch.equal(nat.packed, cpu.packed) and torch.equal(nat.scales, cpu.scales),
              "method='native' gives the oracle's bytes")
    if torch.cuda.is_available():
        card = quantize_for_tpu(w, method="device")
        check(torch.equal(card.packed.cpu(), cpu.packed) and torch.equal(card.scales.cpu(), cpu.scales),
              "the card quantizer gives the CPU route's bytes")
    with _no_card():
        try:
            quantize_for_tpu(w)
            check(False, "without a card, quantize_for_tpu() (default device cuda) raises")
        except RuntimeError as e:
            check("no CUDA device" in str(e), "without a card, quantize_for_tpu() (default device cuda) raises")
    with _env("NF4TPU_NATIVE", "bogus"):
        try:
            quantize_for_tpu(w, method="native", device="cpu")
            check(False, "invalid NF4TPU_NATIVE rejected")
        except ValueError:
            check(True, "invalid NF4TPU_NATIVE rejected")


def triage():
    section("Triage summary")
    if not failures:
        print("  all checks passed: the port is healthy on this host.")
        return
    print(f"  {len(failures)} failure(s):")
    for f in failures:
        print(f"   - {f}")
    print(
        "  advice:\n"
        "   * no card: entry points take device='cpu' (the plain PyTorch versions of the kernels).\n"
        "   * nvcc not found: install the CUDA toolkit or set CUDA_HOME; the kernels build for sm_90a.\n"
        "   * the C++ quantizer did not build: install g++, or set NF4TPU_NATIVE=0 to use the others.\n"
        "   * report with the full output of this script."
    )


def main() -> int:
    failures.clear()
    env_report()
    kernel_build_smoke()
    dequant_check()
    backend_check()
    triage()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
