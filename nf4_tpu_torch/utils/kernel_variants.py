"""Time what a kernel's time is made of, in one process on one card: the two
prefill layouts of kernels B and D at each prompt size, and text-edited
variants of a CUDA source beside the source as it is.

    python -m nf4_tpu_torch.utils.kernel_variants [--only layouts|decode|matmul|int8_matmul|matmul_exact|flash]

A variant is the source and its headers with a few lines replaced (a step
skipped, an intrinsic swapped); it is built with the port's nvcc flags into
a scratch directory under ``_build/``, and the port's own wrappers launch it
in place of the built source.  Variants that compute the same function report their
largest difference from the unedited build; variants that skip work report
nothing to compare.  Times are the mean device time of one launch, from the
replay of a CUDA graph of 20 launches after a warm-up, at the shapes
``chip_smoke.py`` times: kernels B and D at Llama-3-8B's four projections
(the layouts at 64 to 1024 rows; the variants of kernel B's decode kernel
at 4 rows, padded to 16; the variants of kernels B, D and E at w_gateup
and w_down with 1024 rows), kernel C at B=1, H=32, KV=8, D=128, S=1024 (causal from position 0,
and the last 1024 positions of an 8192-slot cache under a 4096-slot
window), bf16 and int8 KV.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import shutil
import subprocess

import torch

from ..ops import _cuda

# Kernel B without the decode of steps after the first, or without the
# copies after the prologue (and without waiting for them: a wait for a
# copy never started would never end); these edit the main loop it shares
# with kernels D and E (csrc/dequant_gemm.cuh).
_NO_DECODE = [("    if (i + 1 < nk) decode(i + 1, (i + 1) % L::W_TILES);", "")]
_NO_LOADS = [
    ("    if (i + STAGES - 1 < nk) load(i + STAGES - 1);", ""),
    ("      hop::mbar_wait(mbar + ((i + 1) % STAGES) * 8, ((i + 1) / STAGES) & 1);\n", ""),
]

# (name, [(old text, new text), ...], same function as the source?)
MATMUL_VARIANTS = [
    ("as is", [], True),
    ("one byte table (not 32 bank-private copies)", [
        ("(table)[i / 32];", "(table)[i % 256];"),
        ("lut[((pw[r] >> (8 * e)) & 0xff) * 32 + lane]", "lut[(pw[r] >> (8 * e)) & 0xff]"),
    ], True),
    ("no decode after step 0", _NO_DECODE, False),
    ("no loads after the prologue", _NO_LOADS, False),
    ("neither", _NO_DECODE + _NO_LOADS, False),
    ("neither, and no barrier after the products", _NO_DECODE + _NO_LOADS + [
        ("    hop::wgmma_wait<0>();\n    hop::fence_proxy_async();\n    __syncthreads();",
         "    hop::wgmma_wait<0>();"),
    ], False),
]

# Kernel B's decode kernel (bm = 16): its block shape (warps side by side
# over columns x warps on the same columns over K) and ring depth (each
# changes the shared memory and registers of a block, so the occupancy and
# with it the K split), the products of zero batch rows 8-15 not skipped;
# and, not the same function, without the table lookup, without the
# copies or without reading the ring (its reads, decode and products: what
# each costs), and copying only the first 4 scale blocks of every column
# (the copies served from L2, not DRAM).
_DK = ("constexpr int WN = 1;        // warps side by side over a block's columns\n"
       "constexpr int WK = 4;        // warps on the same columns, each over its own scale blocks\n"
       "constexpr int STAGES = 4;    // scale blocks in a lane's ring")


def _dk(wn, wk, stages):
    return [(_DK, _DK.replace("WN = 1", f"WN = {wn}").replace("WK = 4", f"WK = {wk}")
             .replace("STAGES = 4", f"STAGES = {stages}"))]


_COPY = "hop::cp_async16(dst + r * 512, src + (size_t)r * m_pad, true);"
_NO_COPIES = [(f"      for (int r = 0; r < PIECES; ++r) {_COPY}", "      (void)src, (void)dst;")]
_NO_PRODUCTS = [("    for (int s = 0; s < 4; ++s) {\n      const uint4 lo4", "    for (int s = 0; s < 0; ++s) {\n      const uint4 lo4")]
DECODE_VARIANTS = [
    ("as is", [], True),
    ("batch rows 8-15 multiplied when zero", [("if (rows_hi) hop::mma_bf16_16816(", "hop::mma_bf16_16816(")], True),
    ("2 x 4 warps (256 columns), 3 stages", _dk(2, 4, 3), True),
    ("2 x 2 warps (256 columns), 4 stages", _dk(2, 2, 4), True),
    ("4 x 2 warps (512 columns), 2 stages", _dk(4, 2, 2), True),
    ("1 x 8 warps, 2 stages", _dk(1, 8, 2), True),
    ("no table lookup", [("uint32_t w = *reinterpret_cast<const uint32_t*>(lut + off);", "uint32_t w = off;")],
     False),
    ("no copies of the weights", _NO_COPIES, False),
    ("no products", _NO_PRODUCTS, False),
    ("no products, copies of the first 4 scale blocks only", _NO_PRODUCTS + [
        ("const uint8_t* src = pk + (size_t)kb * (BK / 2) * m_pad;",
         "const uint8_t* src = pk + (size_t)(kb % 4) * (BK / 2) * m_pad;")], False),
    ("neither copies nor products", _NO_COPIES + _NO_PRODUCTS, False),
]

# Kernels D and E on the same main loop.
_LOOP_VARIANTS = [
    ("no decode after step 0", _NO_DECODE, False),
    ("no loads after the prologue", _NO_LOADS, False),
    ("neither", _NO_DECODE + _NO_LOADS, False),
]
INT8_VARIANTS = [("as is", [], True), *_LOOP_VARIANTS]
EXACT_VARIANTS = [
    ("as is", [], True),
    # Every product into one accumulator over all of K: the tensor cores'
    # truncation then drifts with K (compare the max |diff|).
    ("one accumulator (no step sums)", [
        ("  static constexpr bool STEP_SUMS = true;", "  static constexpr bool STEP_SUMS = false;"),
        ("hop::wgmma_desc(xl + kk * 32), w_hi, kk > 0);", "hop::wgmma_desc(xl + kk * 32), w_hi, 1);"),
        ("hop::wgmma_m64n128k8_tf32(acc, x_hi, w_lo, XLO || kk > 0);", "hop::wgmma_m64n128k8_tf32(acc, x_hi, w_lo, 1);"),
    ], True),
    # The decode's rounding to tf32 by cvt.rna.tf32.f32 instead of the
    # integer add and mask (the same value for finite weights).
    ("cvt.rna in the decode (not the integer rounding)", [
        ("        hi[k] = tf32_rna_int(v);", "        hi[k] = hop::tf32_rna(v);"),
        ("        lo[k] = tf32_rna_int(__fsub_rn(", "        lo[k] = hop::tf32_rna(__fsub_rn("),
    ], True),
    *_LOOP_VARIANTS,
]

FLASH_VARIANTS = [
    ("as is", [], True),
    ("expf instead of __expf", [("__expf(", "expf(")], True),
    ("two query tiles per block for bf16 KV too", [("constexpr int QT = INT8 ? 2 : 1;", "constexpr int QT = 2;")],
     True),
]

VARIANTS = {"matmul": MATMUL_VARIANTS, "int8_matmul": INT8_VARIANTS, "matmul_exact": EXACT_VARIANTS,
            "flash_attn": FLASH_VARIANTS}

# Kernel B's shapes: name -> (out m, in n, output dtype), as chip_smoke.py.
_PROJ = {
    "wqkv": (6144, 4096, torch.bfloat16),
    "wo": (4096, 4096, torch.float32),
    "w_gateup": (28672, 4096, torch.bfloat16),
    "w_down": (4096, 14336, torch.float32),
}
_L2_BYTES = 50 * 2**20


def edited_sources(source: str, edits) -> dict:
    """``{file name: text}`` of ``csrc/<source>.cu`` and every header in
    ``csrc/``, with each (old, new) edit applied to every file that holds the
    old text; raises if no file holds it."""
    paths = [_cuda.CSRC / f"{source}.cu", *sorted(_cuda.CSRC.glob("*.cuh"))]
    texts = {p.name: p.read_text() for p in paths}
    for old, new in edits:
        hits = [name for name, text in texts.items() if old in text]
        if not hits:
            raise RuntimeError(f"{old[:60]!r} not in {source}.cu or its headers")
        for name in hits:
            texts[name] = texts[name].replace(old, new)
    return texts


def _build(source: str, variants, out_dir, logs=None):
    """Build every variant of ``csrc/<source>.cu``, each in its own
    directory with its headers; returns {name: CDLL}.  ``logs``, a dict,
    gets each variant's compiler output (ptxas's registers and spills)."""
    import ctypes

    procs = {}
    for i, (name, edits, _) in enumerate(variants):
        vdir = out_dir / f"{source}_{i}"
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        for fname, text in edited_sources(source, edits).items():
            (vdir / fname).write_text(text)
        lib = vdir / f"lib{source}_{i}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(vdir / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} did not build:\n{err[-4000:]}")
        if logs is not None:
            logs[name] = err
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@contextlib.contextmanager
def _library(source: str, lib):
    """Send the port's launches of ``source``'s kernels to ``lib``."""
    load = _cuda._load
    _cuda._load = lambda name: lib if name == source else load(name)
    try:
        yield
    finally:
        _cuda._load = load


def _time(calls, iters=20) -> float:
    """Mean device ms of one call, cycling through ``calls``: the replay of
    a CUDA graph of ``iters`` calls."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _report(label, variants, run):
    """``run(name) -> (ms, output)``; prints each variant beside the first."""
    ref = None
    for name, _, same in variants:
        ms, out = run(name)
        diff = ""
        if ref is None:
            ref = out.float().clone()
        elif same:
            diff = f"; max |diff| from as is {(out.float() - ref).abs().max().item():.3g}"
        print(f"{label} {name}: {ms:.4f} ms{diff}", flush=True)


def _weights(gen, dev, int8=False):
    """Per projection: random packed (``int8``: int8) weights and scales,
    enough copies to hold twice the L2 cache, so no launch reads the previous
    one's bytes."""
    out = {}
    for proj, (m, n, _) in _PROJ.items():
        nbytes = m * n * (1.0625 if int8 else 0.5625)
        copies = max(1, min(16, math.ceil(2 * _L2_BYTES / nbytes)))
        out[proj] = [
            (torch.randint(-127, 128, (n, m), generator=gen, device=dev, dtype=torch.int8) if int8 else
             torch.randint(0, 256, (n // 2, m), generator=gen, device=dev, dtype=torch.uint8),
             torch.rand((n // 64, m), generator=gen, device=dev) * 0.02)
            for _ in range(copies)
        ]
    return out


def layouts() -> None:
    """Kernels B's and D's prefill layouts at each prompt size: one layer's
    four projections, each layout with its own K split."""
    from ..ops.int8_serve import _int8_matmul_kernel
    from ..ops.matmul import _PREFILL_COLS, _matmul_bf16_kernel, _prefill_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, kern, int8 in (("B", _matmul_bf16_kernel, False), ("D", _int8_matmul_kernel, True)):
        ws = _weights(gen, dev, int8)
        for b in (64, 128, 192, 320, 512, 704, 1024):
            xs = {proj: torch.randn((b, n), generator=gen, device=dev).to(torch.bfloat16)
                  for proj, (_, n, _) in _PROJ.items()}
            times, outs = {}, {}
            for rows in _PREFILL_COLS:
                times[rows] = 0.0
                for proj, (_, _, od) in _PROJ.items():
                    calls = [lambda x=xs[proj], w=w, s=s, od=od, rows=rows: kern(x, w, s, od, rows=rows)
                             for w, s in ws[proj]]
                    times[rows] += _time(calls)
                    outs[rows, proj] = calls[0]().float()
            diff = max((outs[256, p] - outs[128, p]).abs().max().item() for p in _PROJ)
            print(f"kernel {label} prefill, four projections, B={b}: 256 x 128 blocks {times[256]:.4f} ms, "
                  f"128 x 256 blocks {times[128]:.4f} ms; picked {_prefill_rows(b, 4096)} rows; "
                  f"max |diff| {diff:.3g}", flush=True)
        del ws


def decode(out_dir) -> None:
    """The variants of kernel B's decode kernel: one layer's four
    projections at 4 rows (b_pad 16), each variant with the K split its own
    occupancy gives."""
    from ..ops.matmul import _decode_ksplit, _decode_shape, _matmul_bf16_kernel

    logs = {}
    libs = _build("matmul", DECODE_VARIANTS, out_dir, logs)
    for name, err in logs.items():  # the decode kernel's entry is followed by its register count
        lines = err.splitlines()
        at = next((i for i, line in enumerate(lines) if "decode_kernel" in line and "Compiling" in line), None)
        used = [line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4] if "registers" in line or "spill" in line]
        print(f"  {name}: ptxas {'; '.join(used) if at is not None else 'no decode kernel found'}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = _weights(gen, dev)
    x = {}
    for proj, (_, n, _) in _PROJ.items():
        x[proj] = torch.zeros((16, n), device=dev, dtype=torch.bfloat16)
        x[proj][:4] = torch.randn((4, n), generator=gen, device=dev).to(torch.bfloat16)

    def run(name):
        with _library("matmul", libs[name]):
            times, outs, splits = [], [], []
            for proj, (m, n, od) in _PROJ.items():
                calls = [lambda w=w, s=s, od=od, proj=proj: _matmul_bf16_kernel(x[proj], w, s, od)
                         for w, s in ws[proj]]
                times.append(_time(calls))
                outs.append(calls[0]().float().ravel())
                splits.append(_decode_ksplit(16, m, n // 64, dev))
            print(f"  {name}: blocks of {_decode_shape(dev)[0]} columns, {_decode_shape(dev)[1]} per SM, "
                  f"K splits {splits}, ms "
                  + ", ".join(f"{p} {t:.4f}" for p, t in zip(_PROJ, times)), flush=True)
            return sum(times), torch.cat(outs)

    _report("kernel B decode, four projections, B=4", DECODE_VARIANTS, run)
    del ws


def matmul(out_dir, source="matmul") -> None:
    """The variants of kernel B (``matmul``), D (``int8_matmul``) or E
    (``matmul_exact``, fp32 x and out) at w_gateup and w_down, 1024 rows."""
    from ..ops.int8_serve import _int8_matmul_kernel
    from ..ops.matmul import _matmul_bf16_kernel, _matmul_exact_kernel

    libs = _build(source, VARIANTS[source], out_dir)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b = 1024
    for proj in ("w_gateup", "w_down"):
        m, n, _ = _PROJ[proj]
        x = torch.randn((b, n), generator=gen, device=dev)
        scales = torch.rand((n // 64, m), generator=gen, device=dev) * 0.02
        if source == "int8_matmul":
            label, od, x = "D", torch.bfloat16, x.to(torch.bfloat16)
            w = torch.randint(-127, 128, (n, m), generator=gen, device=dev, dtype=torch.int8)
            kern = _int8_matmul_kernel
        else:
            w = torch.randint(0, 256, (n // 2, m), generator=gen, device=dev, dtype=torch.uint8)
            if source == "matmul":
                label, od, x, kern = "B", torch.bfloat16, x.to(torch.bfloat16), _matmul_bf16_kernel
            else:
                label, od, kern = "E", torch.float32, _matmul_exact_kernel

        def run(name):
            with _library(source, libs[name]):
                call = lambda: kern(x, w, scales, od)
                return _time([call]), call()

        _report(f"kernel {label} {proj} B={b} m={m} n={n} ({2 * b * m * n / 1e9:.1f} GFLOP)", VARIANTS[source], run)


def flash(out_dir) -> None:
    from ..models.llama import _quantize_kv
    from ..ops.attention import _flash_kernel

    libs = _build("flash_attn", FLASH_VARIANTS, out_dir)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, kv, d, s, t = 1, 32, 8, 128, 1024, 8192
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    for case, pos0, lens, window in (("causal", 0, s, None), ("window", t - s, t, t // 2)):
        pos = torch.full((b,), pos0, device=dev, dtype=torch.int32)
        seq = torch.full((b,), lens, device=dev, dtype=torch.int32)
        for int8 in (False, True):
            args = (q, k8, v8, pos, seq, d**-0.5, window, ks, vs) if int8 else (q, k, v, pos, seq, d**-0.5, window)

            def run(name):
                with _library("flash_attn", libs[name]):
                    call = lambda: _flash_kernel(*args)
                    return _time([call]), call()

            _report(f"kernel C {'int8' if int8 else 'bf16'} KV {case}", FLASH_VARIANTS, run)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("layouts", "decode", "matmul", "int8_matmul", "matmul_exact", "flash"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    out_dir = _cuda.BUILD_DIR / "variants"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}", flush=True)
    if args.only in (None, "layouts"):
        layouts()
    if args.only in (None, "decode"):
        decode(out_dir)
    for source in ("matmul", "int8_matmul", "matmul_exact"):
        if args.only in (None, source):
            matmul(out_dir, source)
    if args.only in (None, "flash"):
        flash(out_dir)


if __name__ == "__main__":
    main()
