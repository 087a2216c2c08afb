"""Time what a kernel's time is made of, in one process on one card: the two
prefill layouts of kernels B and D at each prompt size, the prefill K split
policy against its parent's, and text-edited variants of a CUDA source
beside the source as it is.

    python -m nf4_tpu_torch.utils.kernel_variants [--only layouts|ksplit|decode|matmul|int8_matmul|matmul_exact|flash]

``--only ksplit`` times Llama-3-8B's prefills (full width and depth,
synthetic weights; one prompt of 1024, 64 and 16 tokens, and 4 of 512) and
kernels B's and D's prefill at 1024 rows (one layer's four projections)
under the K split of ``ops/matmul.py`` ``_prefill_ksplit`` (a function of
the weight) and under its parent's (sized from the call's row tiles, with
the decode kernel for calls of at most 16 rows), in turns: parent, new,
new, parent; each prefill the median of 5 host-clock runs ending in a
synchronize.

A variant is the source and its headers with a few lines replaced (a step
skipped, an intrinsic swapped); it is built with the port's nvcc flags into
a scratch directory under ``_build/``, and the port's own wrappers launch it
in place of the built source.  Variants that compute the same function report their
largest difference from the unedited build; variants that skip work report
nothing to compare.  Times are the mean device time of one launch, from the
replay of a CUDA graph of 20 launches after a warm-up, at the shapes
``chip_smoke.py`` times: kernels B and D at Llama-3-8B's four projections
(the layouts at 64 to 1024 rows; the variants of the decode kernel, with
kernel B's and with kernel D's decode, and of kernel E's decode kernel
with fp32 x, at 4 rows, padded to 16; the
variants of kernels B, D and E at w_gateup and w_down with 1024 rows),
kernel C at B=1, H=32, KV=8, D=128, S=1024 (causal from position 0,
and the last 1024 positions of an 8192-slot cache under a 4096-slot
window), bf16 and int8 KV, and its D = 256 variants at Gemma-7B's heads,
S=1024 causal, bf16 KV, B=1 and 2.
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

# The decode kernel (bm = 16, csrc/decode_mma.cuh) of kernel B: its block
# shape (warps side by side over columns x warps on the same columns over
# K) and ring depth (each changes the shared memory and registers of a
# block, so the occupancy and with it the K split), the products of zero
# batch rows 8-15 not skipped; and, not the same function, without the
# table lookup, without the copies or without reading the ring (its reads,
# decode and products: what each costs), and copying only the first 4 scale
# blocks of every column (the copies served from L2, not DRAM).
_WARPS = ("constexpr int WN = 1;        // warps side by side over a block's columns\n"
          "constexpr int WK = 4;        // warps on the same columns, each over its own scale blocks")
_B_STAGES = "  static constexpr int STAGES = 4;    // scale blocks in a lane's ring"
_D_STAGES = "  static constexpr int STAGES = 3;   // scale blocks in a warp's ring"


def _dk(wn, wk, stages):
    return [(_WARPS, _WARPS.replace("WN = 1", f"WN = {wn}").replace("WK = 4", f"WK = {wk}")),
            (_B_STAGES, _B_STAGES.replace("STAGES = 4", f"STAGES = {stages}"))]


_COPY = "hop::cp_async16(dst + r * 512, src + (size_t)r * m_pad, true);"
_NO_COPIES = [(f"      for (int r = 0; r < PIECES; ++r) {_COPY}", "      (void)src, (void)dst;")]
_NO_PRODUCTS = [("    for (int s = 0; s < 4; ++s) {\n      const typename Dec::Step",
                 "    for (int s = 0; s < 0; ++s) {\n      const typename Dec::Step")]
_FROM_L2 = [("const uint8_t* src = pk + (size_t)kb * (4 * PIECES) * m_pad;",
             "const uint8_t* src = pk + (size_t)(kb % 4) * (4 * PIECES) * m_pad;")]
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
    ("no products, copies of the first 4 scale blocks only", _NO_PRODUCTS + _FROM_L2, False),
    ("neither copies nor products", _NO_COPIES + _NO_PRODUCTS, False),
]

# The same decode kernel with kernel D's Dec (Int8Decode): its ring filled
# by each lane's cp.async (not the warp's bulk copies), its ring depth (2
# stages: 3 blocks per SM if the registers allow; 4 stages: 1 block), the
# order of copy and wait, 8 warps on one column tile, its decode through
# fp32 products rounded by one convert (the prefill kernel's decode; the same
# bits), and the cuts of kernel B's list (no copies: neither the bulk
# copies nor the waits for them).
_D_BULK = "  static constexpr bool BULK = true;  // the warp's rows by bulk copies, 144-byte rows in a slot"
_BULK_NO_COPIES = [
    ("        if (lane == 0) hop::mbar_arrive_expect_tx(bar, 4 * PIECES * WCOLS);\n", ""),
    ("hop::bulk_copy(dst + row_off<Dec>(k), src + (size_t)k * m_pad, WCOLS, bar);", "(void)src, (void)dst, (void)bar;"),
    ("hop::mbar_wait(bars + (i % STAGES) * 8, (i / STAGES) & 1);  // the warp's rows of step i", "{}"),
]
_PER_LANE = [(_D_BULK, _D_BULK.replace("BULK = true", "BULK = false"))]
_D2 = [(_D_STAGES, _D_STAGES.replace("STAGES = 3", "STAGES = 2"))]
# Step i + 2's bulk copies issued before the wait for step i (one more
# stage in flight during the wait), not after it.
_EARLY = [
    ("    if constexpr (Dec::BULK) hop::mbar_wait(bars + (i % STAGES) * 8, (i / STAGES) & 1);",
     "    if constexpr (Dec::BULK) issue(i + STAGES - 1), hop::mbar_wait(bars + (i % STAGES) * 8, (i / STAGES) & 1);"),
    ("    issue(i + STAGES - 1);  // into the slot step i - 1 read\n", "    if constexpr (!Dec::BULK) issue(i + STAGES - 1);\n"),
]
INT8_DECODE_VARIANTS = [
    ("as is", [], True),
    ("per-lane cp.async (not bulk copies)", _PER_LANE, True),
    ("2 stages", _D2, True),
    ("4 stages", [(_D_STAGES, _D_STAGES.replace("STAGES = 3", "STAGES = 4"))], True),
    ("copies issued before the wait", _EARLY, True),
    ("1 x 8 warps, 2 stages", [(_WARPS, _WARPS.replace("WK = 4", "WK = 8"))] + _D2, True),
    ("fp32 products, one convert (not __hmul2)", [(
        "  uint32_t w = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);  // the exact bf16 pair\n"
        "  __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w), scale);",
        "  const float sf = __low2float(scale);\n"
        "  __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(a, sf), __fmul_rn(b, sf));")], True),
    ("no copies of the weights", _BULK_NO_COPIES, False),
    ("no products", _NO_PRODUCTS, False),
    ("no products, copies of the first 4 scale blocks only", _NO_PRODUCTS + _FROM_L2, False),
    ("neither copies nor products", _BULK_NO_COPIES + _NO_PRODUCTS, False),
    ("per-lane cp.async, no products", _PER_LANE + _NO_PRODUCTS, False),
]

# Kernel E's decode kernel (csrc/matmul_exact.cu, namespace ed; fp32 x): its
# ring filled by bulk copies of the warp's rows (kernel D's route), its
# weights split as the prefill's (hi and lo both rounded to nearest: within
# 2^-24 of the value, not 2^-21), 3 stages, registers capped for 3 blocks
# per SM, the two small products summed in a fragment of their own (two
# shorter chains of dependent products, 8 more registers); and, not the
# same function, without the copies of the weights and scales, without
# the decode and products (the copies alone), neither, and one product
# (x_hi . w_hi) in place of three (w_lo then unused).
_E_BULK = "constexpr bool BULK = false;  // each lane copies its own pieces (not the warp's rows by bulk copies)"
_E_NO_COPIES = [(
    "#pragma unroll\n        for (int r = 0; r < PIECES; ++r) hop::cp_async16(dst + r * 512 + 16 * lane, "
    "src + (size_t)r * m_pad, true);\n"
    "        hop::cp_async16(dst + SCALE_OFF + SC_LD * g + 16 * t, sc + (size_t)kb * m_pad, true);",
    "        (void)src, (void)dst;")]
_E_NO_PRODUCTS = [("      for (int w = 0; w < 4; ++w) {", "      for (int w = 0; w < 0; ++w) {")]
EXACT_DECODE_VARIANTS = [
    ("as is", [], True),
    ("bulk copies (kernel D's ring)", [(_E_BULK, _E_BULK.replace("BULK = false", "BULK = true"))], True),
    ("hi and lo rounded to nearest", [
        ("  hi = __float_as_uint(v) & 0xFFFFE000u;\n  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));",
         "  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;\n"
         "  lo = (__float_as_uint(__fsub_rn(v, __uint_as_float(hi))) + 0x1000u) & 0xFFFFE000u;")], True),
    ("3 stages", [("constexpr int STAGES = 4;   // scale blocks in a warp's ring",
                   "constexpr int STAGES = 3;   // scale blocks in a warp's ring")], True),
    ("3 blocks per SM (at most 168 registers)", [
        ("__global__ void __launch_bounds__(THREADS)\ndecode_kernel(const XT*",
         "__global__ void __launch_bounds__(THREADS, 3)\ndecode_kernel(const XT*")], True),
    ("small products in a fragment of their own", [
        ("void products(float (&f)[4], const uint32_t (&hi)[4]",
         "void products(float (&f)[4], float (&fs)[4], const uint32_t (&hi)[4]"),
        ("  if constexpr (XLO) hop::mma_tf32_1688(f, hi, xl[2 * s], xl[2 * s + 1]);\n  hop::mma_tf32_1688(f, lo,",
         "  if constexpr (XLO) hop::mma_tf32_1688(fs, hi, xl[2 * s], xl[2 * s + 1]);\n  hop::mma_tf32_1688(fs, lo,"),
        ("products<XLO>(f[0], hi,", "products<XLO>(f[0], fs[0], hi,"),
        ("products<XLO>(f[1], hi,", "products<XLO>(f[1], fs[1], hi,"),
        ("          float f[2][4] = {};", "          float f[2][4] = {}, fs[2][4] = {};"),
        ("acc[mt][0][k] += f[0][k];", "acc[mt][0][k] += fs[0][k] + f[0][k];"),
        ("acc[mt][1][k] += f[1][k];", "acc[mt][1][k] += fs[1][k] + f[1][k];")], True),
    ("no copies of the weights and scales", _E_NO_COPIES, False),
    ("no decode or products (the copies alone)", _E_NO_PRODUCTS, False),
    ("neither copies nor products", _E_NO_COPIES + _E_NO_PRODUCTS, False),
    ("one product (x_hi . w_hi), not three", [
        ("  if constexpr (XLO) hop::mma_tf32_1688(f, hi, xl[2 * s], xl[2 * s + 1]);\n"
         "  hop::mma_tf32_1688(f, lo, xh[2 * s], xh[2 * s + 1]);\n", "")], False),
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
    ("Q.K^T's column loop unrolled by 2", [("#pragma unroll(KD > 128 ? 2 : KD / 16)", "#pragma unroll 2")], True),
]

# Kernel C at D = 256 (Gemma-7B's heads), bf16 KV: its key tiles, query
# tiles per block and the unrolling of Q.K^T's column loop (registers,
# spills).
# Tiles of another size change where the online softmax rescales, so
# they are not the same function to the last bit.
FLASH_D256_VARIANTS = [
    ("as is", [], True),
    ("two query tiles per block", [("constexpr int QT = INT8 ? 2 : 1;", "constexpr int QT = 2;")], True),
    ("64-slot key tiles", [("constexpr int BC = D >= 256 ? 32 : 64;", "constexpr int BC = 64;")], False),
    ("16-slot key tiles", [("constexpr int BC = D >= 256 ? 32 : 64;", "constexpr int BC = D >= 256 ? 16 : 64;")],
     False),
    ("Q.K^T's column loop unrolled fully", [("#pragma unroll(KD > 128 ? 2 : KD / 16)", "#pragma unroll")], True),
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


def _build(source: str, variants, out_dir, logs=None, tag=""):
    """Build every variant of ``csrc/<source>.cu``, each in its own
    directory with its headers (named by ``source``, ``tag`` and its index:
    a library once loaded stays loaded under its path); returns {name:
    CDLL}.  ``logs``, a dict, gets each variant's compiler output (ptxas's
    registers and spills)."""
    import ctypes

    procs = {}
    for i, (name, edits, _) in enumerate(variants):
        vdir = out_dir / f"{source}{tag}_{i}"
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


@contextlib.contextmanager
def _parent_ksplit():
    """Kernels B's and D's prefill K split as it was before it depended on
    the weight alone: sized from the call's row tiles (``_wave_ksplit`` of
    the layout's tiles), and every call of at most 16 rows on the decode
    kernel, prompt rows too."""
    from ..ops import int8_serve as i8
    from ..ops import matmul as mm
    from ..ops.lut_eval import byte_word_table

    saved = mm._pick_bm, i8._pick_bm, mm._matmul_bf16_kernel, i8._int8_matmul_kernel

    def split(x_pad, m_pad, rows):
        return mm._wave_ksplit(-(-x_pad.shape[0] // rows) * (m_pad // mm._PREFILL_COLS[rows]),
                               x_pad.shape[1] // 64, x_pad.device)

    def b_kernel(x_pad, packed, scales, out_dtype, quant_type="nf4", rows=None):
        if x_pad.shape[0] <= 16:
            return saved[2](x_pad, packed, scales, out_dtype, quant_type)
        rows = rows or mm._prefill_rows(x_pad.shape[0], packed.shape[1])
        table = byte_word_table(quant_type, x_pad.device)
        return mm._launch(mm._KERNEL, x_pad, packed, scales, out_dtype, rows, table.data_ptr(), None,
                          ksplit=split(x_pad, packed.shape[1], rows))

    def d_kernel(x_pad, values, scales, out_dtype, rows=None):
        if x_pad.shape[0] <= 16:
            return saved[3](x_pad, values, scales, out_dtype)
        rows = rows or mm._prefill_rows(x_pad.shape[0], values.shape[1])
        return i8._launch_d(x_pad, values, scales, out_dtype, rows, None, split(x_pad, values.shape[1], rows))

    pick = lambda b, prefill=False: saved[0](b)  # noqa: E731
    mm._pick_bm, i8._pick_bm, mm._matmul_bf16_kernel, i8._int8_matmul_kernel = pick, pick, b_kernel, d_kernel
    try:
        yield
    finally:
        mm._pick_bm, i8._pick_bm, mm._matmul_bf16_kernel, i8._int8_matmul_kernel = saved


def ksplit() -> None:
    """The prefill K split policy against its parent's, in turns."""
    import dataclasses
    import time

    import numpy as np

    from ..models import configs
    from ..models.llama import init_kv_cache
    from ..models.synthetic import synthetic_params
    from ..ops import int8_serve as i8
    from ..ops import matmul as mm
    from ..serve.engine import Engine

    dev = torch.device("cuda")
    policies = {"parent": _parent_ksplit, "new": contextlib.nullcontext}
    order = ("parent", "new", "new", "parent")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, int8 in (("B", False), ("D", True)):
        ws = _weights(gen, dev, int8)
        xs = {p: torch.randn((1024, n), generator=gen, device=dev).to(torch.bfloat16) for p, (_, n, _) in _PROJ.items()}
        times = {k: [] for k in policies}
        for name in order:
            with policies[name]():
                kern = i8._int8_matmul_kernel if int8 else mm._matmul_bf16_kernel
                times[name].append(sum(_time([lambda x=xs[p], w=w, s=s, od=od: kern(x, w, s, od) for w, s in ws[p]])
                                       for p, (_, _, od) in _PROJ.items()))
        print(f"kernel {label} prefill, four projections, B=1024: "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()), flush=True)
        del ws

    cfg = dataclasses.replace(configs.LLAMA3_8B, max_seq_len=2048)
    params = synthetic_params(cfg, seed=0)
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, cuda_graphs=False)
    cache = init_kv_cache(cfg, 4)
    rng = np.random.default_rng(0)
    for g, bucket in ((1, 1024), (1, 64), (1, 16), (4, 512)):
        toks = rng.integers(0, cfg.vocab_size, (g, bucket)).astype(np.int32)
        lens, slots = np.full(g, bucket, np.int32), np.arange(g)
        times = {k: [] for k in policies}
        for name in order:
            with policies[name]():
                runs = []
                for _ in range(6):  # a warm-up, then 5
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.prefill_group(cache, toks, lens, slots)
                    torch.cuda.synchronize()
                    runs.append((time.perf_counter() - t0) * 1e3)
                times[name].append(float(np.median(runs[1:])))
        print(f"Llama-3-8B prefill, {g} x {bucket} tokens (median of 5, ms): "
              + "; ".join(f"{k} {', '.join(f'{t:.2f}' for t in v)}" for k, v in times.items()), flush=True)


def decode(out_dir) -> None:
    """The variants of the decode kernel with kernel B's and kernel D's Dec,
    and of kernel E's decode kernel (fp32 x): one layer's four projections
    at 4 rows (b_pad 16), each variant with the K split its own occupancy
    gives."""
    from ..ops.int8_serve import _D_DECODE, _int8_matmul_kernel
    from ..ops.matmul import (
        _B_DECODE, _E_DECODE, _decode_ksplit, _decode_shape, _matmul_bf16_kernel, _matmul_exact_kernel,
    )

    dev = torch.device("cuda")
    for label, source, variants, kern, query, int8, xdt in (
        ("B", "matmul", DECODE_VARIANTS, _matmul_bf16_kernel, _B_DECODE, False, torch.bfloat16),
        ("D", "int8_matmul", INT8_DECODE_VARIANTS, _int8_matmul_kernel, _D_DECODE, True, torch.bfloat16),
        ("E", "matmul_exact", EXACT_DECODE_VARIANTS, _matmul_exact_kernel, _E_DECODE, False, torch.float32),
    ):
        logs = {}
        libs = _build(source, variants, out_dir, logs, tag="_decode")
        for name, err in logs.items():  # each decode kernel's entry is followed by its register count
            lines = err.splitlines()
            found = []
            for at, line in enumerate(lines):
                if "decode_kernel" in line and "Compiling" in line:
                    kind = "fp16 x" if "__half" in line else "fp32 x" if "decode_kernelIfE" in line else "decode kernel"
                    used = [u.split(":", 1)[-1].strip() for u in lines[at + 1:at + 4]
                            if "registers" in u or "spill" in u]
                    found.append(f"{kind}: {'; '.join(used)}")
            print(f"  kernel {label} {name}: ptxas {' | '.join(found) or 'no decode kernel found'}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        ws = _weights(gen, dev, int8)
        x = {}
        for proj, (_, n, _) in _PROJ.items():
            x[proj] = torch.zeros((16, n), device=dev, dtype=xdt)
            x[proj][:4] = torch.randn((4, n), generator=gen, device=dev).to(xdt)

        def run(name, source=source, libs=libs, kern=kern, query=query, label=label, ws=ws, x=x):
            with _library(source, libs[name]):
                times, outs, splits = [], [], []
                for proj, (m, n, od) in _PROJ.items():
                    calls = [lambda w=w, s=s, od=od, proj=proj: kern(x[proj], w, s, od) for w, s in ws[proj]]
                    times.append(_time(calls))
                    outs.append(calls[0]().float().ravel())
                    splits.append(_decode_ksplit(16, m, n // 64, dev, query))
                cols, blocks = _decode_shape(dev, query)
                print(f"  kernel {label} {name}: blocks of {cols} columns, {blocks} per SM, K splits {splits}, ms "
                      + ", ".join(f"{p} {t:.4f}" for p, t in zip(_PROJ, times)), flush=True)
                return sum(times), torch.cat(outs)

        _report(f"kernel {label} decode, four projections, B=4", variants, run)
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

    # Gemma-7B's heads (H = KV = 16, D = 256), bf16 KV, causal from 0: one
    # sequence (256 blocks for the card's 132 SMs), and two, per sequence.
    libs = _build("flash_attn", FLASH_D256_VARIANTS, out_dir, tag="_d256")
    h, kv, d = 16, 16, 256
    for b in (1, 2):
        q = torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((b, kv, s, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, kv, s, d), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.zeros((b,), device=dev, dtype=torch.int32)
        seq = torch.full((b,), s, device=dev, dtype=torch.int32)

        def run(name):
            with _library("flash_attn", libs[name]):
                call = lambda: _flash_kernel(q, k, v, pos, seq, d**-0.5)
                return _time([call]) / b, call()

        _report(f"kernel C bf16 KV D=256 H=16 causal, per sequence of B={b}", FLASH_D256_VARIANTS, run)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("layouts", "ksplit", "decode", "matmul", "int8_matmul", "matmul_exact",
                                       "flash"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    out_dir = _cuda.BUILD_DIR / "variants"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}", flush=True)
    if args.only in (None, "layouts"):
        layouts()
    if args.only in (None, "ksplit"):
        ksplit()
    if args.only in (None, "decode"):
        decode(out_dir)
    for source in ("matmul", "int8_matmul", "matmul_exact"):
        if args.only in (None, source):
            matmul(out_dir, source)
    if args.only in (None, "flash"):
        flash(out_dir)


if __name__ == "__main__":
    main()
