#!/usr/bin/env python3
"""Drive the PyTorch port (``nf4_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which fails the run on any error:

1. the card's name and power limit; build the CUDA kernels from
   ``nf4_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. kernels A (exact dequant) and F (fast bf16 dequant) against their plain
   versions at the Llama-3-8B shapes, bit for bit, NF4 and FP4 (A also
   bf16 and fp16 out);
3. kernels B (fused 4-bit matmul) and D (int8 matmul) against their plain
   versions at the four projection shapes, decode B=4 and prefill B=1024,
   and at decode B=1, 8 and 16 and the serving run's ragged B=37, 300 and
   700, max rel err < 2e-2;
   (3e) kernel E (the fp32/fp16-activation matmul) at the same shapes and
   ragged rows, fp32 x (fp32 out) and fp16 x (fp16 and fp32 out), max abs
   err <= 1e-5 * max|want| for fp32 out, 2e-3 * max|want| for fp16; at B=4
   and 1024 also the largest error of kernel E and of cuBLAS's fp32 product
   against a float64 product, E's at most 4x cuBLAS's;
4. kernel C (prefill flash attention), bf16 and int8 KV, against its plain
   version at B=1, H=32, KV=8, D=128, S=1024, T=8192, with and without a
   window, and at a ragged S=700 from position 0 and from 37; the int8
   branch also against the bf16 branch on the dequantized cache;
5. the main paths, each with every launch count set to 0 just before and
   read just after: (a) the dequant API on Llama-3-8B-shaped weights, exact
   and fast; (b) greedy serving of Llama-3-8B at full width and depth
   (synthetic packed weights from a seed) answering 6 requests of 32 new
   tokens, one prompt of 1024 tokens; (c) a small model on the card against
   the same model on the CPU; (d) the same serving in the int8 mode:
   weights recoded to int8 and an int8 KV cache; (e) a packed checkpoint
   saved by the port, loaded on the card with an int8 KV cache and recoded,
   against the same checkpoint served on the CPU.  With ``--profile``,
   phases 5b and 5d also print a ``torch.profiler`` breakdown of a decode
   chunk and a 1024-token prefill: wall time, the device's busy share and
   the device kernels by time;
6. QLoRA fine-tuning: (a) the ``nf4_matmul`` backward at w_gateup, g
   [1024, 28672], against the plain fp32 product within 1e-5 * max, also
   under ``torch.set_float32_matmul_precision("high")``; (b, c) 3 AdamW
   steps (lr 1e-4, weight decay 1e-4, ``remat=True``) of rank-16 adapters
   on all four targets of Llama-3-8B at full width and depth (synthetic
   packed weights), on one ``pack_sft`` batch of 2 x 512 slots, in bf16
   (kernels B and A) and in fp32 (kernels E and A), each step's launches
   counted from 0, the step-0 loss held against ``lm_loss`` through the
   inference forward (one prefill per example); with ``--profile`` a
   ``torch.profiler`` breakdown of one step; (d) a small model's train
   step on the card against the CPU (loss, adapter gradients, adapters
   after one SGD step); (e) a run saved with ``save_train_state`` and
   resumed against the uninterrupted run.

Kernel and library times are device times: many calls captured in one
CUDA graph, replayed, and timed with CUDA events (an eager loop of small
calls would time the host's launch rate instead).  Plain versions are
timed eagerly with CUDA events.  Inputs rotate through copies larger than
the 50 MB L2 cache where one call's inputs fit in it.  ``bound_ms`` is the larger of bytes / 3.35 TB/s and operations /
peak rate (989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32), the H100 SXM data
sheet's figures (kernel E's prefill branch: 3 x the fp32 operations at 495
TFLOP/s tf32, its 3xTF32 work; ``ffma_bound_ms`` beside it is the fp32
figure).  The line before the last holds the card's name and power
limit; the last line is the JSON result.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import types

PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12
L2_BYTES = 50 * 2**20


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(calls, iters=None, graph=True):
    """Mean ms of one call, cycling through ``calls`` (closures over input
    copies, so a weight is not served from L2 by the previous launch).
    ``graph``: capture the ``iters`` calls in one CUDA graph and time its
    replay (device time); else time an eager loop."""
    import torch

    for c in calls:  # warm up: builds, caches, allocator pools
        c()
    if iters is None:
        iters = max(10, len(calls))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                calls[i % len(calls)]()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for i in range(iters):
            calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    """Input copies whose total is at least twice the L2 cache."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound_ms(nbytes, flops, peak):
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / peak)


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def profile_breakdown(label: str, fn, rows: int = 15) -> None:
    """Run ``fn`` once under ``torch.profiler`` and print the wall time, the
    device's busy share of it and the device kernels and copies by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # CPU ops also carry the device time of the kernels they launched; keep
    # only what ran on the card, so nothing counts twice.
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    print(f"profile {label}: wall {wall * 1e3:.2f} ms under the profiler; device busy {busy * 1e3:.2f} ms "
          f"= {busy / wall:.1%}; device kernels and copies by time:")
    for e in sorted(events, key=_device_us, reverse=True)[:rows]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


def random_packed(gen, m, n, dev, quant_type="nf4"):
    import torch

    from nf4_tpu_torch.nf4.format import PackedNF4, pad_to

    m_pad, n_pad = pad_to(m, 128), pad_to(n, 1024)
    return PackedNF4(
        packed=torch.randint(0, 256, (n_pad // 2, m_pad), generator=gen, device=dev, dtype=torch.uint8),
        scales=torch.empty((n_pad // 64, m_pad), device=dev).uniform_(0.001, 0.02, generator=gen),
        shape=(m, n), padded_shape=(m_pad, n_pad), dtype=torch.bfloat16, quant_type=quant_type,
    )


def random_int8(gen, m, n, dev):
    from nf4_tpu_torch.ops.int8_serve import recode_int8_weight

    return recode_int8_weight(random_packed(gen, m, n, dev))


LLAMA3_8B_PROJ = {  # name: (out m, in n, output dtype name)
    "wqkv": (6144, 4096, "bf16"),
    "wo": (4096, 4096, "fp32"),
    "w_gateup": (28672, 4096, "bf16"),
    "w_down": (4096, 14336, "fp32"),
}


def phase_dequant(gen, dev, fast=False):
    """Kernel A (exact dequant, bf16 and fp16 out) or, with ``fast``, kernel
    F (byte-table bf16 dequant) against its plain version, bit for bit."""
    import torch

    from nf4_tpu_torch.ops.dequant import (
        _bf16_weight_t, _dequant_t_fast_kernel, _dequant_t_kernel, _dequant_t_plain,
    )

    if fast:
        label, dts = "kernel F", (torch.bfloat16,)
        kern = lambda w, dt=None, qt="nf4": _dequant_t_fast_kernel(w.packed, w.scales, qt)
        plain = lambda w, dt=None, qt="nf4": _bf16_weight_t(w.packed, w.scales, qt)
    else:
        label, dts = "kernel A", (torch.bfloat16, torch.float16)
        kern = lambda w, dt=torch.bfloat16, qt="nf4": _dequant_t_kernel(w.packed, w.scales, dt, qt)
        plain = lambda w, dt=torch.bfloat16, qt="nf4": _dequant_t_plain(w.packed, w.scales, dt, qt)
    res = {"max_abs_err": 0.0}
    for name in ("wqkv", "w_down"):
        m, n, _ = LLAMA3_8B_PROJ[name]
        for qt in ("nf4", "fp4"):
            pw = random_packed(gen, m, n, dev, qt)
            for dt in dts:
                got = kern(pw, dt, qt)
                want = plain(pw, dt, qt)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                      f"{label} differs from its plain version at {name} {qt} {dt}")
                err = (got.float() - want.float()).abs().max().item()
                res["max_abs_err"] = max(res["max_abs_err"], err)
        pw = random_packed(gen, m, n, dev)
        in_bytes = pw.packed.numel() + pw.scales.numel() * 4
        out_bytes = pw.packed.numel() * 2 * 2
        ws = [pw] + [random_packed(gen, m, n, dev) for _ in range(copies_for(in_bytes) - 1)]
        ms = time_ms([lambda w=w: kern(w) for w in ws])
        plain_ms = time_ms([lambda w=w: plain(w) for w in ws], iters=5, graph=False)
        bnd = bound_ms(in_bytes + out_bytes, pw.packed.numel() * 2, PEAK_FP32_S)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, gbs=(in_bytes + out_bytes) / ms / 1e6)
        print(f"phase 2 {label} {name} m={m} n={n} bf16: bit-exact; {ms:.4f} ms "
              f"({res[name]['gbs']:.0f} GB/s), plain {plain_ms:.4f} ms, bound {bnd:.4f} ms")
    return res


def phase_matmul(gen, dev, int8=False):
    """Kernel B (fused 4-bit matmul) or, with ``int8``, kernel D (int8
    matmul on the same weights recoded) against its plain version."""
    import torch

    from nf4_tpu_torch.nf4.format import pad_to
    from nf4_tpu_torch.ops.int8_serve import _int8_matmul_kernel, _int8_matmul_plain, _int8_weight_t
    from nf4_tpu_torch.ops.matmul import _bf16_weight_t, _matmul_bf16_kernel, _matmul_bf16_plain, _pick_bm

    if int8:
        label, make = "kernel D", random_int8
        kern = lambda x, w, od: _int8_matmul_kernel(x, w.values, w.scales, od)
        plain = lambda x, w, od: _int8_matmul_plain(x, w.values, w.scales, od)
        weight_t = lambda w: _int8_weight_t(w.values, w.scales)
    else:
        label, make = "kernel B", random_packed
        kern = lambda x, w, od: _matmul_bf16_kernel(x, w.packed, w.scales, od)
        plain = lambda x, w, od: _matmul_bf16_plain(x, w.packed, w.scales, od)
        weight_t = lambda w: _bf16_weight_t(w.packed, w.scales, "nf4")
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    res = {}
    # Checked only: decode rows 1, 8 and 16 (b_pad 16) and the serving run's
    # ragged prompt rows, b_pad 64 (the 128 x 256 blocks), 320 and 704 (256 x
    # 128 blocks, the last one partly filled).
    for b in (1, 8, 16, 37, 300, 700):
        for name, (m, n, od) in LLAMA3_8B_PROJ.items():
            pw = make(gen, m, n, dev)
            x = torch.zeros((pad_to(b, _pick_bm(b)), n), device=dev, dtype=torch.bfloat16)
            x[:b] = torch.randn((b, n), generator=gen, device=dev).to(torch.bfloat16)
            got = kern(x, pw, dts[od]).float()
            want = plain(x, pw, dts[od]).float()
            torch.cuda.synchronize()
            rel = (got - want).abs().max().item() / want.abs().max().item()
            check(rel < 2e-2, f"{label} max rel err {rel:.3g} at {name} B={b}")
            print(f"phase 3 {label} {name} B={b} (b_pad {x.shape[0]}) m={m} n={n} out={od}: rel err {rel:.2e}")
    for b in (4, 1024):
        b_pad = 16 if b <= 16 else b
        for name, (m, n, od) in LLAMA3_8B_PROJ.items():
            pw = make(gen, m, n, dev)
            x = torch.zeros((b_pad, n), device=dev, dtype=torch.bfloat16)
            x[:b] = torch.randn((b, n), generator=gen, device=dev).to(torch.bfloat16)
            got = kern(x, pw, dts[od]).float()
            want = plain(x, pw, dts[od]).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            check(rel < 2e-2, f"{label} max rel err {rel:.3g} at {name} B={b}")
            ws = [pw] + [make(gen, m, n, dev) for _ in range(copies_for(pw.nbytes) - 1)]
            ms = time_ms([lambda w=w: kern(x, w, dts[od]) for w in ws])
            plain_ms = time_ms([lambda w=w: plain(x, w, dts[od]) for w in ws], iters=3, graph=False)
            # Yardstick only (the port never calls it): torch.matmul on the
            # weight dequantized to bf16 ahead of time.
            wts = [weight_t(w) for w in ws[:max(1, copies_for(2 * m * n))]]
            lib = time_ms([lambda wt=wt: torch.matmul(x, wt) for wt in wts])
            del wts
            io = x.numel() * 2 + b_pad * pw.padded_shape[0] * (2 if od == "bf16" else 4)
            bnd = bound_ms(pw.nbytes + io, 2 * b_pad * pw.padded_shape[1] * pw.padded_shape[0], PEAK_BF16_S)
            res[(name, b)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd, max_abs_err=err, rel=rel)
            print(f"phase 3 {label} {name} B={b} m={m} n={n} out={od}: rel err {rel:.2e}; {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, torch.matmul on bf16 weight {lib:.4f} ms, bound {bnd:.4f} ms")
    if not int8:
        from nf4_tpu_torch.ops.matmul import _decode_ksplit, _decode_shape

        splits = {name: _decode_ksplit(16, m, n // 64, dev) for name, (m, n, _) in LLAMA3_8B_PROJ.items()}
        cols, blocks = _decode_shape(dev)
        print(f"phase 3 {label} decode: blocks of {cols} columns, {blocks} per SM, K splits {splits}")
    return res


# Phase 4's attention: B, H, KV, D, S (queries), T (cache slots); the
# window case reads the last S positions of a full cache under a T/2 window.
FLASH_SHAPE = (1, 32, 8, 128, 1024, 8192)


def phase_flash(gen, dev, int8=False):
    """Kernel C against its plain version; ``int8``: the int8-KV branch on
    the cache quantized as the model quantizes it (per-slot absmax)."""
    import torch
    import torch.nn.functional as F

    from nf4_tpu_torch.models.llama import _quantize_kv
    from nf4_tpu_torch.ops.attention import _flash_kernel, _flash_plain

    b, h, kv, d, s, t = FLASH_SHAPE
    g = h // kv
    label = "kernel C int8 KV" if int8 else "kernel C"
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
    if int8:
        (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
        cache = (k8, v8, ks, vs)
        # The same cache dequantized to bf16: the bf16 branch's input and SDPA's.
        k = (k8.float() * (ks / 127)[..., None]).to(torch.bfloat16)
        v = (v8.float() * (vs / 127)[..., None]).to(torch.bfloat16)
        slot_bytes = d + 4  # int8 values and one fp32 scale per slot and head
    else:
        cache = (k, v)
        slot_bytes = 2 * d

    def kern(pos, seq, window, kvs=cache, q=q):
        return _flash_kernel(q, kvs[0], kvs[1], pos, seq, d**-0.5, window, *kvs[2:])

    def plain(pos, seq, window, q=q):
        return _flash_plain(q, cache[0], cache[1], pos, seq, d**-0.5, window, *cache[2:])

    # A ragged prefill: S = 700 queries (not a multiple of a query or key
    # tile) at position 0 and at position 37, checked only.
    q700 = q[:, :, :700].contiguous()
    for pos0 in (0, 37):
        pos = torch.full((b,), pos0, device=dev, dtype=torch.int32)
        seq = torch.full((b,), pos0 + 700, device=dev, dtype=torch.int32)
        got = kern(pos, seq, None, q=q700).float()
        want = plain(pos, seq, None, q=q700).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        limit = 2e-2 * want.abs().max().item()
        check(err <= limit and torch.allclose(got, want, rtol=2e-2, atol=2e-2),
              f"{label} differs from plain (S=700, pos0={pos0}): max abs err {err}, limit {limit}")
        print(f"phase 4 {label} ragged S=700 pos0={pos0} seq_len={pos0 + 700}: max abs err {err:.2e} "
              f"(limit {limit:.2e})")

    k_rep, v_rep = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    res = {}
    # (a) a fresh 1024-token prompt at positions 0..1023 (the serving
    # prefill); (b) the last 1024 positions of a full 8192 cache under a
    # 4096-slot window.
    for case, pos0, lens, window in (("causal", 0, s, None), ("window", t - s, t, t // 2)):
        pos = torch.full((b,), pos0, device=dev, dtype=torch.int32)
        seq = torch.full((b,), lens, device=dev, dtype=torch.int32)
        got = kern(pos, seq, window).float()
        want = plain(pos, seq, window).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # Under the window each output averages ~1500 values of v, so |out|
        # is ~0.02 there: the limit also scales with the reference's size.
        limit = 2e-2 * want.abs().max().item()
        check(err <= limit and torch.allclose(got, want, rtol=2e-2, atol=2e-2),
              f"{label} differs from plain ({case}): max abs err {err}, limit {limit}")
        if window is not None:
            # The check is sharp enough to see a window off by one key tile.
            for w in (window - 64, window + 64):
                off = (plain(pos, seq, w).float() - got).abs().max().item()
                check(off > limit, f"a window of {w} passes the check of window {window}: {off} <= {limit}")
                print(f"phase 4 {label} against a plain window of {w}: max abs diff {off:.2e} "
                      f"> limit {limit:.2e} (fails, as it must)")
        if int8:
            # The bf16 branch on the dequantized cache computes nearly the
            # same function: K and V round to bf16 first.
            ref = kern(pos, seq, window, (k, v)).float()
            torch.cuda.synchronize()
            off = (ref - got).abs().max().item()
            check(off <= limit, f"{label} against the bf16 kernel on the dequantized cache: {off} > {limit}")
            print(f"phase 4 {label} {case} against kernel C bf16 on the dequantized cache: max abs diff "
                  f"{off:.2e} (limit {limit:.2e})")
        ms = time_ms([lambda: kern(pos, seq, window)])
        plain_ms = time_ms([lambda: plain(pos, seq, window)], iters=3, graph=False)
        qpos = pos0 + torch.arange(s, device=dev)[:, None]
        tk = torch.arange(t, device=dev)[None, :]
        vis = (tk <= qpos) & (tk < lens)
        if window is not None:
            vis &= tk > qpos - window
        if case == "causal":  # the same function over the live slots
            kl, vl = k_rep[:, :, :s], v_rep[:, :, :s]
            lib = time_ms([lambda: F.scaled_dot_product_attention(q, kl, vl, is_causal=True)])
        else:
            lib = time_ms([lambda: F.scaled_dot_product_attention(q, k_rep, v_rep, attn_mask=vis)])
        pairs = int(vis.sum().item()) * h  # visible (query, key) pairs over all heads
        keys = int(vis.any(dim=0).sum().item())  # key slots any query reads
        nbytes = 2 * q.numel() * 2 + 2 * b * kv * keys * slot_bytes
        bnd = bound_ms(nbytes, 4 * pairs * d, PEAK_BF16_S)
        res[case] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd, max_abs_err=err,
                         tflops=4 * pairs * d / ms / 1e9)
        print(f"phase 4 {label} {case} pos0={pos0} seq_len={lens} window={window}: max abs err {err:.2e} "
              f"(limit {limit:.2e}); "
              f"{ms:.4f} ms ({res[case]['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"SDPA{' on the dequantized cache' if int8 else ''} {lib:.4f} ms, bound {bnd:.4f} ms")
    return res


def phase_exact(gen, dev):
    """Kernel E (fused 4-bit matmul, fp32/fp16 activations, fp32 products)
    against its plain version, and at B=4 and 1024 kernel E and cuBLAS's
    fp32 product against a float64 product; timed with fp32 x and fp32 out
    (and fp16 x at B=1024)."""
    import torch

    from nf4_tpu_torch.nf4.format import pad_to
    from nf4_tpu_torch.ops.dequant import _dequant_t_plain
    from nf4_tpu_torch.ops.matmul import _matmul_exact_kernel, _matmul_exact_plain, _pick_bm

    limits = {torch.float32: 1e-5, torch.float16: 2e-3}
    cases = ((torch.float32, torch.float32), (torch.float16, torch.float16), (torch.float16, torch.float32))

    def check_close(x, pw, label):
        err = 0.0
        for xdt, od in cases:
            xc = x.to(xdt)
            got = _matmul_exact_kernel(xc, pw.packed, pw.scales, od).float()
            want = _matmul_exact_plain(xc, pw.packed, pw.scales, od).float()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            limit = limits[od] * want.abs().max().item()
            check(e <= limit, f"kernel E max abs err {e} > {limit} at {label} x {xdt} out {od}")
            if od == torch.float32:
                err = max(err, e)
        return err

    # The ragged rows of a prefill, checked only: b_pad 64, 320 and 704 (the
    # last 128-row tile partly filled).
    for b in (37, 300, 700):
        for name, (m, n, _) in LLAMA3_8B_PROJ.items():
            pw = random_packed(gen, m, n, dev)
            x = torch.zeros((pad_to(b, _pick_bm(b)), n), device=dev)
            x[:b] = torch.randn((b, n), generator=gen, device=dev)
            err = check_close(x, pw, f"{name} B={b}")
            print(f"phase 3e kernel E {name} B={b} (b_pad {x.shape[0]}) m={m} n={n}: fp32 max abs err {err:.2e} "
                  f"(fp16 x and out within 2e-3*max)")
    res = {}
    for b in (4, 1024):
        b_pad = 16 if b <= 16 else b
        for name, (m, n, _) in LLAMA3_8B_PROJ.items():
            pw = random_packed(gen, m, n, dev)
            x = torch.zeros((b_pad, n), device=dev)
            x[:b] = torch.randn((b, n), generator=gen, device=dev)
            err = check_close(x, pw, f"{name} B={b}")
            # Both fp32 products against float64 on the same fp32 weight.
            w32 = _dequant_t_plain(pw.packed, pw.scales, torch.float32)
            want64 = x.double() @ w32.double()
            got = _matmul_exact_kernel(x, pw.packed, pw.scales, torch.float32)
            prev = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
            cub = torch.matmul(x, w32)
            torch.set_float32_matmul_precision(prev)
            e64 = (got.double() - want64).abs().max().item()
            cub64 = (cub.double() - want64).abs().max().item()
            del w32, want64, got, cub
            check(e64 <= 4 * cub64, f"kernel E's float64 error {e64} > 4 x cuBLAS fp32's {cub64} at {name} B={b}")
            ws = [pw] + [random_packed(gen, m, n, dev) for _ in range(copies_for(pw.nbytes) - 1)]
            ms = time_ms([lambda w=w: _matmul_exact_kernel(x, w.packed, w.scales, torch.float32) for w in ws])
            fp16_ms = None
            if b > 16:
                xh = x.half()
                fp16_ms = time_ms([lambda w=w: _matmul_exact_kernel(xh, w.packed, w.scales, torch.float32)
                                   for w in ws])
            plain_ms = time_ms([lambda w=w: _matmul_exact_plain(x, w.packed, w.scales, torch.float32) for w in ws],
                               iters=3, graph=False)
            # Yardstick only (the port never calls it): torch.matmul on the
            # weight dequantized to fp32 ahead of time, TF32 off.
            torch.set_float32_matmul_precision("highest")
            wts = [_dequant_t_plain(w.packed, w.scales, torch.float32) for w in ws[:max(1, copies_for(4 * m * n))]]
            lib = time_ms([lambda wt=wt: torch.matmul(x, wt) for wt in wts])
            torch.set_float32_matmul_precision(prev)
            del wts
            # The work this call's data needs: its b rows (not the padding
            # rows the kernel also multiplies).  The prefill branch does it
            # as three tf32 products.
            io = b * n * 4 + b * m * 4
            ffma = bound_ms(pw.nbytes + io, 2 * b * n * m, PEAK_FP32_S)
            bnd = ffma if b <= 16 else bound_ms(pw.nbytes + io, 3 * 2 * b * n * m, PEAK_TF32_S)
            res[(name, b)] = dict(ms=ms, fp16_ms=fp16_ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd,
                                  ffma_bound_ms=ffma, max_abs_err=err, f64_err=e64, library_f64_err=cub64)
            print(f"phase 3e kernel E {name} B={b} m={m} n={n} fp32: max abs err {err:.2e} (fp16 x and out "
                  f"within 2e-3*max); against float64: kernel E {e64:.3e}, cuBLAS fp32 {cub64:.3e}; {ms:.4f} ms "
                  f"({2 * b * m * n / ms / 1e9:.1f} TFLOP/s)"
                  + (f", fp16 x {fp16_ms:.4f} ms" if fp16_ms else "")
                  + f", plain {plain_ms:.4f} ms, torch.matmul on fp32 weight {lib:.4f} ms, bound {bnd:.4f} ms "
                  f"(fp32 FFMA {ffma:.4f} ms)")
    return res


def bnb_module(rng, m, n):
    """A duck-typed bitsandbytes Linear4bit with random contents."""
    import numpy as np

    from nf4_tpu_torch.nf4.lut import dynamic_code

    nblocks = m * n // 64
    qs = types.SimpleNamespace(
        absmax=rng.integers(0, 256, nblocks, dtype=np.uint8),
        state2=types.SimpleNamespace(
            absmax=rng.uniform(0.01, 0.1, -(-nblocks // 256)).astype(np.float32),
            code=dynamic_code(),
        ),
        offset=0.02, dtype="torch.bfloat16", quant_type="nf4",
    )
    weight = types.SimpleNamespace(data=rng.integers(0, 256, m * n // 2, dtype=np.uint8), quant_state=qs)
    return types.SimpleNamespace(weight=weight, out_features=m, in_features=n)


def params_to(params, device):
    """A copy of the port's params on ``device``."""
    from nf4_tpu_torch.nf4.format import PackedNF4

    def mv(w):
        if isinstance(w, PackedNF4):
            return dataclasses.replace(w, packed=w.packed.to(device), scales=w.scales.to(device))
        return w.to(device)

    layers = [type(lp)(**{f.name: mv(getattr(lp, f.name)) for f in dataclasses.fields(lp)}) for lp in params.layers]
    return dataclasses.replace(params, embed=mv(params.embed), layers=layers,
                               final_norm=mv(params.final_norm), lm_head=mv(params.lm_head))


def phase_dequant_api(dev, rng):
    """Main path (a): the dequant API on a Llama-3-8B wqkv-shaped bnb module,
    exact (kernel A) and fast (kernel F), each against the CPU path."""
    import torch

    import nf4_tpu_torch
    from nf4_tpu_torch.nf4.adapters import quant_state_from_module
    from nf4_tpu_torch.ops import _cuda

    module = bnb_module(rng, 6144, 4096)
    _cuda.reset_launch_counts()
    w = nf4_tpu_torch.dequantize_nf4_module(module)
    torch.cuda.synchronize()
    dequant_counts = _cuda.launch_counts()
    check(w.shape == (6144, 4096) and w.dtype == torch.bfloat16 and w.is_cuda, "dequant API output")
    ref = nf4_tpu_torch.dequantize_nf4_module(module, device="cpu")
    check(torch.equal(w.cpu().view(torch.int16), ref.view(torch.int16)), "dequant API differs from the CPU path")
    print(f"phase 5a dequant API (6144x4096 module): bit-exact vs the CPU path; launches {dequant_counts}")
    check(dequant_counts["dequant_t"] > 0, "the dequant API did not launch kernel A")

    state = quant_state_from_module(module)
    pw = nf4_tpu_torch.pack_for_tpu(state)
    _cuda.reset_launch_counts()
    wf = nf4_tpu_torch.dequantize_fast(pw)
    torch.cuda.synchronize()
    fast_counts = _cuda.launch_counts()
    check(wf.shape == (6144, 4096) and wf.dtype == torch.bfloat16 and wf.is_cuda, "dequantize_fast output")
    ref = nf4_tpu_torch.dequantize_fast(nf4_tpu_torch.pack_for_tpu(state, device="cpu"))
    check(torch.equal(wf.cpu().view(torch.int16), ref.view(torch.int16)), "dequantize_fast differs from the CPU path")
    print(f"phase 5a dequantize_fast (the same weight): bit-exact vs the CPU path; launches {fast_counts}")
    check(fast_counts["dequant_t_fast"] > 0, "dequantize_fast did not launch kernel F")
    return dequant_counts, fast_counts


def serve_llama(label, params, cfg, prompts, weight_bytes, profile):
    """Greedy serving at batch 4: the requests with every launch count set
    to 0 just before and read just after, then the prefill of the
    1024-token prompt and decode steps at position 1024, timed alone."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import Engine

    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    check(len(results) == len(prompts), "every request answered")
    for r, p in zip(results, prompts):
        check(r.prompt == p and len(r.tokens) == 32, "32 new tokens per request")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens), "tokens in the vocabulary")
    print(f"phase {label} generate: {len(prompts)} requests x 32 tokens in {gen_s:.2f} s; launches {counts}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # Throughput of the engine's two steps, timed alone.
    cache = init_kv_cache(cfg, 4)
    toks = np.asarray([prompts[0]], np.int32)
    step = lambda: eng.prefill_group(cache, toks, np.asarray([1024], np.int32), np.asarray([0]))
    step()
    torch.cuda.synchronize()
    # The prefill is bound by the host's launches where its kernels are
    # fast, and a shared host's clock varies run to run: the median of 5.
    prefill_runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        logits = step()
        torch.cuda.synchronize()
        prefill_runs.append(time.perf_counter() - t0)
    prefill_s = sorted(prefill_runs)[2]
    check(bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab_size), "finite prefill logits")
    pos = np.full(4, 1024, np.int64)
    act = np.ones(4, bool)
    cur = np.zeros(4, np.int32)
    eng.decode_steps(cache, cur, pos, act, 8)
    t0 = time.perf_counter()
    for _ in range(3):
        eng.decode_steps(cache, cur, pos, act, 8)
    decode_s = (time.perf_counter() - t0) / 24
    bound = weight_bytes / PEAK_BYTES_S
    print(f"phase {label} prefill 1024 tokens: {prefill_s * 1e3:.1f} ms = {1024 / prefill_s:.0f} tokens/s "
          f"(median of {[round(t * 1e3, 1) for t in prefill_runs]} ms); "
          f"decode B=4 at position 1024: {decode_s * 1e3:.2f} ms/step = {4 / decode_s:.1f} tokens/s "
          f"(weight-stream bound {bound * 1e3:.2f} ms/step) on {card_line()}")
    if profile:
        profile_breakdown(f"{label} decode chunk of 8 steps, batch 4, position 1024",
                          lambda: eng.decode_steps(cache, cur, np.full(4, 1024, np.int64), act, 8))
        profile_breakdown(f"{label} prefill 1024 tokens", step)
    return counts, dict(generate_s=gen_s, prefill_tok_s=1024 / prefill_s, decode_ms_step=decode_s * 1e3,
                        decode_tok_s=4 / decode_s, weight_gb=weight_bytes / 1e9, kv_cache_gb=cache.nbytes / 1e9)


def projection_bytes(params) -> int:
    return sum(w.nbytes for lp in params.layers for w in (lp.wqkv, lp.wo, lp.w_gateup, lp.w_down))


def phase_serving(prompts, profile):
    """Main path (b): greedy serving of Llama-3-8B, full width and depth."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params

    cfg = configs.LLAMA3_8B
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=0)
    torch.cuda.synchronize()
    packed = projection_bytes(params)
    print(f"phase 5b Llama-3-8B synthetic params: {packed / 1e9:.3f} GB packed+scales, "
          f"built in {time.perf_counter() - t0:.1f} s")
    head = params.lm_head.numel() * params.lm_head.element_size()
    counts, serving = serve_llama("5b", params, cfg, prompts, packed + head, profile)
    check(counts["matmul_bf16"] > 0 and counts["flash_attention"] > 0,
          f"serving did not launch kernels B and C: {counts}")
    return counts, serving


def phase_int8_serving(prompts, profile):
    """Main path (d): the same serving with every projection recoded to int8
    (kernel D) and an int8 KV cache (kernel C's int8 branch)."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.llama import recode_params_int8
    from nf4_tpu_torch.models.synthetic import synthetic_params

    cfg = dataclasses.replace(configs.LLAMA3_8B, kv_quant=True)
    params = synthetic_params(cfg, seed=0)
    packed = projection_bytes(params)
    t0 = time.perf_counter()
    params = recode_params_int8(params)
    torch.cuda.synchronize()
    recode_s = time.perf_counter() - t0
    int8 = projection_bytes(params)
    # The KV cache of 4 slots at the full 8192 context: int8 values + fp32
    # scales, against the bf16 cache of phase 5b.
    slots = cfg.num_layers * 4 * cfg.num_kv_heads * cfg.max_seq_len
    kv8, kv16 = slots * 2 * (cfg.head_dim + 4), slots * 2 * cfg.head_dim * 2
    print(f"phase 5d Llama-3-8B int8 recode: {int8 / 1e9:.3f} GB int8+scales (from {packed / 1e9:.3f} GB packed) "
          f"in {recode_s:.2f} s; KV cache for 4 slots x {cfg.max_seq_len}: {kv8 / 1e9:.3f} GB int8 "
          f"(bf16: {kv16 / 1e9:.3f} GB)")
    head = params.lm_head.numel() * params.lm_head.element_size()
    counts, serving = serve_llama("5d", params, cfg, prompts, int8 + head, profile)
    check(counts["int8_matmul"] > 0 and counts["flash_attention_int8"] > 0,
          f"int8 serving did not launch kernel D and kernel C's int8 branch: {counts}")
    check(counts["matmul_bf16"] == 0 and counts["flash_attention"] == 0,
          f"int8 serving launched a 4-bit or bf16-KV kernel: {counts}")
    check(abs(serving["kv_cache_gb"] - kv8 / 1e9) < 1e-9, "KV cache size")
    return counts, dict(serving, recode_s=recode_s)


SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=256)


def phase_small_model(dev, rng):
    """Main path (c): a small model on the card against the same weights on
    the CPU."""
    import torch

    from nf4_tpu_torch.models.llama import LlamaConfig, prefill
    from nf4_tpu_torch.models.synthetic import synthetic_params

    small = LlamaConfig(**SMALL)
    p_gpu = synthetic_params(small, seed=1)
    p_cpu = params_to(p_gpu, "cpu")
    tk = torch.as_tensor(rng.integers(0, 512, (2, 100)), dtype=torch.int32)
    lg, _ = prefill(p_gpu, small, tk.to(dev))
    lc, _ = prefill(p_cpu, small, tk)
    diff = (lg.cpu() - lc).abs().max().item()
    scale = lc.abs().max().item()
    check(bool(torch.isfinite(lg).all()) and diff <= 2e-2 * scale, f"small model: card vs CPU {diff} at scale {scale}")
    print(f"phase 5c small model logits, card vs CPU plain path: max abs diff {diff:.2e} (max |logit| {scale:.2f})")


def phase_checkpoint(dev, rng):
    """Main path (e): a packed checkpoint written by the port (``.npz``),
    loaded on the card with an int8 KV cache and recoded to int8, against
    the same checkpoint served on the CPU."""
    import os
    import tempfile

    import torch

    from nf4_tpu_torch.models.llama import LlamaConfig, prefill, recode_params_int8
    from nf4_tpu_torch.models.loader import load_packed_auto, save_packed
    from nf4_tpu_torch.models.synthetic import synthetic_params

    small = LlamaConfig(**SMALL)
    p_src = params_to(synthetic_params(small, seed=2), "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small.npz")
        save_packed(path, p_src, small)
        p_gpu, cfg = load_packed_auto(path, kv_quant=True)
        p_cpu, cfg_cpu = load_packed_auto(path, device="cpu", kv_quant=True)
    check(cfg == cfg_cpu == dataclasses.replace(small, kv_quant=True), "checkpoint config")
    for a, b in ((p_gpu.layers[0].wqkv.packed, p_src.layers[0].wqkv.packed), (p_gpu.lm_head, p_src.lm_head)):
        check(a.is_cuda and torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8)), "checkpoint round trip")
    tk = torch.as_tensor(rng.integers(0, 512, (2, 100)), dtype=torch.int32)
    lg, cache = prefill(recode_params_int8(p_gpu), cfg, tk.to(dev))
    lc, _ = prefill(recode_params_int8(p_cpu), cfg_cpu, tk)
    diff = (lg.cpu() - lc).abs().max().item()
    scale = lc.abs().max().item()
    check(cache.k.dtype == torch.int8 and bool(torch.isfinite(lg).all()) and diff <= 2e-2 * scale,
          f"checkpoint model int8/kv8: card vs CPU {diff} at scale {scale}")
    print(f"phase 5e packed checkpoint (.npz) loaded with kv_quant=True and recoded to int8, card vs CPU: "
          f"max abs diff {diff:.2e} (max |logit| {scale:.2f})")


def phase_backward(gen, dev):
    """Main path (6a): the ``nf4_matmul`` gradient at w_gateup, g [1024,
    28672], against the plain fp32 product, under the default precision
    and under "high" (TF32 allowed for the caller's own products)."""
    import torch

    import nf4_tpu_torch
    from nf4_tpu_torch.ops.dequant import _dequant_t_plain

    m, n, _ = LLAMA3_8B_PROJ["w_gateup"]
    pw = random_packed(gen, m, n, dev)
    x = torch.randn((1024, n), generator=gen, device=dev).requires_grad_()
    g = torch.randn((1024, m), generator=gen, device=dev)
    want = g @ _dequant_t_plain(pw.packed, pw.scales, torch.float32).T
    limit = 1e-5 * want.abs().max().item()
    prev = torch.get_float32_matmul_precision()
    for precision in ("highest", "high"):
        torch.set_float32_matmul_precision(precision)
        try:
            (dx,) = torch.autograd.grad(nf4_tpu_torch.nf4_matmul(x, pw), x, g)
        finally:
            torch.set_float32_matmul_precision(prev)
        torch.cuda.synchronize()
        err = (dx - want).abs().max().item()
        check(err <= limit, f"backward under {precision!r}: max abs err {err} > {limit}")
        print(f"phase 6a nf4_matmul backward, w_gateup, g [1024, {m}], precision {precision!r}: max abs err "
              f"{err:.2e} (limit {limit:.2e})")


def sft_examples(rng, vocab, n_examples, lo, hi):
    """Seeded (prompt, completion) token-id pairs of random lengths."""
    out = []
    for _ in range(n_examples):
        n = int(rng.integers(lo, hi))
        n_p = int(rng.integers(max(1, n // 4), n // 2))
        toks = [int(t) for t in rng.integers(1, vocab, n)]
        out.append((toks[:n_p], toks[n_p:]))
    return out


def batch_to(batch, dev):
    import torch

    return [torch.as_tensor(a, device=dev) for a in (batch.tokens, batch.loss_mask, batch.positions,
                                                      batch.segment_ids)]


def reference_loss(params, cfg, examples):
    """``lm_loss`` of a packed batch computed through the inference
    ``prefill``, one example at a time (packing is exact, so each example's
    logits are its own row's): the masked mean NLL of every completion."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import prefill

    cfg = dataclasses.replace(cfg, max_seq_len=max(len(p) + len(c) for p, c in examples))
    total, count = 0.0, 0
    with torch.no_grad():
        for p, c in examples:
            toks = torch.as_tensor(np.asarray([p + c], np.int32), device=params.embed.device)
            logits, _ = prefill(params, cfg, toks)
            logp = torch.log_softmax(logits[0, len(p) - 1 : -1].float(), dim=-1)
            tgt = toks[0, len(p):].long()
            total += -logp.gather(-1, tgt[:, None]).sum().item()
            count += len(c)
    return total / count


TRAIN_EXPECT = {  # launches per step: one forward and its recompute, the backward's dequants
    "bf16": {"matmul_bf16": 256, "dequant_t": 127},
    "fp32": {"matmul_exact": 256, "dequant_t": 127},
}


def phase_training(label, kind, examples, profile):
    """Main paths (6b, 6c): 3 AdamW steps of QLoRA on Llama-3-8B, full
    width and depth, one packed batch of 2 x 512 slots."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.train import LoraConfig, init_lora, make_train_step, pack_sft

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[kind]
    cfg = dataclasses.replace(configs.LLAMA3_8B, dtype=dtype)
    params = synthetic_params(cfg, seed=0)
    check(params.embed.dtype == dtype and params.lm_head.dtype == dtype, "dense leaves follow cfg.dtype")
    batch = pack_sft(examples, 512)
    check(batch.tokens.shape == (2, 512), f"the batch packs into 2 x 512, got {batch.tokens.shape}")
    tok, mask, pos, seg = batch_to(batch, "cuda")
    lcfg = LoraConfig(rank=16, alpha=32.0)
    lora = init_lora(cfg, lcfg, seed=0)
    opt = torch.optim.AdamW(lora.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = make_train_step(cfg, opt, remat=True)
    ref = reference_loss(params, cfg, examples)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, counts = [], [], []
    for _ in range(3):
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(step(params, lora, tok, mask, pos, seg).item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(_cuda.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    want = {name: 0 for name in _cuda.KERNELS}
    want.update(TRAIN_EXPECT[kind])
    for c in counts:
        check(c == want, f"launches per step {c}, expected {want}")
    tol = 2e-2 if kind == "bf16" else 1e-3
    check(abs(losses[0] - ref) <= tol, f"step-0 loss {losses[0]} against the inference forward's {ref} (tol {tol})")
    step_s = sum(secs[1:]) / 2
    tokens = batch.tokens.size
    print(f"phase {label} QLoRA Llama-3-8B {kind}, rank 16, 2 x 512 packed ({len(examples)} examples, "
          f"{int(batch.loss_mask[:, 1:].sum())} targets): losses {losses}; step-0 loss against the inference "
          f"forward {ref:.6f} (|diff| {abs(losses[0] - ref):.2e}, tol {tol}); step times "
          f"{[round(v * 1e3, 1) for v in secs]} ms; {step_s * 1e3:.1f} ms/step = {tokens / step_s:.0f} training "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB; launches per step {counts[0]} on {card_line()}")
    if profile:
        profile_breakdown(f"{label} one {kind} training step",
                          lambda: step(params, lora, tok, mask, pos, seg).item(), rows=20)
    return dict(losses=losses, ref_loss=ref, step_ms=step_s * 1e3, tokens_s=tokens / step_s, peak_gb=peak / 1e9,
                launches_per_step=counts[0], launches={k: sum(c[k] for c in counts) for k in counts[0]})


def small_lora(cfg, dev, seed):
    """Rank-8 adapters with a seeded nonzero B (so A gets a gradient too)."""
    import numpy as np
    import torch

    from nf4_tpu_torch.train import LoraConfig, init_lora

    lora = init_lora(cfg, LoraConfig(rank=8, alpha=16.0), seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for ll in lora.layers:
            for ab in (ll.qkv, ll.o, ll.gateup, ll.down):
                ab.b.copy_(torch.as_tensor(rng.standard_normal(tuple(ab.b.shape)).astype(np.float32) * 0.02))
    return lora


def phase_train_small(rng, devices=("cuda", "cpu")):
    """Main path (6d): one fp32 training step of a small model on the card
    against the same step on the CPU (``devices``): the loss, the adapters'
    gradients, and the adapters after one SGD(1.0) step."""
    import torch

    from nf4_tpu_torch.models.llama import LlamaConfig
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.train import make_train_step, pack_sft

    small = LlamaConfig(**SMALL, dtype=torch.float32)
    params = synthetic_params(small, seed=3, device=devices[0])
    batch = pack_sft(sft_examples(rng, small.vocab_size, 6, 16, 60), 128)
    runs = []  # (loss, {name: (grad, adapter after the step)}, launches) per device
    for dev in devices:
        lora = small_lora(small, dev, seed=4)
        step = make_train_step(small, torch.optim.SGD(lora.parameters(), lr=1.0))
        _cuda.reset_launch_counts()
        loss = step(params_to(params, dev), lora, *batch_to(batch, dev)).item()
        runs.append((loss, {n: (p.grad.cpu(), p.detach().cpu()) for n, p in lora.named_parameters()},
                     _cuda.launch_counts()))
    (loss, got, counts), (want_loss, want, _) = runs
    if devices[0] == "cuda":
        check(counts["matmul_exact"] > 0 and counts["dequant_t"] > 0,
              f"the card's step did not launch kernels E and A: {counts}")
    check(abs(loss - want_loss) <= 1e-5 * abs(want_loss), f"small train step loss, card vs CPU: {loss} vs {want_loss}")
    g_err = p_err = 0.0
    for name, (g_ref, p_ref) in want.items():
        scale = g_ref.abs().max().item()
        g_err = max(g_err, (got[name][0] - g_ref).abs().max().item() / scale)
        p_err = max(p_err, (got[name][1] - p_ref).abs().max().item() / scale)
    check(g_err <= 1e-4 and p_err <= 1e-4, f"small train step grads/adapters, card vs CPU: {g_err}, {p_err}")
    print(f"phase 6d small model fp32 train step, card vs CPU plain path: loss {loss:.6f} vs {want_loss:.6f}; "
          f"max grad diff {g_err:.2e} and max adapter diff after SGD(1.0) {p_err:.2e} of each gradient's "
          f"largest value (limit 1e-4); card launches {counts}")


def phase_resume(rng, dev="cuda"):
    """Main path (6e): a run saved with ``save_train_state`` after 2 AdamW
    steps and resumed equals the uninterrupted run's third step."""
    import os
    import tempfile

    import torch

    from nf4_tpu_torch.models.llama import LlamaConfig
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.train import LoraConfig, load_train_state, make_train_step, pack_sft, save_train_state

    small = LlamaConfig(**SMALL, dtype=torch.float32)
    params = synthetic_params(small, seed=5, device=dev)
    data = batch_to(pack_sft(sft_examples(rng, small.vocab_size, 6, 16, 60), 128), dev)
    adamw = lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)  # noqa: E731
    lora = small_lora(small, dev, seed=6)
    opt = adamw(lora.parameters())
    step = make_train_step(small, opt)
    for _ in range(2):
        step(params, lora, *data)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.npz")
        save_train_state(path, lora, LoraConfig(rank=8, alpha=16.0), opt, step=2)
        want = step(params, lora, *data).item()
        lora2, _, opt2, at = load_train_state(path, adamw, device=dev)
    got = make_train_step(small, opt2)(params, lora2, *data).item()
    check(at == 2 and got == want, f"resumed step loss {got} (step {at}) != uninterrupted {want}")
    print(f"phase 6e save_train_state after 2 AdamW steps, resumed: step-3 loss {got!r} == uninterrupted {want!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown of a decode chunk and a prefill")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import nf4_tpu_torch  # noqa: F401  (fails outside the repository)
    from nf4_tpu_torch.ops import _cuda

    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _cuda.build()
    print(f"phase 1 built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if any(w in line for w in ("registers", "spill", "arning", "serialized")):
                print(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    deq = phase_dequant(gen, dev)
    fast = phase_dequant(gen, dev, fast=True)
    mm = phase_matmul(gen, dev)
    mm8 = phase_matmul(gen, dev, int8=True)
    ex = phase_exact(gen, dev)
    fl = phase_flash(gen, dev)
    fl8 = phase_flash(gen, dev, int8=True)

    import numpy as np

    rng = np.random.default_rng(0)
    dequant_counts, fast_counts = phase_dequant_api(dev, rng)
    from nf4_tpu_torch.models.configs import LLAMA3_8B

    prompts = [list(map(int, rng.integers(0, LLAMA3_8B.vocab_size, n))) for n in (1024, 37, 300, 64, 700, 9)]
    serve_counts, serving = phase_serving(prompts, args.profile)
    phase_small_model(dev, rng)
    int8_counts, serving8 = phase_int8_serving(prompts, args.profile)
    phase_checkpoint(dev, rng)
    phase_backward(gen, dev)
    # 7 examples of 60-200 tokens that pack into 2 x 512 slots (97.8% full).
    examples = sft_examples(np.random.default_rng(0), LLAMA3_8B.vocab_size, 7, 60, 200)
    train16 = phase_training("6b", "bf16", examples, args.profile)
    train32 = phase_training("6c", "fp32", examples, args.profile)
    check(train32["launches_per_step"]["matmul_bf16"] == 0 and train16["launches_per_step"]["matmul_exact"] == 0,
          "kernel E only in fp32, kernel B only in bf16")
    phase_train_small(rng)
    phase_resume(rng)

    def decode_layer(res):  # one decode layer's four projections at B=4
        return [res[(name, 4)] for name in LLAMA3_8B_PROJ]

    def matmul_row(name, source, replaces, res, launches, prefill=False):
        rows = decode_layer(res)
        row = dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                   max_abs_err=max(r["max_abs_err"] for r in res.values()),
                   ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                   bound_ms=sum(r["bound_ms"] for r in rows), bound_by="bytes",
                   library_ms=sum(r["library_ms"] for r in rows))
        if prefill:  # one prefill layer's four projections at B=1024
            pre = [res[(n, 1024)] for n in LLAMA3_8B_PROJ]
            row.update(prefill_ms=sum(r["ms"] for r in pre), prefill_bound_ms=sum(r["bound_ms"] for r in pre),
                       prefill_library_ms=sum(r["library_ms"] for r in pre))
        return row

    def flash_row(name, res, launches):
        return dict(name=name, route="cuda", source="nf4_tpu_torch/csrc/flash_attn.cu",
                    replaces="nf4_tpu/ops/attention.py:371", launches=launches,
                    max_abs_err=max(r["max_abs_err"] for r in res.values()), ms=res["causal"]["ms"],
                    plain_ms=res["causal"]["plain_ms"], bound_ms=res["causal"]["bound_ms"],
                    bound_by="operations", library_ms=res["causal"]["library_ms"],
                    window_ms=res["window"]["ms"], window_bound_ms=res["window"]["bound_ms"],
                    window_library_ms=res["window"]["library_ms"])

    kernels = [
        dict(name="dequant_t", route="cuda", source="nf4_tpu_torch/csrc/dequant.cu",
             replaces="nf4_tpu/ops/dequant.py:86", launches=dequant_counts["dequant_t"],
             max_abs_err=deq["max_abs_err"], ms=deq["w_down"]["ms"], plain_ms=deq["w_down"]["plain_ms"],
             bound_ms=deq["w_down"]["bound_ms"], bound_by="bytes", library_ms=None),
        matmul_row("matmul_bf16", "nf4_tpu_torch/csrc/matmul.cu", "nf4_tpu/ops/matmul.py:148", mm,
                   serve_counts["matmul_bf16"], prefill=True),
        flash_row("flash_attention", fl, serve_counts["flash_attention"]),
        flash_row("flash_attention_int8", fl8, int8_counts["flash_attention_int8"]),
        matmul_row("int8_matmul", "nf4_tpu_torch/csrc/int8_matmul.cu", "nf4_tpu/ops/int8_serve.py:151", mm8,
                   int8_counts["int8_matmul"], prefill=True),
        dict(name="dequant_t_fast", route="cuda", source="nf4_tpu_torch/csrc/dequant.cu",
             replaces="nf4_tpu/ops/dequant.py:147", launches=fast_counts["dequant_t_fast"],
             max_abs_err=fast["max_abs_err"], ms=fast["w_down"]["ms"], plain_ms=fast["w_down"]["plain_ms"],
             bound_ms=fast["w_down"]["bound_ms"], bound_by="bytes", library_ms=None),
        # Kernel E on its main path's shapes: one training layer's four
        # projections at B=1024 (the 2 x 511 rows of the fp32 step, padded);
        # the bound is the 3xTF32 work, ffma_bound_ms the fp32 one.
        dict(name="matmul_exact", route="cuda", source="nf4_tpu_torch/csrc/matmul_exact.cu",
             replaces="nf4_tpu/ops/matmul.py:186", launches=train32["launches"]["matmul_exact"],
             max_abs_err=max(r["max_abs_err"] for r in ex.values()),
             **{k: sum(ex[(n, 1024)][k] for n in LLAMA3_8B_PROJ)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms", "ffma_bound_ms", "fp16_ms")},
             bound_by="operations", decode_ms=sum(ex[(n, 4)]["ms"] for n in LLAMA3_8B_PROJ),
             f64_err=max(r["f64_err"] for r in ex.values()),
             library_f64_err=max(r["library_f64_err"] for r in ex.values())),
    ]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, dequant=deq, fast_dequant=fast,
                           matmul={f"{k[0]} B={k[1]}": v for k, v in mm.items()},
                           int8_matmul={f"{k[0]} B={k[1]}": v for k, v in mm8.items()},
                           exact_matmul={f"{k[0]} B={k[1]}": v for k, v in ex.items()},
                           flash=fl, flash_int8=fl8, serving=serving, serving_int8=serving8,
                           training_bf16=train16, training_fp32=train32, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
