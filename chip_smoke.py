#!/usr/bin/env python3
"""Drive the PyTorch port (``nf4_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py [--out results.json] [--profile]

Phases, each of which fails the run on any error:

1. the card's name and power limit; build the CUDA kernels from
   ``nf4_tpu_torch/csrc`` (one nvcc per source, in parallel); (d) the
   diagnostics (``nf4_tpu_torch.diagnostics.main()``: versions, the build,
   kernels A and F on a 1024 x 1024 weight against their plain versions
   and the oracle, the CPU, C++ and no-card routes), which must exit 0;
2. kernels A (exact dequant) and F (fast bf16 dequant) against their plain
   versions at the Llama-3-8B shapes, bit for bit, NF4 and FP4 (A also
   bf16 and fp16 out);
3. kernels B (fused 4-bit matmul) and D (int8 matmul) against their plain
   versions at the four projection shapes, decode B=4 and prefill B=1024,
   and at decode B=1, 8 and 16 and the serving run's ragged B=37, 300 and
   700, max rel err < 2e-2; kernel B also at Llama-3-70B's four
   projections at B=4 and 1024, timed;
   (3e) kernel E (the fp32/fp16-activation matmul) at the same shapes and
   rows, fp32 x (fp32 out) and fp16 x (fp16 and fp32 out), max abs err <=
   1e-5 * max|want| for fp32 out, 2e-3 * max|want| for fp16; at B=4 and
   1024 also the largest error of kernel E and of cuBLAS's fp32 product
   against a float64 product, E's at most 4x cuBLAS's; a profile of one
   decode call per projection holds E's decode to one device launch each;
4. kernel C (prefill flash attention), bf16 and int8 KV, against its plain
   version at B=1, H=32, KV=8, D=128, S=1024, T=8192, with and without a
   window, and at a ragged S=700 from position 0 and from 37; the int8
   branch also against the bf16 branch on the dequantized cache; then at
   the further shapes of the TPU kernel's contract and Llama-3-70B's
   (``FLASH_SHAPES``: G = 8 at H = 64, 7, 3, 96 and 1, 2, 4; D = 64, 128,
   256 and 384), T=8192, both KV dtypes,
   causal, windowed and ragged, each timed at S=1024 causal beside its
   bound and SDPA;
5. the main paths, each with every launch count set to 0 just before and
   read just after: (a) the dequant API on Llama-3-8B-shaped weights, exact
   and fast; (b) greedy serving of Llama-3-8B at full width and depth
   (synthetic packed weights from a seed) answering 6 requests of 32 new
   tokens, one prompt of 1024 tokens, its decode chunks CUDA graph replays
   launched ahead of their read-back, every kernel launch count asserted
   exactly and the tokens held to an eager, unpipelined run of the same
   requests, then the same requests again on the same Engine: no capture,
   every chunk a replay, the same launches and tokens; then the requests
   eagerly for 2 tokens with every kernel B, C and D call held to its
   plain version on the same operands (``kernels_held_to_plain``) (so in
   5d, 5f, 5i, 5j and 5k);
   (h) sampled serving over HTTP: a ``CompletionServer`` on 127.0.0.1 over
   an Engine at batch 4 with 5b's weights answers 9 concurrent requests of
   32 tokens (greedy, seeded top-p/top-k, penalties with a banned token,
   streamed with top-5 logprobs, min_tokens, guided choice, one client
   that hangs up after its first event), each answer checked (greedy equal
   to 5b's tokens, seeded and streamed equal to their runs alone, the
   hang-up retired within one decode chunk), graphs captured once per
   feature mix, kernels B and C only; then a decode step with every row
   stochastic against the greedy one, and one request's HTTP round trip
   against ``Engine.generate``; (n) speculative decoding on 5b's weights (``phase_spec``): 5b's
   requests and a 1024-token prompt of one 256-token span repeated four times, 32 tokens each, at
   batch 4, graphed and pipelined, with the adaptive controller on, by prompt lookup at spec_k 3
   (16 verify rows: kernel B's decode kernel) and 7 (32 rows: its prefill kernel) and by a draft
   model (Llama-3-8B's config at 2 layers, views of 5b's tensors), greedy and, for spec_k 3 and
   the draft, stochastic requests through the sampled chunks; every kernel launch count held to
   the forwards the run launched, every chunk a graph replay, greedy tokens held to a plain
   Engine's (any difference must start at a near-tie, whose top-2 gap is printed), a second call
   capturing nothing with the same tokens and launches, one eager verify round of each spec_k
   with every kernel call held to its plain version and its rows counted, and a graphed verify
   round timed at kv_len 1536 against 5b's step; the same in the int8 mode of (d) at spec_k 3;
   (c) a small model on the card against the same model on the
   CPU, also with every field of the Llama-family variants on; (d) the
   same serving in the int8 mode: weights recoded to int8 and an int8 KV
   cache; (e) a packed checkpoint saved by the port, loaded on the card
   with an int8 KV cache and recoded, against the same checkpoint served
   on the CPU; (f) the serving of (b) for Qwen2-7B at full width and depth
   (q/k/v biases, G = 7), every launch count asserted, tokens held to the
   eager run, and the 1024-token prefill's last-position logits held to
   the same prefill on the plain attention path within 2e-2 * max|logit|;
   (g) Gemma-7B at full width (D = 256) and 8 of its 28 layers: that
   prefill check, then 8 greedy tokens; (i) Gemma-2-9B at full width and
   10 of its 42 layers (softcaps, a 4096 window on every other layer,
   four-norm blocks) as (b), kernel C never launched (the softcap keeps
   prefills plain), then a prompt of 4608 tokens past the window, its
   tokens held to eager decode, and the 1024-token prefill held to the
   plain attention and projection path; (j) Gemma-3-4B at full width and
   12 of its 34 layers (max_seq_len cut to 8192) as (b), then a 1536-token prompt (kernel C on every layer,
   windowed on the local ones), its tokens held to eager decode in which
   every kernel call is held to its plain version, and 4 2048-token
   prefills' logits through kernel C, the plain path and the plain path
   in fp32, printed; (k) Mixtral-8x7B at full width and 8 of its 32 layers
   (8 experts, top-2; max_seq_len 8192) as (b), 18 projection launches per
   layer; (t) Llama-3-70B at full width and depth (80 layers, 64 heads
   over 8, 4-bit, max_seq_len 8192) as (b), with at most two 4-slot caches
   alive at once, its memory before the weights, their bytes and the peak
   printed; (l) Qwen3-30B-A3B at full width (128 experts, top-8) and 2 of
   its 48 layers, in the 4-bit and the int8 mode, every launch count exact,
   tokens held to eager decode in which every kernel call is held to its
   plain version, and the 1024-token prefill held to the plain attention
   and projection path (kernel D's in the int8 mode); (m) Llama-3-8B at
   full width and 4 of its 32 layers from an HF checkpoint directory
   written here: a dense bf16 one (two safetensors files, layer 1 across
   them, an untied lm_head) quantized on the card as it loads
   (``load_hf_llama``), its load time, the quantizer's GB/s and ms per
   layer, ``peak_dense_bytes`` at most one layer's, layers 0-1 byte for
   byte the NumPy oracle's on the same fused weights, and the C++ host
   quantizer's on layer 0's w_gateup; a bnb NF4 one of the same weights'
   layers 0-1 (double-quantized per projection by the
   oracle, as Hub checkpoints are; groups across two files) repacked on
   load, its bytes the card's and its scales the oracle's; the midpoint
   stress tensor (4096 x 4096, NF4 and FP4) on the card and the C++ host
   quantizer against the oracle, each method's elements per second; then
   phase 5b's requests on the loaded params in the 4-bit and
   the int8 mode as (b), every kernel call of the eager run held to its
   plain version; (p) scoring and the shared-prefix cache on 5b's
   weights, and again in the int8 mode of (d) (``phase_score_prefix``):
   ``Engine.score`` of 5b's requests with their 32 greedy tokens, every
   launch exact, each generated token's score within 2 x NEAR_TIE x max
   |logit| of its decode-path logprob, a batch of 8 x 1024 seeded tokens
   through kernel C timed with its peak memory and perplexity; six requests
   of one 1024-token prefix and their own tails through 4 slots with
   ``prefix_cache=True``, launches exact, tokens held to the cache-off
   Engine's, a request admitted into an idle slot held to its run alone, a
   second call reusing the saved prefix, each call timed against the
   cache-off one; (r) multi-LoRA serving on 5b's weights, and briefly in
   the int8 mode of (d) (``phase_multi_lora``): a bank of 4 seeded adapters
   (ranks 8, 16, 16, 32, all four targets), 5b's requests with adapters
   ``[None, 0, 1, 2, 3, 0]`` through 4 slots and again with the mix
   permuted (no capture), every launch exact, the request without an
   adapter equal to the phase's tokens, each adapted one held to its run
   alone, an eager call of 2 tokens with every kernel call held to its
   plain version, ``Engine.score`` through two adapters against decode's
   logprobs, the graphed decode step with the bank timed at kv_len 1536,
   and ``merge_lora`` of adapter 0 into 4 layers (kernel A, then the card
   quantizer), its first layer held to the CPU's merge.  Phase (c) also
   runs Gemma-2 and Gemma-3 small models, dense projections and MoE (fp32
   activations) card against CPU, and the MoE MLP alone in bf16 with 4-bit
   and int8 experts.  Every phase's weights are freed before the next.
   Phases 5b, 5d, 5f, 5i, 5j and 5k also time
   decode at batch 4 from position 1024, graphed and pipelined, with the
   device's busy share from ``torch.profiler``; 5b and 5d also at kv
   buckets of 256, 512 and 1024 positions, graphed alone and eager; with
   ``--profile`` they print the device kernels of a graphed and an eager
   decode run and a breakdown of a 1024-token prefill;
6. QLoRA fine-tuning: (a) the ``nf4_matmul`` backward at w_gateup, g
   [1024, 28672], against the plain fp32 product within 1e-5 * max, also
   under ``torch.set_float32_matmul_precision("high")``; (b, c) 3 AdamW
   steps (lr 1e-4, weight decay 1e-4, ``remat=True``) of rank-16 adapters
   on all four targets of Llama-3-8B at full width and depth (synthetic
   packed weights), on one ``pack_sft`` batch of 2 x 512 slots, in bf16
   (kernels B and A) and in fp32 (kernels E and A), each step's launches
   counted from 0, the step-0 loss held against ``lm_loss`` through the
   inference forward (one prefill per example); with ``--profile`` a
   ``torch.profiler`` breakdown of one step; (d) 3 bf16 AdamW steps of
   rank-16 QLoRA on Gemma-2-9B, Gemma-3-4B and Mixtral-8x7B (attention
   only) at full width and 2 layers, launches exact, the step-0 loss held
   to the inference forward's, ms per step and peak memory; then the
   Gemma-2 adapter served from a bank; (s) a small model's train step on
   the card against the CPU (loss, adapter gradients, adapters after one
   SGD step); (e) a run saved with ``save_train_state`` and resumed
   against the uninterrupted run;
7. (q) the trained-in-place quality gate (``nf4_tpu_torch.eval.
   quality_gate`` on its synthetic corpus at its defaults): a byte-level LM
   trained as dense fp32 weights, its held-out perplexity dense, bf16, NF4
   and int8-recoded, every one finite and the NF4 delta within 0.1.

Kernel and library times are device times: many calls captured in one
CUDA graph, replayed, and timed with CUDA events (an eager loop of small
calls would time the host's launch rate instead).  Plain versions are
timed eagerly with CUDA events.  Inputs rotate through copies larger than
the 50 MB L2 cache where one call's inputs fit in it.  ``bound_ms`` is the larger of bytes / 3.35 TB/s and operations /
peak rate (989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32), the H100 SXM data
sheet's figures (kernel E's prefill branch: 3 x the fp32 operations at 495
TFLOP/s tf32, its 3xTF32 work; ``ffma_bound_ms`` beside it is the fp32
figure).  The line before the last holds the card's name and power
limit; the last line is the JSON result.  Each group of phases prints
its seconds (``elapsed:``).  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
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


def device_kernel_counts(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: {device kernel or copy
    name: launches}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU and _device_us(e) > 0}


def profile_breakdown(label: str, fn, rows: int = 15):
    """Run ``fn`` once under ``torch.profiler`` and print the wall time, the
    device's busy share of it and (``rows`` > 0) the device kernels and
    copies by time.  Returns (wall s, device busy s)."""
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
          f"= {busy / wall:.1%}" + ("; device kernels and copies by time:" if rows else ""))
    for e in sorted(events, key=_device_us, reverse=True)[:rows]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    return wall, busy


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
# Llama-3-70B's four projections (phase 3 times kernel B on them too).
LLAMA3_70B_PROJ = {
    "wqkv": (10240, 8192, "bf16"),
    "wo": (8192, 8192, "fp32"),
    "w_gateup": (57344, 8192, "bf16"),
    "w_down": (8192, 28672, "fp32"),
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
    matmul on the same weights recoded) against its plain version; kernel
    B also at Llama-3-70B's projections (keys ``("70b " + name, B)``)."""
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
    timed = [(name, shape) for name, shape in LLAMA3_8B_PROJ.items()]
    if not int8:  # the 4-bit mode alone serves Llama-3-70B
        timed += [(f"70b {name}", shape) for name, shape in LLAMA3_70B_PROJ.items()]
    for b in (4, 1024):
        b_pad = 16 if b <= 16 else b
        for name, (m, n, od) in timed:
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
            flops = 2 * b_pad * pw.padded_shape[1] * pw.padded_shape[0]
            bnd = bound_ms(pw.nbytes + io, flops, PEAK_BF16_S)
            by = "bytes" if (pw.nbytes + io) / PEAK_BYTES_S > flops / PEAK_BF16_S else "operations"
            res[(name, b)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd, bound_by=by,
                                  max_abs_err=err, rel=rel)
            print(f"phase 3 {label} {name} B={b} m={m} n={n} out={od}: rel err {rel:.2e}; {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, torch.matmul on bf16 weight {lib:.4f} ms, bound {bnd:.4f} ms")
    from nf4_tpu_torch.ops.int8_serve import _D_DECODE
    from nf4_tpu_torch.ops.matmul import _B_DECODE, _decode_ksplit, _decode_shape

    query = _D_DECODE if int8 else _B_DECODE  # the shared decode kernel with D's or B's decode
    splits = {name: _decode_ksplit(16, m, n // 64, dev, query) for name, (m, n, _) in timed}
    cols, blocks = _decode_shape(dev, query)
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


# Phase 4's further shapes, the TPU kernel's contract beyond D = 128 and
# 64 % G == 0: (model, H, KV, D).  Each at T = 8192 and B = 1.
FLASH_SHAPES = [
    ("llama3-70b", 64, 8, 128),
    ("qwen2-7b", 28, 4, 128),  # G = 7: one idle row per query tile
    ("gemma-7b", 16, 16, 256),
    ("gemma2-9b", 16, 8, 256),
    ("gemma3-4b", 8, 4, 256),
    ("G=3", 24, 8, 128),
    ("G=96", 96, 1, 64),  # two head groups per position
    ("D=384", 8, 8, 384),  # the wide kernel
]


def phase_flash_shapes(gen, dev):
    """Kernel C at FLASH_SHAPES against its plain version, bf16 and int8 KV:
    a causal 1024-token prompt, the last 1024 positions of a full 8192
    cache under a 4096-slot window, and a ragged S = 700 from position 37,
    each under phase 4's limit.  At S = 1024 causal: the kernel's time in
    both KV dtypes, its plain version's, its bound and SDPA's time."""
    import torch
    import torch.nn.functional as F

    from nf4_tpu_torch.models.llama import _quantize_kv
    from nf4_tpu_torch.ops.attention import _flash_kernel, _flash_plain

    t, s = 8192, 1024
    res = {}
    for name, h, kv, d in FLASH_SHAPES:
        q = torch.randn((1, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((1, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((1, kv, t, d), generator=gen, device=dev).to(torch.bfloat16)
        (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
        q700 = q[:, :, :700].contiguous()
        row, errs = {}, []
        for int8, cache in ((False, (k, v)), (True, (k8, v8, ks, vs))):
            def kern(pos, seq, window, qq=q, cache=cache):
                return _flash_kernel(qq, cache[0], cache[1], pos, seq, d**-0.5, window, *cache[2:])

            for case, qq, pos0, lens, window in (("causal", q, 0, s, None), ("window", q, t - s, t, t // 2),
                                                 ("ragged", q700, 37, 737, None)):
                pos = torch.full((1,), pos0, device=dev, dtype=torch.int32)
                seq = torch.full((1,), lens, device=dev, dtype=torch.int32)
                got = kern(pos, seq, window, qq).float()
                want = _flash_plain(qq, cache[0], cache[1], pos, seq, d**-0.5, window, *cache[2:]).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                limit = 2e-2 * want.abs().max().item()
                check(err <= limit and torch.allclose(got, want, rtol=2e-2, atol=2e-2),
                      f"kernel C {name} {'int8' if int8 else 'bf16'} KV differs from plain ({case}): max abs err "
                      f"{err}, limit {limit}")
                errs.append(err / limit)
                row[f"{'int8_' if int8 else ''}{case}_max_abs_err"] = err
            pos = torch.zeros((1,), device=dev, dtype=torch.int32)
            seq = torch.full((1,), s, device=dev, dtype=torch.int32)
            row["int8_ms" if int8 else "ms"] = time_ms([lambda: kern(pos, seq, None)])
            if not int8:
                row["plain_ms"] = time_ms([lambda: _flash_plain(q, k, v, pos, seq, d**-0.5)], iters=2, graph=False)
        g = h // kv
        kl, vl = k[:, :, :s].repeat_interleave(g, dim=1), v[:, :, :s].repeat_interleave(g, dim=1)
        row["library_ms"] = time_ms([lambda: F.scaled_dot_product_attention(q, kl, vl, is_causal=True)])
        pairs = h * s * (s + 1) // 2  # visible (query, key) pairs over all heads
        for key, slot_bytes in (("", 2 * d), ("int8_", d + 4)):  # K and V bytes of a slot and head
            nbytes = 2 * q.numel() * 2 + 2 * kv * s * slot_bytes
            row[f"{key}bound_ms"] = bound_ms(nbytes, 4 * pairs * d, PEAK_BF16_S)
            row[f"{key}bound_by"] = "bytes" if nbytes / PEAK_BYTES_S > 4 * pairs * d / PEAK_BF16_S else "operations"
        row["tflops"] = 4 * pairs * d / row["ms"] / 1e9
        res[name] = row
        print(f"phase 4 kernel C {name} H={h} KV={kv} (G={g}) D={d}: causal, window and ragged S=700 from 37 in "
              f"bf16 and int8 KV within the limit (largest err/limit {max(errs):.2f}); S=1024 causal {row['ms']:.4f} "
              f"ms ({row['tflops']:.1f} TFLOP/s), int8 KV {row['int8_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"SDPA {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return res


def phase_exact(gen, dev):
    """Kernel E (fused 4-bit matmul, fp32/fp16 activations, fp32 products)
    against its plain version, and at B=4 and 1024 kernel E and cuBLAS's
    fp32 product against a float64 product; timed with fp32 x and fp32 out
    (and fp16 x); the decode kernel's block shape, K splits and device
    launches per call."""
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

    # Checked only: decode rows 1, 8 and 16 (b_pad 16) and the ragged rows of
    # a prefill, b_pad 64, 320 and 704 (the last 128-row tile partly filled).
    for b in (1, 8, 16, 37, 300, 700):
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
            xh = x.half()
            fp16_ms = time_ms([lambda w=w: _matmul_exact_kernel(xh, w.packed, w.scales, torch.float32) for w in ws])
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
                  f"({2 * b * m * n / ms / 1e9:.1f} TFLOP/s), fp16 x {fp16_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.matmul on fp32 weight {lib:.4f} ms, bound {bnd:.4f} ms (fp32 FFMA {ffma:.4f} ms)")
    from nf4_tpu_torch.ops.matmul import _E_DECODE, _decode_ksplit, _decode_shape

    splits = {name: _decode_ksplit(16, m, n // 64, dev, _E_DECODE) for name, (m, n, _) in LLAMA3_8B_PROJ.items()}
    cols, blocks = _decode_shape(dev, _E_DECODE)
    # Device launches of one decode call per projection (K split or not):
    # the split sum is in the kernel, so one each.
    calls = []
    for name, (m, n, _) in LLAMA3_8B_PROJ.items():
        pw = random_packed(gen, m, n, dev)
        x = torch.zeros((16, n), device=dev)
        x[:4] = torch.randn((4, n), generator=gen, device=dev)
        calls.append(lambda x=x, pw=pw: _matmul_exact_kernel(x, pw.packed, pw.scales, torch.float32))
    launched = device_kernel_counts(lambda: [c() for c in calls])
    check(sum(launched.values()) == len(calls) and all("decode_kernel" in k for k in launched),
          f"kernel E's decode: device launches {launched} for {len(calls)} calls")
    print(f"phase 3e kernel E decode: blocks of {cols} columns, {blocks} per SM, K splits {splits}; "
          f"device launches per call 1 ({sum(launched.values())} for {len(calls)} calls, no second pass)")
    return res, dict(cols=cols, blocks_per_sm=blocks, ksplit=splits,
                     device_launches_per_call=sum(launched.values()) / len(calls))


def flash_shape_rows(res, int8) -> dict:
    """The ``kernels`` line's ``shapes`` of a kernel C row: phase 4's
    further shapes at S=1024 causal in this KV dtype (``res`` from
    :func:`phase_flash_shapes`)."""
    pre = "int8_" if int8 else ""
    return {k: dict(ms=r[f"{pre}ms"], bound_ms=r[f"{pre}bound_ms"], bound_by=r[f"{pre}bound_by"],
                    library_ms=None if int8 else r["library_ms"], plain_ms=None if int8 else r["plain_ms"],
                    max_abs_err=max(v for e, v in r.items()
                                    if e.endswith("_max_abs_err") and e.startswith("int8_") == int8))
            for k, r in res.items()}


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
    from nf4_tpu_torch.ops.int8_serve import PackedInt8

    def mv(w):
        if w is None:
            return None
        if isinstance(w, PackedNF4):
            return dataclasses.replace(w, packed=w.packed.to(device), scales=w.scales.to(device))
        if isinstance(w, PackedInt8):
            return dataclasses.replace(w, values=w.values.to(device), scales=w.scales.to(device))
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


# The serving run's schedule (4 slots, the 6 prompts of main(), 32 new
# tokens each, chunks of 8): wave 1 prefills 3 groups (buckets 1024, 64 x 2,
# 512) and decodes 31 steps (3 chunks, the second and third launched ahead,
# then 7 single steps); wave 2 prefills 2 groups (1024, 16) and decodes 31
# steps the same way.  Every forward launches one projection kernel per
# projection and layer; kernel C runs once per layer in each prefill that
# `attention` sends to it: S >= 256 and B * H * S * T at least its
# threshold, T the cache's max_seq_len (Llama-3-8B: the 3 prefills of >= 512
# tokens; Qwen2-7B, 28 heads: the 2 of 1024).
SERVE_PREFILLS = [(1, 1024), (2, 64), (1, 512), (1, 1024), (1, 16)]  # (group size, bucket)
SERVE_FORWARDS, SERVE_CHUNKS = 5 + 62, 6


def flash_prefills(cfg, groups) -> int:
    """How many of the prefill ``groups`` (size, bucket) take kernel C (none
    under an attention softcap, which kernel C does not take)."""
    from nf4_tpu_torch.ops.attention import _CHUNKED_MIN_SCORE_ELEMS

    if cfg.attn_logit_softcapping is not None:
        return 0
    return sum(s >= 256 and g * cfg.num_heads * s * cfg.max_seq_len >= _CHUNKED_MIN_SCORE_ELEMS for g, s in groups)


def projections_per_layer(cfg) -> int:
    """Projection-kernel launches of one layer's forward: wqkv, wo, and
    gate+up and down once per expert (once for a dense MLP)."""
    return 2 + 2 * cfg.num_experts


def serve_expected(cfg, forwards=SERVE_FORWARDS, groups=SERVE_PREFILLS) -> tuple:
    """(projection-kernel launches, kernel-C launches) of a serving run of
    ``forwards`` forwards whose prefill ``groups`` are (size, bucket) (by
    default the serving run's)."""
    return forwards * projections_per_layer(cfg) * cfg.num_layers, flash_prefills(cfg, groups) * cfg.num_layers


def serve_llama(label, params, cfg, prompts, weight_bytes, profile, by_bucket=True):
    """Greedy serving at batch 4 on the graphed, pipelined decode path: the
    requests with every launch count set to 0 just before and read just
    after, then the same requests eager and unpipelined, token for token;
    then the prefill of the 1024-token prompt, and decode chunks from
    position 1024 timed alone: graphed and pipelined at the engine's kv
    bucket with its device-busy share and, with ``by_bucket``, at kv
    buckets of 256, 512 and 1024 positions, graphed alone and eager (with
    its busy share)."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import Decoder, Engine, kv_bucket

    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == len(prompts), "every request answered")
    for r, p in zip(results, prompts):
        check(r.prompt == p and len(r.tokens) == 32, "32 new tokens per request")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens), "tokens in the vocabulary")
    graphs, pipe = dict(eng.graph_stats), dict(eng.pipeline_stats)
    check(graphs["replayed"] == SERVE_CHUNKS and pipe == {"launched": 4, "discarded": 0},
          f"every chunk a graph replay, 2 per wave launched ahead: {graphs}, {pipe}")
    # Call 2 on the same Engine: its cache, Decoder and graphs are kept, so
    # it captures nothing, replays every chunk and launches what call 1 did.
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    again = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    gen2_s = time.perf_counter() - t0
    check(eng.graph_stats["captured"] == graphs["captured"]
          and eng.graph_stats["replayed"] == graphs["replayed"] + SERVE_CHUNKS,
          f"call 2 captured a graph or ran a chunk eagerly: {graphs} -> {eng.graph_stats}")
    check([r.tokens for r in again] == [r.tokens for r in results], "call 2's tokens differ from call 1's")
    check(_cuda.launch_counts() == counts, f"call 2 launched {_cuda.launch_counts()}, call 1 {counts}")
    eager = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, pipeline_decode=False,
                   cuda_graphs=False)
    t0 = time.perf_counter()
    want = eager.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    check([r.tokens for r in results] == [r.tokens for r in want],
          "graphed, pipelined tokens differ from eager, unpipelined decode")
    with kernels_held_to_plain(label, cfg.num_experts) as held:  # the same prefills and 1 decode step
        eager.generate(prompts, max_new_tokens=2)
    peak_eager = torch.cuda.max_memory_allocated()  # both Engines' caches and the held calls' plain versions
    print(f"phase {label} generate (graphed, pipelined): {len(prompts)} requests x 32 tokens in {gen_s:.2f} s, "
          f"again on the same Engine {gen2_s:.2f} s (0 captures, the same tokens and launches; eager, "
          f"unpipelined: {eager_s:.2f} s; tokens identical); launches {counts}; graphs captured "
          f"{graphs['captured']} in {graphs['capture_s']:.2f} s, pool {graphs['pool_bytes'] / 1e6:.1f} MB, "
          f"replays {graphs['replayed']}; pipeline {pipe}; peak memory {peak / 1e9:.1f} GB, "
          f"{peak_eager / 1e9:.1f} GB with the eager Engine and the held calls")
    if not by_bucket:  # the eager Engine is not timed: at most two caches at once
        del eager
        free_memory()

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

    # Decode at batch 4 from position 1024: 4 chunks of 8 steps (positions
    # 1024-1055) at one kv bucket, after one untimed chunk (a capture).
    pos, act, cur = np.full(4, 1024, np.int64), np.ones(4, bool), np.zeros(4, np.int32)
    chunks, n = 4, 8

    def decode_run(dec, kv, pipelined):
        h = dec.launch(n, kv, cur, pos, act)
        for _ in range(chunks - 1):
            if pipelined:  # the next chunk goes in before this one is read
                nxt = dec.launch(n, kv)
                dec.read(h)
                h = nxt
            else:
                dec.read(h)
                h = dec.launch(n, kv)
        return dec.read(h)

    def decode_ms(engine, gran, pipelined):
        dec = Decoder(engine, cache)
        kv = kv_bucket(1024 + chunks * n, gran, cfg.max_seq_len)
        dec.read(dec.launch(n, kv, cur, pos, act))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode_run(dec, kv, pipelined)
        ms = (time.perf_counter() - t0) * 1e3 / (chunks * n)
        check(out.shape == (n, 4) and ((out >= 0) & (out < cfg.vocab_size)).all(), "decode tokens")
        return ms, dec, kv

    ms_pipe, dec, kv = decode_ms(eng, eng.KV_BUCKET, True)
    rows = 15 if profile else 0
    wall, busy = profile_breakdown(f"{label} decode, {chunks} graphed pipelined chunks of {n} steps, batch 4, "
                                   f"position 1024, kv_len {kv}", lambda: decode_run(dec, kv, True), rows)
    bound = weight_bytes / PEAK_BYTES_S
    res = dict(generate_s=gen_s, generate_again_s=gen2_s, generate_eager_s=eager_s, graph_stats=graphs, held=held,
               peak_graphed_gb=peak / 1e9, peak_eager_gb=peak_eager / 1e9,
               pipeline_stats=pipe, tokens=[r.tokens for r in results],
               prefill_tok_s=1024 / prefill_s, prefill_ms=prefill_s * 1e3, kv_bucket=eng.KV_BUCKET, kv_len=kv,
               decode_ms_step=ms_pipe, decode_tok_s=4e3 / ms_pipe, decode_busy=busy / wall,
               weight_gb=weight_bytes / 1e9, kv_cache_gb=cache.nbytes / 1e9)
    more = ""
    if by_bucket:
        res["decode_ms_step_by_bucket"] = {g: decode_ms(eng, g, True)[0] for g in (256, 512, 1024)}
        res["decode_graphed_ms_step"] = decode_ms(eng, eng.KV_BUCKET, False)[0]
        res["decode_eager_ms_step"], dec_eager, _ = decode_ms(eager, eng.KV_BUCKET, False)
        wall_e, busy_e = profile_breakdown(f"{label} decode, {chunks} eager chunks of {n} steps, batch 4, "
                                           f"position 1024, kv_len {kv}", lambda: decode_run(dec_eager, kv, False),
                                           rows)
        res["decode_eager_busy"] = busy_e / wall_e
        more = (f"; graphed {res['decode_graphed_ms_step']:.2f} ms/step; eager {res['decode_eager_ms_step']:.2f} "
                f"ms/step, device busy {busy_e / wall_e:.1%} (profiled); graphed and pipelined by kv bucket "
                f"{{{', '.join(f'{g}: {ms:.2f}' for g, ms in res['decode_ms_step_by_bucket'].items())}}} ms/step")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9  # since the serving run began
    print(f"phase {label} prefill 1024 tokens: {prefill_s * 1e3:.1f} ms = {1024 / prefill_s:.0f} tokens/s "
          f"(median of {[round(t * 1e3, 1) for t in prefill_runs]} ms); decode B=4 at position 1024, kv bucket "
          f"{eng.KV_BUCKET} (kv_len {kv}): graphed and pipelined {ms_pipe:.2f} ms/step = {4e3 / ms_pipe:.1f} "
          f"tokens/s, device busy {busy / wall:.1%} (profiled){more}; weight-stream bound "
          f"{bound * 1e3:.2f} ms/step; on {card_line()}")
    if profile:
        profile_breakdown(f"{label} prefill 1024 tokens", step)
    return counts, res


def projection_bytes(params) -> int:
    return sum(w.nbytes for lp in params.layers for w in (lp.wqkv, lp.wo, lp.w_gateup, lp.w_down))


def in_vocab(prompts, cfg):
    """main()'s prompts (drawn over Llama-3's vocabulary) mapped into a
    smaller one."""
    return [[t % cfg.vocab_size for t in p] for p in prompts]


def free_memory():
    """Drop what the last phase left (its params, engines, graphs' pools)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


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
    proj, flash = serve_expected(cfg)
    check(counts["matmul_bf16"] == proj and counts["flash_attention"] == flash,
          f"serving launched kernels B and C {counts['matmul_bf16']} and {counts['flash_attention']} times, "
          f"not {proj} and {flash}: {counts}")
    return counts, serving, params


def http_post(port, body, timeout=600):
    """POST a completion request to the server on ``port``; (status, JSON
    body) of the reply, or (200, [tokens]) of a streamed one."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            if not body.get("stream"):
                return resp.status, json.loads(raw)
            events = [line[6:] for line in raw.decode().split("\n") if line.startswith("data: ")]
            check(events and events[-1] == "[DONE]", f"stream ends with [DONE]: {events[-3:]}")
            return resp.status, [json.loads(e)["token"] for e in events[:-1]]
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def stream_and_hang_up(port, body, before_close, timeout=600):
    """Send a streamed request on a raw socket, read its first SSE event and
    close the connection; returns what ``before_close()`` returned just
    before the close."""
    import socket

    data = json.dumps(body).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(data) + data)
        buf = b""
        while b"data: " not in buf or not buf.split(b"data: ", 1)[1].count(b"\n\n"):
            chunk = sock.recv(4096)
            check(chunk, "the server closed the stream before its first event")
            buf += chunk
        seen = before_close()
    return seen


# Phase 5h's requests, in the order they reach the server (one wave of 9
# on 4 slots, 32 new tokens each): prompt index into main()'s prompt set,
# and the request's fields.  The greedy ones (A, B) prefill alone as in
# phase 5b's first wave; the seeded (S1, S2) and streamed (T) ones, which
# are sent again alone later, prefill alone here too: no request that
# refills beside them has their prompt bucket (16, 1024, 512).
HTTP_REQUESTS = [
    ("A", 0, dict()),
    ("B", 2, dict()),
    ("P", 1, dict(repetition_penalty=1.2, presence_penalty=0.5, frequency_penalty=0.5)),
    ("M", 3, dict(min_tokens=8)),
    ("S1", 5, dict(temperature=0.8, top_p=0.95, top_k=50, seed=7)),
    ("S2", 4, dict(temperature=0.8, top_p=0.95, top_k=50, seed=7)),
    ("T", 2, dict(stream=True, logprobs=True, top_logprobs=5)),
    ("C", 1, dict()),
    ("X", 3, dict(stream=True)),
]


def phase_http_serving(params, prompts, want, profile):
    """Main path (h): sampled serving of Llama-3-8B over HTTP.  A
    ``CompletionServer`` on 127.0.0.1 (any free port) over an Engine at
    batch 4 with phase 5b's weights; HTTP_REQUESTS sent concurrently from
    client threads, with every launch count set to 0 just before and read
    just after; checks on each answer; then the seeded and streamed
    requests again alone, the stochastic decode step timed against the
    greedy one, and one request's HTTP round trip against
    ``Engine.generate``.

    The Engine runs at its default kv bucket: decode attention reads fixed
    key blocks, so a request's logits do not depend on its batchmates'
    positions or the chunk, and the equality checks hold whatever kv_len a
    chunk reads.  What they can depend on is the size of the group a
    prompt prefilled in, so the queue order is fixed and the compared
    requests prefill alone, in here and in their reruns (HTTP_REQUESTS)."""
    import threading

    import numpy as np
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.api import CompletionServer
    from nf4_tpu_torch.serve.engine import ChunkKind, Decoder, Engine
    from nf4_tpu_torch.serve.sampling import SamplingParams

    cfg = configs.LLAMA3_8B
    n_chunk, budget = 8, 32
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=n_chunk)
    window = 3.0  # one wave collects every request
    server = CompletionServer(eng, batch_window=window)
    pendings = []
    submit = server.submit
    server.submit = lambda *a, **k: pendings.append(submit(*a, **k)) or pendings[-1]
    port = server.start("127.0.0.1", 0)
    banned = want[1][0]  # P's first greedy token
    stop = want[3][1]  # M's second greedy token
    choices = [[want[1][5], want[1][6]], [want[3][4]], [11, 12, 13]]
    bodies = {}
    for name, i, fields in HTTP_REQUESTS:
        body = dict(prompt=prompts[i], max_tokens=budget, **fields)
        if name == "P":
            body["logit_bias"] = {str(banned): -100.0}
        if name == "M":
            body["stop"] = [stop]
        if name == "C":
            body["guided_choice"] = choices
        bodies[name] = body
    try:
        answers, hung_up = {}, {}
        names = [name for name, _, _ in HTTP_REQUESTS]

        def client(name):
            if name == "X":  # the tokens X has been given when its client closes
                hung_up[name] = stream_and_hang_up(port, bodies[name], lambda: pendings[names.index(name)].emitted)
            else:
                answers[name] = http_post(port, bodies[name])

        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        threads = []
        for name, _, _ in HTTP_REQUESTS:  # arrival order = queue order
            threads.append(threading.Thread(target=client, args=(name,)))
            threads[-1].start()
            time.sleep(0.1)
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "an HTTP client did not finish")
        while server.stats["waves"] < 1 or not all(p.done.is_set() for p in pendings):
            time.sleep(0.05)
        torch.cuda.synchronize()
        wave_s = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        check(server.stats["waves"] == 1 and len(pendings) == len(HTTP_REQUESTS),
              f"one wave of {len(HTTP_REQUESTS)} requests: {server.stats}")
        got = {}
        for name, (code, a) in answers.items():
            check(code == 200, f"{name}: HTTP {code} {a}")
            got[name] = a if bodies[name].get("stream") else a["choices"][0]["tokens"]
            check(all(0 <= t < cfg.vocab_size for t in got[name]), f"{name}: tokens in the vocabulary")
        for name, i in (("A", 0), ("B", 2)):
            check(got[name] == want[i], f"greedy {name} differs from phase 5b's tokens for prompt {i}")
        check(banned not in got["P"] and len(got["P"]) == budget, f"P emitted the banned token {banned}")
        check(len(got["M"]) >= 8 and stop not in got["M"][:8], f"M stopped before min_tokens: {got['M']}")
        check(got["C"] in choices, f"C's answer {got['C']} is not one of {choices}")
        check([p.tokens for p in pendings] == [prompts[i] for _, i, _ in HTTP_REQUESTS], "arrival order")
        x = pendings[names.index("X")]
        check(x.cancelled and not x.result.finished and server.stats["cancelled"] == 1,
              f"X was not cancelled: {server.stats}")
        past = len(x.result.tokens) - hung_up["X"]
        check(past <= n_chunk, f"X took {past} tokens after its client closed the connection, more than one chunk")
        # Each feature mix's graphs are captured once: every capture made
        # a key of its own.
        check(eng.graph_stats["captured"] == len(eng.state()[1].graphs), f"a graph captured twice: {eng.graph_stats}")
        only = {"matmul_bf16", "flash_attention"}
        check(all(counts[k] > 0 for k in only) and all(v == 0 for k, v in counts.items() if k not in only),
              f"sampled HTTP serving must launch kernels B and C only: {counts}")

        # The seeded requests again, each alone in a wave of its own; the
        # streamed one again unstreamed.  From here on a wave starts as soon
        # as its request arrives.
        server.batch_window = 0.01
        for name in ("S1", "S2"):
            code, a = http_post(port, bodies[name])
            check(code == 200 and a["choices"][0]["tokens"] == got[name], f"seeded {name} alone differs")
        code, t_alone = http_post(port, dict(bodies["T"], stream=False))
        check(code == 200 and t_alone["choices"][0]["tokens"] == got["T"], "streamed T differs from unstreamed")
        lp = t_alone["choices"][0]["logprobs"]
        check(len(lp["top_logprobs"]) == budget and all(len(row) == 5 for row in lp["top_logprobs"])
              and all(abs(max(row.values()) - v) < 1e-5 for row, v in zip(lp["top_logprobs"], lp["token_logprobs"])),
              "T: 5 top logprobs per position, the greedy token's the largest")
        print(f"phase 5h sampled HTTP serving, Llama-3-8B, batch 4: {len(HTTP_REQUESTS)} concurrent requests x "
              f"{budget} tokens in one wave, {wave_s:.2f} s from the first send to the last answer ({window} s "
              f"of batch window); greedy A, B equal phase 5b's tokens; seeded S1, S2 equal their runs alone; "
              f"streamed T equals its unstreamed run; banned token absent; M gave {len(got['M'])} tokens (at least "
              f"8 before its stop); C answered {got['C']}; X took {past} tokens after its client hung up; graphs {eng.graph_stats['captured']} captured "
              f"(keys {len(eng.state()[1].graphs)}); launches {counts}")

        # A 32-token greedy request over HTTP, after one warm-up, against
        # Engine.generate of the same request (the server stopped).
        one = dict(prompt=prompts[1], max_tokens=budget)
        http_post(port, one)
        http_runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            code, a = http_post(port, one)
            http_runs.append(time.perf_counter() - t0)
        check(code == 200 and len(a["choices"][0]["tokens"]) == budget, "HTTP round trip")
        http_s = sorted(http_runs)[1]
        wall_h, busy_h = profile_breakdown("5h HTTP round trip, 32 greedy tokens", lambda: http_post(port, one), 0)
    finally:
        server.stop()
    direct = lambda: eng.generate([prompts[1]], max_new_tokens=budget)
    direct_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = direct()
        torch.cuda.synchronize()
        direct_runs.append(time.perf_counter() - t0)
    check(out[0].tokens == a["choices"][0]["tokens"], "Engine.generate differs from the HTTP answer")
    direct_s = sorted(direct_runs)[1]
    wall_d, busy_d = profile_breakdown("5h Engine.generate, 32 greedy tokens", direct, 0)

    # Decode at batch 4 from position 1024 (kv_len 1536), graphed and
    # pipelined: the greedy body, then every row stochastic (top-p, top-k,
    # penalties on a counts mask, top_logprobs 5).
    cache = init_kv_cache(cfg, 4)
    eng.prefill_group(cache, np.asarray([prompts[0]], np.int32), np.asarray([1024], np.int32), np.asarray([0]))
    pos, act, cur = np.full(4, 1024, np.int64), np.ones(4, bool), np.zeros(4, np.int32)
    stoch = SamplingParams(temperature=0.8, top_p=0.95, top_k=50, presence_penalty=0.5, frequency_penalty=0.5,
                           top_logprobs=5, seed=7)
    chunks = 4

    def run(dec, kind):
        h = dec.launch(n_chunk, 1536, cur, pos, act, steps=np.zeros(4), kind=kind)
        for _ in range(chunks - 1):
            nxt = dec.launch(n_chunk, 1536, kind=kind)
            dec.read(h)
            h = nxt
        return dec.read_all(h)

    steps_ms = {}
    for label, kind in (("greedy", None), ("stochastic", ChunkKind(5, "counts", False))):
        dec = Decoder(eng, cache)
        dec.prepare(kind)
        dec.set_sampling([stoch] * 4)
        run(dec, kind)  # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, lps, tops = run(dec, kind)
        steps_ms[label] = (time.perf_counter() - t0) * 1e3 / (chunks * n_chunk)
        check(toks.shape == (n_chunk, 4) and ((toks >= 0) & (toks < cfg.vocab_size)).all(), f"{label} tokens")
        if kind is not None:
            check(bool(np.isfinite(lps).all()) and tops[0].shape == (n_chunk, 4, 5), "stochastic logprobs")
        if label == "stochastic":
            wall_s, busy_s = profile_breakdown("5h decode, every row stochastic, 4 graphed pipelined chunks of 8 "
                                               "steps, batch 4, position 1024, kv_len 1536",
                                               lambda: run(dec, kind), 15 if profile else 0)
    print(f"phase 5h decode B=4 at position 1024 (kv_len 1536), graphed and pipelined: greedy "
          f"{steps_ms['greedy']:.2f} ms/step, every row stochastic (top-p, top-k, counts, top-5 logprobs) "
          f"{steps_ms['stochastic']:.2f} ms/step (+{steps_ms['stochastic'] - steps_ms['greedy']:.2f}), device busy "
          f"{busy_s / wall_s:.1%}; one 32-token greedy request: HTTP round trip {http_s * 1e3:.1f} ms (median of "
          f"{[round(t * 1e3, 1) for t in http_runs]} ms), Engine.generate {direct_s * 1e3:.1f} ms (median of "
          f"{[round(t * 1e3, 1) for t in direct_runs]} ms), device busy "
          f"{busy_h / wall_h:.1%} over HTTP, {busy_d / wall_d:.1%} direct; on {card_line()}")
    return counts, dict(wave_s=wave_s, graph_stats=dict(eng.graph_stats), graph_keys=len(eng.state()[1].graphs),
                        decode_ms_step_greedy=steps_ms["greedy"], decode_ms_step_stochastic=steps_ms["stochastic"],
                        decode_stochastic_busy=busy_s / wall_s, http_round_trip_s=http_s, generate_s=direct_s,
                        http_busy=busy_h / wall_h, generate_busy=busy_d / wall_d)


# Phase 5n: speculative decoding.  Its seventh request is a 1024-token
# prompt of one 256-token span repeated four times (text that re-emits its
# input is where prompt lookup pays); a token difference from plain decode
# must start where the plain path's top-2 logit gap is at most NEAR_TIE x
# max |logit| (the verify forward sums attention in another shape).
SPEC_SPAN, NEAR_TIE = 256, 2e-2


@contextlib.contextmanager
def forward_tally(eng):
    """Within it, count the forwards ``eng`` launches, by what launches
    them: a decode chunk or step of n steps is n forwards of the target; a
    speculative chunk of n rounds n verify forwards and, with a draft
    model, n (k + 1) draft decode steps; a host-stepped verify one verify
    forward and k draft steps; a prefill (the target's, or the draft's at
    a refill or a catch-up) one forward per segment, kernel C on every
    layer of each segment attention sends to it (``flash_prefills``).
    Also counts the chunks (``chunks``: each a graph replay on CUDA), the
    speculative ones and the host-stepped verifies.  Yields the counter."""
    import collections

    from nf4_tpu_torch.serve import engine as engine_mod

    tally = collections.Counter()
    _, dec = eng.state()
    launch, launch_spec, single = dec.launch, dec.launch_spec, engine_mod._Scheduler.spec_single
    seg = eng.PREFILL_SEGMENT

    def on_launch(n, *a, **kw):
        tally["target"] += n
        tally["chunks"] += n > 1
        return launch(n, *a, **kw)

    def on_launch_spec(n, kv_len, kind, *a, **kw):
        tally["target"] += n
        tally["draft"] += n * (kind.k + 1) if kind.draft else 0
        tally["chunks"] += 1
        tally["spec_chunks"] += 1
        return launch_spec(n, kv_len, kind, *a, **kw)

    def on_single(sched, act, idx, kind, samples):
        tally["target"] += 1
        tally["draft"] += kind.k if kind.draft else 0
        tally["host_verifies"] += 1
        return single(sched, act, idx, kind, samples)

    def counted(who, fn, cfg):
        def run(cache, tokens, *a, **kw):
            g, bucket = tokens.shape
            widths = [min(seg, bucket - t0) for t0 in range(0, bucket, seg)]
            tally[who] += len(widths)
            tally[f"flash_{who}"] += flash_prefills(cfg, [(g, w) for w in widths])
            return fn(cache, tokens, *a, **kw)
        return run

    dec.launch, dec.launch_spec = on_launch, on_launch_spec
    eng.prefill_group = counted("target", eng.prefill_group, eng.cfg)
    if eng._draft is not None:
        eng.prefill_draft = counted("draft", eng.prefill_draft, eng._draft[1])
    engine_mod._Scheduler.spec_single = on_single
    try:
        yield tally
    finally:
        engine_mod._Scheduler.spec_single = single
        del dec.launch, dec.launch_spec, eng.prefill_group
        if eng._draft is not None:
            del eng.prefill_draft


def spec_generate(label, eng, prompts, sampling=None, int8=False, budget=32, adapter=None, logprobs=False):
    """One ``generate`` of ``prompts`` on ``eng`` with every launch count set
    to 0 just before and read just after, held to exactly the launches of
    the forwards it ran (``forward_tally``): kernel B (or D) once per
    projection and layer of every target and draft forward, kernel C on
    every layer of each prefill segment attention sends to it, no kernel
    of the other mode; every chunk a graph replay.  Returns (results,
    launch counts, tally, seconds)."""
    import torch

    from nf4_tpu_torch.ops import _cuda

    cfg = eng.cfg
    dcfg = eng._draft[1] if eng._draft is not None else None
    replayed = eng.graph_stats["replayed"]
    with forward_tally(eng) as tally:
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        results = eng.generate(prompts, max_new_tokens=budget, sampling=sampling, adapter=adapter,
                               return_logprobs=logprobs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _cuda.launch_counts()
    check(len(results) == len(prompts) and all(
        len(r.tokens) == budget and all(0 <= t < cfg.vocab_size for t in r.tokens) for r in results),
        f"{label}: {budget} tokens in the vocabulary per request")
    proj = projections_per_layer(cfg) * cfg.num_layers * tally["target"]
    flash = cfg.num_layers * tally["flash_target"]
    if dcfg is not None:
        proj += projections_per_layer(dcfg) * dcfg.num_layers * tally["draft"]
        flash += dcfg.num_layers * tally["flash_draft"]
    names = ("int8_matmul", "flash_attention_int8") if int8 else ("matmul_bf16", "flash_attention")
    others = ("matmul_bf16", "flash_attention") if int8 else ("int8_matmul", "flash_attention_int8")
    check(counts[names[0]] == proj and counts[names[1]] == flash and counts[others[0]] == counts[others[1]] == 0,
          f"{label}: launched {counts}, not {names[0]} {proj} and {names[1]} {flash} for the forwards {dict(tally)}")
    check(eng.graph_stats["replayed"] - replayed == tally["chunks"],
          f"{label}: {eng.graph_stats['replayed'] - replayed} graph replays for {tally['chunks']} chunks")
    return results, counts, dict(tally), secs


def tokens_held(label, eng, got, want, adapters=None) -> list:
    """``got``'s tokens equal ``want``'s for every request, or the first
    difference comes where the plain prefill path's top-2 logit gap after
    ``want``'s tokens (through each request's bank adapter, ``adapters``)
    is at most NEAR_TIE x max |logit|.  Returns [(request, token index,
    gap, max |logit|)] of the differences, printed."""
    import numpy as np

    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.utils.shapes import bucket_len

    cfg = eng.cfg
    diffs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g.tokens == w.tokens:
            continue
        at = next(j for j, (a, b) in enumerate(zip(g.tokens, w.tokens)) if a != b)
        seq = list(w.prompt) + list(w.tokens[:at])
        toks = np.zeros((1, min(bucket_len(len(seq)), cfg.max_seq_len)), np.int32)
        toks[0, : len(seq)] = seq
        ids = None if adapters is None or adapters[i] is None else np.asarray([adapters[i]], np.int32)
        logits = eng.prefill_group(init_kv_cache(cfg, 1), toks, np.asarray([len(seq)], np.int32), np.asarray([0]),
                                   adapter_ids=ids)
        top = logits[0].float().topk(2).values
        gap, scale = (top[0] - top[1]).item(), logits.abs().max().item()
        diffs.append((i, at, gap, scale))
        check(gap <= NEAR_TIE * scale, f"{label}: request {i} differs from plain decode at token {at}, where the "
                                       f"top-2 gap is {gap} (max |logit| {scale}): not a near-tie")
    print(f"phase {label} tokens: {len(got) - len(diffs)} of {len(got)} requests equal plain decode's; "
          f"differences (request, token, top-2 gap, max |logit|): {diffs}")
    return diffs


def verify_round_ms(eng, cfg, prompt, kind, chunks=4, n=8) -> float:
    """ms per speculative round of ``kind`` at batch 4 from position 1024
    (kv_len 1536), graphed and pipelined: ``chunks`` chunks of ``n`` rounds
    on a Decoder of ``eng`` over a scratch cache with ``prompt`` prefilled
    in slot 0, after one untimed chunk (its capture)."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.serve.engine import Decoder, kv_bucket

    cache = init_kv_cache(cfg, 4)
    eng.prefill_group(cache, np.asarray([prompt], np.int32), np.asarray([len(prompt)], np.int32), np.asarray([0]))
    dcache = init_kv_cache(eng._draft[1], 4) if kind.draft else None
    dec = Decoder(eng, cache, dcache)
    pos, act, cur = np.full(4, 1024, np.int64), np.ones(4, bool), np.zeros(4, np.int32)
    kv = kv_bucket(1024 + (chunks + 1) * n * (kind.k + 1), eng.KV_BUCKET, cfg.max_seq_len)
    dec.read_spec(dec.launch_spec(n, kv, kind, cur, pos, act))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = dec.launch_spec(n, kv, kind, cur, pos, act)
    for _ in range(chunks - 1):
        nxt = dec.launch_spec(n, kv, kind)
        dec.read_spec(h)
        h = nxt
    targets, acc, lps = dec.read_spec(h)
    ms = (time.perf_counter() - t0) * 1e3 / (chunks * n)
    check(kv == 1536 and bool(np.isfinite(lps).all()) and ((targets >= 0) & (targets < cfg.vocab_size)).all(),
          "verify rounds' outputs")
    return ms


def phase_spec(params, cfg, prompts, want, step_ms, int8=False):
    """Main path (n): speculative decoding of Llama-3-8B at full width and
    depth at batch 4, graphed and pipelined, on the phase's own weights
    (5b's, or 5d's int8 ones): the phase's requests and a 1024-token
    repeated span, 32 tokens each, by prompt lookup at spec_k 3 (16 verify
    rows: kernel B's or D's decode kernel) and 7 (32 rows: its prefill
    kernel) and by a draft model (Llama-3-8B's config at 2 layers, views
    of the first two layers and the embedding, final norm and lm_head),
    with the adaptive controller on.  Each: every launch count exact
    (``spec_generate``), greedy tokens held to a plain Engine's
    (``tokens_held``; the plain Engine's to the phase's own for its
    requests), a second call on the same Engine capturing nothing with the
    same tokens and launches; stochastic requests through the sampled
    chunks; one eager host-stepped verify round of each spec_k with every
    kernel call held to its plain version and the verify's rows counted; a
    graphed verify round timed at kv_len 1536 against ``step_ms``, 5b's (or
    5d's) plain step.  The int8 mode: prompt lookup at spec_k 3."""
    import collections

    import numpy as np
    import torch

    from nf4_tpu_torch.ops import int8_serve as i8
    from nf4_tpu_torch.ops import matmul as mm
    from nf4_tpu_torch.serve.engine import Engine, SpecKind
    from nf4_tpu_torch.serve.sampling import SamplingParams

    label = "5n int8" if int8 else "5n"
    rng = np.random.default_rng(5)
    span = list(map(int, rng.integers(0, cfg.vocab_size, SPEC_SPAN)))
    requests = list(prompts) + [span * 4]
    common = dict(batch_size=4, eos_token=-1, decode_chunk=8)
    t_phase = time.perf_counter()

    plain = Engine(params, cfg, **common)
    plain.generate(requests, max_new_tokens=32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain.generate(requests, max_new_tokens=32)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ref_diffs = tokens_held(f"{label} plain Engine on the phase's requests, against the phase's own tokens", plain,
                            ref[: len(want)], [dataclasses.replace(r, tokens=t) for r, t in zip(ref, want)])
    del plain
    free_memory()

    dcfg = dataclasses.replace(cfg, num_layers=2)
    draft = (dataclasses.replace(params, layers=params.layers[:2]), dcfg)  # views: no copy
    runs = [("prompt lookup k=3", dict(spec_k=3), True)]
    if not int8:
        runs += [("prompt lookup k=7", dict(spec_k=7), False), ("draft model k=3", dict(spec_k=3, draft=draft), True)]
    stoch = SamplingParams(temperature=0.8, top_p=0.95)
    res, launches = {}, collections.Counter()
    for name, kw, sampled in runs:
        eng = Engine(params, cfg, **common, **kw)
        kind = SpecKind(kw["spec_k"], "draft" in kw, True)
        got, counts, tally, secs = spec_generate(f"{label} {name}", eng, requests, int8=int8)
        stats, captured = dict(eng.spec_stats), eng.graph_stats["captured"]
        check(tally["spec_chunks"] > 0 and stats["steps"] > 0, f"{label} {name}: no speculative chunk ran: {tally}")
        check(any(isinstance(key[2], SpecKind) and key[2].greedy for key in eng.state()[1].graphs),
              f"{label} {name}: no greedy speculative graph")
        diffs = tokens_held(f"{label} {name}", eng, got, ref)
        # Call 2 from the controller's starting state: the same schedule.
        eng._spec_pause = eng._spec_backoff = 0
        again, counts2, _, secs2 = spec_generate(f"{label} {name} call 2", eng, requests, int8=int8)
        check(eng.graph_stats["captured"] == captured, f"{label} {name}: call 2 captured a graph")
        check([r.tokens for r in again] == [r.tokens for r in got] and counts2 == counts,
              f"{label} {name}: call 2's tokens or launches differ from call 1's")
        for key, v in counts.items():
            launches[key] += v
        row = dict(tokens_per_round=stats["emitted"] / stats["steps"], spec_stats=stats, forwards=tally,
                   generate_s=secs, generate_again_s=secs2, generate_plain_again_s=plain_s, launches=counts,
                   graphs=dict(eng.graph_stats), token_diffs=diffs)
        if sampled:  # stochastic requests: the sampled chunks
            eng._spec_pause = eng._spec_backoff = 0
            steps0 = eng.spec_stats["steps"]
            _, counts_s, tally_s, secs_s = spec_generate(f"{label} {name} sampled", eng, requests,
                                                         sampling=stoch, int8=int8)
            check(eng.spec_stats["steps"] > steps0 and any(
                isinstance(key[2], SpecKind) and not key[2].greedy for key in eng.state()[1].graphs),
                f"{label} {name}: stochastic requests ran no sampled speculative chunk")
            for key, v in counts_s.items():
                launches[key] += v
            row.update(sampled_generate_s=secs_s, sampled_spec_steps=eng.spec_stats["steps"] - steps0,
                       sampled_forwards=tally_s)
        row["verify_round_ms"] = verify_round_ms(eng, cfg, prompts[0], kind)
        res[name] = row
        print(f"phase {label} {name}: {len(requests)} requests x 32 tokens, warm generate {secs2:.2f} s "
              f"(plain Engine {plain_s:.2f} s; first call {secs:.2f} s); {row['tokens_per_round']:.2f} tokens per "
              f"verify round over the batch ({stats['emitted']} in {stats['steps']} rounds), controller pauses "
              f"{stats['pauses']}; forwards {tally}; graphed verify round at kv_len 1536 "
              f"{row['verify_round_ms']:.2f} ms against the plain step's {step_ms:.2f} ms "
              f"({row['verify_round_ms'] / step_ms:.2f}x)"
              + (f"; sampled: {row['sampled_spec_steps']} rounds in {secs_s:.2f} s" if sampled else "")
              + f"; on {card_line()}")
        del eng
        free_memory()

    # One eager host-stepped verify round (a budget of 2) of each spec_k,
    # every kernel call held to its plain version; the verify's rows go to
    # the decode kernel (16 rows, bm 16) at spec_k 3, the prefill kernel
    # (32 rows, padded to 64) at 7.
    held = {}
    for k in (3,) if int8 else (3, 7):
        eager = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, pipeline_decode=False,
                       cuda_graphs=False, spec_k=k)
        eager.spec_min_accept = 0.0
        rows = collections.Counter()
        with kernels_held_to_plain(f"{label} eager verify k={k}") as held[k]:
            mod, attr = (i8, "_int8_matmul_kernel") if int8 else (mm, "_matmul_bf16_kernel")
            inner = getattr(mod, attr)
            setattr(mod, attr, lambda x_pad, *a: rows.update([x_pad.shape[0]]) or inner(x_pad, *a))
            try:
                eager.generate(requests[:4], max_new_tokens=2)
            finally:
                setattr(mod, attr, inner)
        verify = 4 * cfg.num_layers
        want_rows = 16 if k == 3 else 64
        check(eager.spec_stats["steps"] == 1 and rows[want_rows] == verify,
              f"{label}: the eager verify at spec_k {k} sent {dict(rows)} rows to the kernel, not {verify} calls of "
              f"{want_rows}")
        held[k] = dict(held=held[k], rows=dict(rows))
        del eager
        free_memory()
    print(f"phase {label}: done in {time.perf_counter() - t_phase:.1f} s; verify rows per kernel call "
          f"{ {k: v['rows'] for k, v in held.items()} }")
    return dict(launches), dict(runs=res, eager_held=held, plain_token_diffs=ref_diffs)


# Phase 5p: the scoring batch (8 sequences of 1024 seeded tokens), the
# prefix-cache requests' tails (one 1024-token prefix, 5b's longest
# prompt, then each its own tail), and the scores' tolerance against the
# decode path's logprobs: 2 x NEAR_TIE x max |logit| (a log-probability is
# a logit less the row's log-sum-exp, each within the near-tie scale).
SCORE_BATCH = (8, 1024)
PREFIX_TAILS = (37, 300, 64, 9, 700, 16)


def score_expected(cfg, params, seqs, batch_size) -> tuple:
    """(projection-kernel launches, kernel-C launches) of ``Engine.score``
    over ``seqs`` in batches of ``batch_size``: one forward per batch over
    a cache of its bucket T (kernel C when T >= 256 and B * H * T * T
    reaches the threshold), and a packed lm_head once per row."""
    from nf4_tpu_torch.nf4.format import PackedNF4
    from nf4_tpu_torch.ops.attention import _CHUNKED_MIN_SCORE_ELEMS
    from nf4_tpu_torch.ops.int8_serve import PackedInt8
    from nf4_tpu_torch.utils.shapes import bucket_len

    todo = [s for s in seqs if len(s) >= 2]
    head = isinstance(params.lm_head, (PackedNF4, PackedInt8))
    proj = flash = 0
    for i in range(0, len(todo), batch_size):
        batch = todo[i : i + batch_size]
        t = min(bucket_len(max(map(len, batch))), cfg.max_seq_len)
        proj += projections_per_layer(cfg) * cfg.num_layers + (len(batch) if head else 0)
        flash += cfg.num_layers * (t >= 256 and len(batch) * cfg.num_heads * t * t >= _CHUNKED_MIN_SCORE_ELEMS)
    return proj, flash


def phase_score_prefix(params, cfg, prompts, want, int8=False):
    """Main path (p): scoring and the shared-prefix cache of Llama-3-8B at
    full width and depth, on the phase's weights (5b's, or 5d's int8 ones).

    Scoring: ``Engine.score`` of the phase's requests followed by their 32
    greedy tokens (``generate(return_logprobs=True)``, held to the phase's
    own tokens), every launch count exact, each generated token's score
    within 2 x NEAR_TIE x max |logit| of its decode-path logprob; a batch of
    8 x 1024 seeded tokens (kernel C) timed, with its peak memory and
    perplexity, after a first (warm-up) call of it with every kernel B, C
    or D call held to its plain version (``kernels_held_to_plain``).  The
    prefix cache: six requests of 32 tokens through 4 slots, each the
    1024-token prompt and its own tail of ``PREFIX_TAILS`` tokens, so
    refills continue the prefix; launch counts exact (``spec_generate``);
    tokens held to the same requests without the cache (``tokens_held``);
    a request admitted mid-call into an idle slot held to its run alone; a
    second call that reuses the saved prefix with the first call's tokens;
    ``generate`` s of each call against the cache-off Engine's; then the
    six requests once more on an eager Engine with the cache, 2 tokens
    each, every kernel call held to its plain version: the prefix's
    prefill, the continuations from ``Lp`` (kernel C at buckets 512 and
    1024, the plain path below 256) and the refills' continuations, with
    the graphed call's first 2 tokens."""
    import numpy as np
    import torch

    from nf4_tpu_torch.eval.ppl import perplexity
    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import Engine

    label = "5p int8" if int8 else "5p"
    names = ("int8_matmul", "flash_attention_int8") if int8 else ("matmul_bf16", "flash_attention")
    proj_kernel = "D" if int8 else "B"
    t_phase = time.perf_counter()
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8)
    gen = eng.generate(prompts, max_new_tokens=32, return_logprobs=True)
    gen_diffs = tokens_held(f"{label} generate(return_logprobs=True) against the phase's tokens", eng, gen,
                            [dataclasses.replace(r, tokens=t) for r, t in zip(gen, want)])
    seqs = [r.prompt + r.tokens for r in gen]
    _cuda.reset_launch_counts()
    scores = eng.score(seqs)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    proj, flash = score_expected(cfg, params, seqs, eng.batch_size)
    check(counts[names[0]] == proj and counts[names[1]] == flash and sum(counts.values()) == proj + flash,
          f"{label} score launched {counts}, not {names[0]} {proj} and {names[1]} {flash}")
    logits = eng.prefill_group(init_kv_cache(cfg, 1), np.asarray([prompts[0]], np.int32),
                               np.asarray([len(prompts[0])], np.int32), np.asarray([0]))
    scale = logits.abs().max().item()
    diff = max(abs(a - b) for r, s in zip(gen, scores) for a, b in zip(s[len(r.prompt) - 1 :], r.logprobs))
    check(all(len(s) == len(q) - 1 for s, q in zip(scores, seqs)) and all(np.isfinite(s).all() for s in scores),
          f"{label}: score lengths or finite values")
    check(diff <= 2 * NEAR_TIE * scale, f"{label}: a generated token's score is {diff} from its decode logprob "
                                        f"(limit 2 x {NEAR_TIE} x max |logit| {scale})")

    rng = np.random.default_rng(16)
    batch = [list(map(int, rng.integers(0, cfg.vocab_size, SCORE_BATCH[1]))) for _ in range(SCORE_BATCH[0])]
    _cuda.reset_launch_counts()
    with kernels_held_to_plain(f"{label} 8 x 1024 score (warm-up)") as held_score:
        eng.score(batch, batch_size=SCORE_BATCH[0])
    torch.cuda.synchronize()
    held_counts = _cuda.launch_counts()
    check(held_score["C"][0] == held_counts[names[1]] == cfg.num_layers and held_score[proj_kernel][0] > 0,
          f"{label} 8 x 1024 score: calls held {held_score}, launches {held_counts}")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    batch_scores = eng.score(batch, batch_size=SCORE_BATCH[0])
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    batch_counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    proj8, flash8 = score_expected(cfg, params, batch, SCORE_BATCH[0])
    check(batch_counts[names[0]] == proj8 and batch_counts[names[1]] == flash8 == cfg.num_layers,
          f"{label} 8 x 1024 score launched {batch_counts}, not {names[0]} {proj8} and {names[1]} {flash8}")
    check(all(len(s) == SCORE_BATCH[1] - 1 and np.isfinite(s).all() for s in batch_scores),
          f"{label}: 8 x 1024 scores")
    ppl = perplexity(params, cfg, batch, batch_size=SCORE_BATCH[0])
    check(math.isfinite(ppl), f"{label}: perplexity {ppl}")
    n_tok = SCORE_BATCH[0] * (SCORE_BATCH[1] - 1)
    score = dict(launches=counts, batch_launches=batch_counts, max_logprob_diff=diff, max_abs_logit=scale,
                 batch_ms=score_s * 1e3, batch_tok_s=n_tok / score_s, batch_peak_gb=peak / 1e9,
                 batch_peak_above_engine_gb=(peak - base) / 1e9, batch_perplexity=ppl, generate_token_diffs=gen_diffs,
                 batch_held=held_score)
    print(f"phase {label} score: {len(seqs)} requests + 32 tokens, launches {counts} (kernel C on "
          f"{counts[names[1]] // cfg.num_layers} of the batches); largest |score - decode logprob| over the generated "
          f"tokens {diff:.4f} (limit {2 * NEAR_TIE * scale:.4f}, max |logit| {scale:.2f}); 8 x 1024 seeded tokens in "
          f"{score_s * 1e3:.1f} ms = {n_tok / score_s:.0f} tokens/s through kernel C ({batch_counts}), peak "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the weights and the Engine's cache), perplexity "
          f"{ppl:.1f}; on {card_line()}")

    prefix = list(prompts[0])
    tails = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in PREFIX_TAILS]
    requests = [prefix + t for t in tails]
    eng.generate(requests, max_new_tokens=32)  # the cache-off Engine's captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = eng.generate(requests, max_new_tokens=32)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    peng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, prefix_cache=True)
    got, pcounts, tally, first_s = spec_generate(f"{label} prefix", peng, requests, int8=int8)
    stats1 = dict(peng.prefix_stats)
    check(stats1 == {"prefix_len": len(prefix), "tokens_saved": len(prefix) * 5, "reused": False},
          f"{label} prefix_stats {stats1}")
    diffs = tokens_held(f"{label} prefix cache against the cache-off Engine", peng, got, off)

    late = requests[2]
    solo = eng.generate([late], max_new_tokens=32)
    calls = []

    def admit(features):
        calls.append(features["prefix"] == tuple(prefix))
        return [(late, None, None)] if len(calls) == 3 else []

    admit.peek = lambda: len(calls) < 3
    adm = peng.generate(requests[:2], max_new_tokens=32, admit=admit)
    check(len(adm) == 3 and len(calls) >= 3 and all(calls), f"{label}: the admitted request ({len(calls)} polls)")
    adm_diffs = tokens_held(f"{label} request admitted into an idle slot, against its run alone", peng, adm[2:], solo)

    again, counts2, tally2, second_s = spec_generate(f"{label} prefix call 2", peng, requests, int8=int8)
    stats2 = dict(peng.prefix_stats)
    # Call 2 runs call 1's forwards but the prefix's prefill (bucket 1024).
    check(stats2["reused"] and tally2["target"] == tally["target"] - 1
          and tally2["flash_target"] == tally["flash_target"] - flash_prefills(cfg, [(1, 1024)]),
          f"{label} call 2: {stats2}, forwards {tally2} against {tally}")
    check([r.tokens for r in again] == [r.tokens for r in got], f"{label}: call 2's tokens differ from call 1's")
    del peng
    free_memory()

    eager = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, pipeline_decode=False,
                   cuda_graphs=False, prefix_cache=True)
    _cuda.reset_launch_counts()
    with kernels_held_to_plain(f"{label} eager prefix-cache call") as held_prefix:
        short = eager.generate(requests, max_new_tokens=2)
    torch.cuda.synchronize()
    eager_counts = _cuda.launch_counts()
    check(eager.prefix_stats["prefix_len"] == len(prefix) and held_prefix[proj_kernel][0] > 0
          and held_prefix["C"][0] == eager_counts[names[1]] > cfg.num_layers,
          f"{label} eager prefix-cache call: {eager.prefix_stats}, calls held {held_prefix}, launches {eager_counts} "
          f"(kernel C on the prefix's prefill and at least one continuation)")
    check([r.tokens for r in short] == [r.tokens[:2] for r in got],
          f"{label}: the eager prefix-cache call's tokens differ from the graphed call's")
    prefix_res = dict(stats_first=stats1, stats_second=stats2, launches=pcounts, forwards=tally, token_diffs=diffs,
                      admitted_token_diffs=adm_diffs, generate_first_s=first_s, generate_second_s=second_s,
                      generate_cache_off_s=off_s, eager_held=held_prefix, eager_launches=eager_counts)
    print(f"phase {label} prefix cache: {len(requests)} requests of a 1024-token prefix + tails {PREFIX_TAILS}, "
          f"32 tokens each through 4 slots: prefix_stats {stats1}, then {stats2}; launches {pcounts} for the "
          f"forwards {tally}; generate {first_s:.2f} s (prefix prefilled) and {second_s:.2f} s (reused) against "
          f"{off_s:.2f} s without the cache (warm); an admitted request into an idle slot held to its run alone; "
          f"eager call held to the plain versions ({eager_counts[names[1]] // cfg.num_layers} prefills through "
          f"kernel C); phase {time.perf_counter() - t_phase:.1f} s; on {card_line()}")
    del eng, eager
    free_memory()
    launches = {k: counts.get(k, 0) + batch_counts.get(k, 0) + pcounts.get(k, 0) + counts2.get(k, 0)
                for k in set(counts) | set(batch_counts) | set(pcounts) | set(counts2)}
    return launches, dict(score=score, prefix=prefix_res)


def phase_quality_gate():
    """Phase 7q: ``python -m nf4_tpu_torch.eval.quality_gate --corpus
    synthetic`` at its defaults, in process: a byte-level LM trained in
    place (dense fp32 weights, 600 AdamW steps), its held-out perplexity
    dense fp32 and bf16, NF4 (kernel B) and int8-recoded (kernel D); every
    perplexity finite and the NF4 delta within the gate of 0.1."""
    from nf4_tpu_torch.eval.quality_gate import quality_gate

    t0 = time.perf_counter()
    report = quality_gate(corpus="synthetic", log=sys.stdout)
    secs = time.perf_counter() - t0
    ppls = ("ppl_dense_fp32", "ppl_dense_bf16", "ppl_nf4", "ppl_nf4_int8_recode")
    check(all(math.isfinite(report[k]) for k in ppls), f"7q: a perplexity is not finite: {report}")
    check(report["gate"] == 0.1 and report["within_gate"] and abs(report["delta"]) <= 0.1,
          f"7q: the NF4 delta is outside the gate: {report}")
    print(f"phase 7q quality gate (synthetic corpus, defaults) in {secs:.1f} s: {json.dumps(report)}; on {card_line()}")
    return dict(report, seconds=secs)


# Phase 5r: the bank's adapters (ranks; all four targets, B drawn with a
# std per target, MULTI_LORA_B_STD, so the adapters change the tokens: the
# synthetic model's 32 random layers send every request to one token,
# which deltas of ~0.4x the base projections' outputs left alone on the
# card, and ~4x on o and down moved only the larger ranks'; deltas of
# ~10x on the projections that write the residual (o, down) move it,
# while q/k/v and gate/up stay small, since large ones sharpen the random
# attention until rounding decides the logits), the requests' adapters
# (5b's six prompts through 4 slots, so refills switch adapters) and the
# same mix permuted for the second call.
MULTI_LORA_RANKS = (8, 16, 16, 32)
MULTI_LORA_B_STD = {"qkv": 0.02, "o": 2.0, "gateup": 0.02, "down": 2.0}
MULTI_LORA_MIX = [None, 0, 1, 2, 3, 0]
MULTI_LORA_PERMUTED = [3, 0, None, 1, 0, 2]
MERGE_LAYERS = 4


def bank_adapters(cfg, ranks, seed=20, device="cuda"):
    """Seeded adapters on ``device``, one per rank, on all four targets: A
    from ``init_lora``, B drawn there, normal with MULTI_LORA_B_STD's std
    for its target."""
    import torch

    from nf4_tpu_torch.train import LoraConfig, init_lora

    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for j, r in enumerate(ranks):
        lora = init_lora(cfg, LoraConfig(rank=r, alpha=2.0 * r), seed=seed + j, device=device)
        with torch.no_grad():
            for ll in lora.layers:
                for name, std in MULTI_LORA_B_STD.items():
                    getattr(ll, name).b.normal_(0.0, std, generator=gen)
        out.append(lora)
    return out


def bank_decode_ms(eng, cfg, adapters, chunks=4, n=8) -> float:
    """ms per graphed, pipelined decode step at batch 4 from position 1024
    (kv_len 1536) on a Decoder of ``eng`` whose slots hold ``adapters``,
    after one untimed chunk (its capture): serve_llama's timing."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.serve.engine import Decoder, kv_bucket

    dec = Decoder(eng, init_kv_cache(cfg, 4))
    if dec.ids is not None:
        dec.set_adapters(np.asarray(adapters, np.int32))
    pos, act, cur = np.full(4, 1024, np.int64), np.ones(4, bool), np.zeros(4, np.int32)
    kv = kv_bucket(1024 + chunks * n, eng.KV_BUCKET, cfg.max_seq_len)
    dec.read(dec.launch(n, kv, cur, pos, act))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = dec.launch(n, kv, cur, pos, act)
    for _ in range(chunks - 1):
        nxt = dec.launch(n, kv)
        dec.read(h)
        h = nxt
    out = dec.read(h)
    ms = (time.perf_counter() - t0) * 1e3 / (chunks * n)
    check(kv == 1536 and out.shape == (n, 4) and ((out >= 0) & (out < cfg.vocab_size)).all(), "bank decode tokens")
    return ms


def phase_multi_lora(params, cfg, prompts, want, step_ms, int8=False):
    """Main path (r): multi-LoRA serving of Llama-3-8B at full width and
    depth on the phase's weights (5b's, or briefly 5d's int8 ones): a bank
    of 4 seeded adapters of ranks MULTI_LORA_RANKS on all four targets,
    5b's requests with adapters MULTI_LORA_MIX through 4 slots, graphed and
    pipelined, every launch count exact (``spec_generate``), the request
    without an adapter equal to the phase's own tokens, the adapters
    changing the tokens; then the mix permuted on the same Engine, which
    captures nothing.  The 4-bit mode also: each adapted request held to
    its run alone (``tokens_held`` through its adapter); an eager call of 2
    tokens with every kernel call held to its plain version; ``Engine.
    score`` through two adapters, each generated token's score within 2 x
    NEAR_TIE x max |logit| of its decode logprob, launches exact; the
    graphed decode step with the bank (slots on adapters 0-3) timed at
    kv_len 1536 against ``step_ms``; ``merge_lora`` of adapter 0 into
    MERGE_LAYERS layers on the card (kernel A, then the card quantizer),
    its first layer held to the CPU's merge."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import LlamaParams, init_kv_cache
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import Engine
    from nf4_tpu_torch.train import LoraAB, LoraLayer, LoraParams, merge_lora

    label = "5r int8" if int8 else "5r"
    t_phase = time.perf_counter()
    adapters = bank_adapters(cfg, MULTI_LORA_RANKS)
    t0 = time.perf_counter()
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, lora_bank=adapters)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    bank_bytes = sum(t.numel() * t.element_size() for ll in eng._bank.layers
                     for ab in (ll.qkv, ll.o, ll.gateup, ll.down) for t in (ab.a, ab.b))
    fp32_bytes = sum(p.numel() * p.element_size() for a in adapters for p in a.parameters())
    got, counts, tally, secs = spec_generate(f"{label} bank", eng, prompts, int8=int8, adapter=MULTI_LORA_MIX)
    captured = eng.graph_stats["captured"]
    check(got[0].tokens == want[0], f"{label}: the request without an adapter differs from the base Engine's tokens")
    changed = sum(r.tokens != w for r, w, a in zip(got, want, MULTI_LORA_MIX) if a is not None)
    moved = {a for r, w, a in zip(got, want, MULTI_LORA_MIX) if a is not None and r.tokens != w}
    check(moved == set(range(len(adapters))), f"{label}: adapters {sorted(moved)} of {len(adapters)} change the "
                                              f"tokens of a request ({changed} of 5 requests)")
    again, counts2, tally2, secs2 = spec_generate(f"{label} bank permuted", eng, prompts, int8=int8,
                                                  adapter=MULTI_LORA_PERMUTED)
    check(eng.graph_stats["captured"] == captured, f"{label}: the permuted mix captured a graph")
    none_at = MULTI_LORA_PERMUTED.index(None)
    check(again[none_at].tokens == want[none_at], f"{label}: the permuted call's request without an adapter differs")
    launches = {k: counts[k] + counts2[k] for k in counts}
    res = dict(generate_s=secs, generate_permuted_s=secs2, forwards=tally, launches=counts, changed=changed,
               bank_build_s=bank_s, bank_bytes=bank_bytes, adapters_fp32_bytes=fp32_bytes,
               graphs=dict(eng.graph_stats))
    if int8:
        print(f"phase {label}: {len(prompts)} requests x 32 tokens, adapters {MULTI_LORA_MIX} then "
              f"{MULTI_LORA_PERMUTED}: {secs:.2f} s then {secs2:.2f} s (0 captures); the request without an adapter "
              f"equal to 5d's tokens; launches {counts}; phase {time.perf_counter() - t_phase:.1f} s")
        del eng
        free_memory()
        return launches, res

    # Each adapted request against its run alone (the same Engine).
    solo, solo_ad = [], []
    for i, a in enumerate(MULTI_LORA_MIX):
        if a is not None:
            solo += eng.generate([prompts[i]], max_new_tokens=32, adapter=[a])
            solo_ad.append(a)
    adapted = [r for r, a in zip(got, MULTI_LORA_MIX) if a is not None]
    diffs = tokens_held(f"{label} adapted requests against their runs alone", eng, adapted, solo, solo_ad)

    eager = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, pipeline_decode=False,
                   cuda_graphs=False, lora_bank=adapters)
    with kernels_held_to_plain(f"{label} eager bank call") as held:
        short = eager.generate(prompts, max_new_tokens=2, adapter=MULTI_LORA_MIX)
    check([r.tokens for r in short] == [r.tokens[:2] for r in got],
          f"{label}: the eager bank call's tokens differ from the graphed call's")
    del eager
    free_memory()

    # Scoring through the bank: two requests' prompts and 32 greedy tokens.
    pick = [1, 3]
    lp = eng.generate([prompts[i] for i in pick], max_new_tokens=32, adapter=[MULTI_LORA_MIX[i] for i in pick],
                      return_logprobs=True)
    seqs = [r.prompt + r.tokens for r in lp]
    _cuda.reset_launch_counts()
    scores = eng.score(seqs, adapter=[MULTI_LORA_MIX[i] for i in pick])
    torch.cuda.synchronize()
    score_counts = _cuda.launch_counts()
    proj, flash = score_expected(cfg, params, seqs, eng.batch_size)
    check(score_counts["matmul_bf16"] == proj and score_counts["flash_attention"] == flash
          and sum(score_counts.values()) == proj + flash, f"{label} score launched {score_counts}")
    logits = eng.prefill_group(init_kv_cache(cfg, 1), np.asarray([prompts[1]], np.int32),
                               np.asarray([len(prompts[1])], np.int32), np.asarray([0]), adapter_ids=np.asarray([0]))
    scale = logits.abs().max().item()
    diffs_lp = [abs(x - y) for r, s in zip(lp, scores) for x, y in zip(s[len(r.prompt) - 1 :], r.logprobs)]
    diff = max(diffs_lp)
    check(diff <= 2 * NEAR_TIE * scale, f"{label}: a generated token's score is {diff} from its decode logprob "
                                        f"(limit 2 x {NEAR_TIE} x max |logit| {scale}; mean "
                                        f"{sum(diffs_lp) / len(diffs_lp)}, sorted {sorted(diffs_lp)[-8:]})")
    for key in launches:
        launches[key] += score_counts[key]

    bank_ms = bank_decode_ms(eng, cfg, [0, 1, 2, 3])
    base_ms = bank_decode_ms(Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8), cfg, [-1] * 4)
    del eng
    free_memory()

    # merge_lora of adapter 0 into the first MERGE_LAYERS layers on the card,
    # its first layer against the same merge on the CPU.
    sub = LlamaParams(embed=None, layers=params.layers[:MERGE_LAYERS], final_norm=None, lm_head=None)
    lora0 = LoraParams(list(adapters[0].layers[:MERGE_LAYERS]))
    cfg_m = dataclasses.replace(cfg, num_layers=MERGE_LAYERS)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    merged = merge_lora(sub, lora0, cfg_m)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merge_counts = _cuda.launch_counts()
    check(merge_counts["dequant_t"] == 4 * MERGE_LAYERS and sum(merge_counts.values()) == 4 * MERGE_LAYERS,
          f"{label} merge_lora launched {merge_counts}, not kernel A {4 * MERGE_LAYERS} times")
    cpu_sub = params_to(dataclasses.replace(sub, layers=sub.layers[:1]), "cpu")
    cpu_lora = LoraParams([LoraLayer(**{f: LoraAB(getattr(lora0.layers[0], f).a.detach().cpu(),
                                                  getattr(lora0.layers[0], f).b.detach().cpu(),
                                                  getattr(lora0.layers[0], f).scaling)
                                        for f in ("qkv", "o", "gateup", "down")})])
    t0 = time.perf_counter()
    cpu = merge_lora(cpu_sub, cpu_lora, dataclasses.replace(cfg, num_layers=1))
    cpu_s = time.perf_counter() - t0
    codes_diff, codes_total, scale_err = 0, 0, 0.0
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        a, b = getattr(merged.layers[0], name), getattr(cpu.layers[0], name)
        pa, pb = a.packed.cpu(), b.packed
        codes_diff += int(((pa & 15) != (pb & 15)).sum() + ((pa >> 4) != (pb >> 4)).sum())
        codes_total += 2 * pa.numel()
        scale_err = max(scale_err, ((a.scales.cpu() - b.scales).abs() / b.scales.abs().clamp_min(1e-30)).max().item())
    check(codes_diff <= 1e-4 * codes_total and scale_err <= 1e-6,
          f"{label} merge_lora: {codes_diff} of {codes_total} codes or scales ({scale_err}) differ from the CPU's")
    res.update(token_diffs=diffs, eager_held=held, score_launches=score_counts, score_max_diff=diff,
               decode_ms_step_bank=bank_ms, decode_ms_step_base=base_ms, decode_ms_step_5b=step_ms,
               merge_s=merge_s, merge_cpu_layer_s=cpu_s, merge_codes_diff=codes_diff,
               merge_codes_total=codes_total, merge_scale_err=scale_err, merge_launches=merge_counts)
    print(f"phase {label} multi-LoRA bank of {len(adapters)} adapters (ranks {MULTI_LORA_RANKS}, all four targets): "
          f"{bank_bytes / 1e9:.3f} GB in the serving bank (bf16; fp32 adapters {fp32_bytes / 1e9:.3f} GB), built in "
          f"{bank_s:.2f} s; {len(prompts)} requests x 32 tokens, adapters {MULTI_LORA_MIX}: {secs:.2f} s (graphs "
          f"captured {captured}), permuted {MULTI_LORA_PERMUTED}: warm {secs2:.2f} s, 0 captures; {changed} of 5 "
          f"adapted requests change the tokens, the others' equal 5b's; launches {counts} for the forwards {tally}; "
          f"score of 2 requests: largest |score - decode logprob| {diff:.4f} (limit {2 * NEAR_TIE * scale:.4f}); "
          f"graphed decode step at kv_len 1536 with the slots on adapters 0-3 {bank_ms:.2f} ms against "
          f"{base_ms:.2f} ms without the bank here and 5b's {step_ms:.2f} ms; merge_lora of adapter 0 into "
          f"{MERGE_LAYERS} layers {merge_s * 1e3:.0f} ms (kernel A {merge_counts['dequant_t']} launches, the card "
          f"quantizer), layer 0 against the CPU merge ({cpu_s:.1f} s): {codes_diff} of {codes_total} codes differ, "
          f"scales within {scale_err:.1e}; phase {time.perf_counter() - t_phase:.1f} s; on {card_line()}")
    launches["dequant_t"] += merge_counts["dequant_t"]
    del merged, adapters
    free_memory()
    return launches, res


# Phase 6d: the families that only served before, 2 layers each at full
# width: Gemma-2-9B (a local and a global layer, both softcaps), Gemma-3-4B
# (two local layers: their own RoPE) and Mixtral-8x7B (LoRA on attention
# only, the frozen experts' gradient through kernel A).
TRAIN_FAMILIES = {  # label: (config name, seed, LoRA targets)
    "Gemma-2-9B": ("gemma2-9b", 11, ("wqkv", "wo", "w_gateup", "w_down")),
    "Gemma-3-4B": ("gemma3-4b", 12, ("wqkv", "wo", "w_gateup", "w_down")),
    "Mixtral-8x7B": ("mixtral-8x7b", 13, ("wqkv", "wo")),
}
FAMILY_LAYERS = 2


def phase_train_families(examples):
    """Main path (6d): 3 bf16 AdamW steps (lr 1e-4, ``remat=True``) of rank-16
    QLoRA on each of TRAIN_FAMILIES at full width and FAMILY_LAYERS layers,
    on 6b's packed examples (2 x 512 slots, mapped into the vocabulary),
    each step's launches exact (kernel B once per projection of the
    forward and of its recompute, kernel A once per projection in the
    backward but layer 0's wqkv), the losses finite and the step-0 loss
    held to the inference forward's (``reference_loss``); then the
    trained Gemma-2 adapter served from a bank beside the base for 8
    tokens, launches exact and tokens equal to an eager Engine's."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import Engine
    from nf4_tpu_torch.train import LoraConfig, init_lora, make_train_step, pack_sft

    t_phase = time.perf_counter()
    res, total = {}, {name: 0 for name in _cuda.KERNELS}
    trained = None
    for label, (name, seed, targets) in TRAIN_FAMILIES.items():
        cfg = dataclasses.replace(configs.get_config(name), num_layers=FAMILY_LAYERS, max_seq_len=8192)
        params = synthetic_params(cfg, seed=seed)
        ex = [([t % cfg.vocab_size for t in p], [t % cfg.vocab_size for t in c]) for p, c in examples]
        batch = pack_sft(ex, 512)
        tok, mask, pos, seg = batch_to(batch, "cuda")
        lora = init_lora(cfg, LoraConfig(rank=16, alpha=32.0, targets=targets), seed=seed)
        opt = torch.optim.AdamW(lora.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        step = make_train_step(cfg, opt, remat=True)
        ref = reference_loss(params, cfg, ex)
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
        per_layer = projections_per_layer(cfg)
        want = {k: 0 for k in _cuda.KERNELS}
        want.update(matmul_bf16=2 * per_layer * cfg.num_layers, dequant_t=per_layer * cfg.num_layers - 1)
        check(all(math.isfinite(v) for v in losses), f"6d {label}: losses {losses}")
        for c in counts:
            check(c == want, f"6d {label}: launches per step {c}, expected {want}")
            for k in c:
                total[k] += c[k]
        check(abs(losses[0] - ref) <= 2e-2, f"6d {label}: step-0 loss {losses[0]} against the inference forward's {ref}")
        step_ms = sum(secs[1:]) / 2 * 1e3
        res[label] = dict(losses=losses, ref_loss=ref, step_ms=step_ms, peak_gb=peak / 1e9,
                          launches_per_step=counts[0], step_times_ms=[v * 1e3 for v in secs])
        print(f"phase 6d QLoRA {label} bf16 ({cfg.num_layers} layers at full width, rank 16 on {targets}, 2 x 512 "
              f"packed): losses {losses}; step-0 loss against the inference forward {ref:.6f}; step times "
              f"{[round(v * 1e3, 1) for v in secs]} ms, {step_ms:.1f} ms/step; peak memory {peak / 1e9:.2f} GB; "
              f"launches per step {counts[0]}; on {card_line()}")
        if label == "Gemma-2-9B":
            prompts = [ex[0][0] + ex[0][1], ex[1][0]]
            eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, lora_bank=[lora])
            plain = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, lora_bank=[lora],
                           cuda_graphs=False, pipeline_decode=False)
            got, served, tally, serve_s = spec_generate("6d Gemma-2-9B trained adapter", eng, prompts, budget=8,
                                                        adapter=[0, None])
            check([r.tokens for r in got] == [r.tokens for r in plain.generate(prompts, max_new_tokens=8,
                                                                                adapter=[0, None])],
                  "6d: the trained adapter's graphed tokens differ from eager decode")
            for k in served:
                total[k] += served[k]
            trained = dict(generate_s=serve_s, launches=served, forwards=tally)
            print(f"phase 6d Gemma-2-9B trained adapter served from a bank beside the base: 2 requests x 8 tokens in "
                  f"{serve_s:.2f} s, launches {served}, tokens equal to eager decode")
            del eng, plain
        del params, lora, opt, step
        free_memory()
    print(f"phase 6d: done in {time.perf_counter() - t_phase:.1f} s")
    return total, dict(families=res, served=trained)


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
    proj, flash = serve_expected(cfg)
    check(counts["int8_matmul"] == proj and counts["flash_attention_int8"] == flash,
          f"int8 serving launched kernel D and C-int8 {counts['int8_matmul']} and "
          f"{counts['flash_attention_int8']} times, not {proj} and {flash}: {counts}")
    check(counts["matmul_bf16"] == 0 and counts["flash_attention"] == 0,
          f"int8 serving launched a 4-bit or bf16-KV kernel: {counts}")
    check(abs(serving["kv_cache_gb"] - kv8 / 1e9) < 1e-9, "KV cache size")
    spec_counts, spec = phase_spec(params, cfg, prompts, serving["tokens"], serving["decode_ms_step"], int8=True)
    score_counts, score_prefix = phase_score_prefix(params, cfg, prompts, serving["tokens"], int8=True)
    lora_counts, multi_lora = phase_multi_lora(params, cfg, prompts, serving["tokens"], serving["decode_ms_step"],
                                               int8=True)
    more = dict(recode_s=recode_s, spec=spec, score_prefix=score_prefix, multi_lora=multi_lora)
    return counts, dict(serving, **more), spec_counts, score_counts, lora_counts


@contextlib.contextmanager
def plain_attention(matmul=False, fp32=False):
    """Within it, kernel C's wrapper runs its plain version on the card, so a
    forward's attention takes the plain path with the same dispatch (with
    ``fp32``, on q, k and v in fp32, its output rounded to bf16); with
    ``matmul`` kernels B's and D's wrappers run their plain versions too."""
    from nf4_tpu_torch.ops import attention
    from nf4_tpu_torch.ops import int8_serve as i8
    from nf4_tpu_torch.ops import matmul as mm

    saved = attention._flash_kernel, mm._matmul_bf16_kernel, i8._int8_matmul_kernel
    if fp32:
        attention._flash_kernel = lambda q, k, v, *a: attention._flash_plain(q.float(), k.float(), v.float(),
                                                                              *a).to(q.dtype)
    else:
        attention._flash_kernel = attention._flash_plain
    if matmul:
        mm._matmul_bf16_kernel, i8._int8_matmul_kernel = mm._matmul_bf16_plain, i8._int8_matmul_plain
    try:
        yield
    finally:
        attention._flash_kernel, mm._matmul_bf16_kernel, i8._int8_matmul_kernel = saved


@contextlib.contextmanager
def kernels_held_to_plain(label, experts=0):
    """Within it (eager work only: each check reads its result on the
    host), kernel B, C and D calls are held to their plain versions on
    the same operands, the main path's own (expert views of a stacked
    weight, padded K, each layer's window and cache): B and D within 2e-2
    * max|out| per call, as phase 3, each operand shape on its first
    2 * max(experts, 1) calls (every expert of two layers); C on every call
    within 2e-2 * max|out| of each query position (over heads and dims),
    so that a wrong window at a late position, whose outputs average many
    values and are small, still shows.  The kernel's output goes on, so
    the tokens are the kernel path's.  Yields {kernel: [calls held,
    largest err / limit]}, printed at the end."""
    from nf4_tpu_torch.ops import attention
    from nf4_tpu_torch.ops import int8_serve as i8
    from nf4_tpu_torch.ops import matmul as mm

    saved = attention._flash_kernel, mm._matmul_bf16_kernel, i8._int8_matmul_kernel
    held = {"B": [0, 0.0], "C": [0, 0.0], "D": [0, 0.0]}
    seen = {}

    def note(name, err, limit, where):
        check(err <= limit, f"{label}: kernel {name} {where} against its plain version: max abs err {err}, "
                            f"limit {limit}")
        held[name][0] += 1
        held[name][1] = max(held[name][1], err / limit)

    def projection(name, kern, plain):
        def run(x_pad, w, scales, out_dtype, *more):
            out = kern(x_pad, w, scales, out_dtype, *more)
            key = (tuple(x_pad.shape), tuple(w.shape), out_dtype)
            seen[name, key] = seen.get((name, key), 0) + 1
            if seen[name, key] <= 2 * max(experts, 1):
                want = plain(x_pad, w, scales, out_dtype).float()
                note(name, (out.float() - want).abs().max().item(), 2e-2 * want.abs().max().item(),
                     f"x {key[0]} w {key[1]}")
            return out
        return run

    def flash(q, k, v, pos0, seq_lens, scale, sliding_window=None, k_scale=None, v_scale=None):
        out = saved[0](q, k, v, pos0, seq_lens, scale, sliding_window, k_scale, v_scale)
        want = attention._flash_plain(q, k, v, pos0, seq_lens, scale, sliding_window, k_scale, v_scale).float()
        err = (out.float() - want).abs().amax(dim=(1, 3)).flatten()  # each (row, query position)
        limit = 2e-2 * want.abs().amax(dim=(1, 3)).flatten()
        at = int((err / limit.clamp_min(1e-30)).argmax())
        note("C", err[at].item(), limit[at].item(), f"q {tuple(q.shape)} window {sliding_window} at query {at}")
        return out

    attention._flash_kernel = flash
    mm._matmul_bf16_kernel = projection("B", saved[1], mm._matmul_bf16_plain)
    i8._int8_matmul_kernel = projection("D", saved[2], i8._int8_matmul_plain)
    try:
        yield held
    finally:
        attention._flash_kernel, mm._matmul_bf16_kernel, i8._int8_matmul_kernel = saved
    print(f"phase {label} kernel calls held to their plain versions on the same operands (calls, largest err / "
          f"limit): {', '.join(f'{k} {n} {r:.3f}' for k, (n, r) in held.items() if n)}")


def prefill_against_plain(label, eng, prompt, matmul=False, int8=False) -> float:
    """The last-position logits of ``prompt``'s prefill through the engine,
    against the same prefill with kernel C (and with ``matmul`` kernel B,
    or with ``int8`` kernel D) replaced by its plain version on the card:
    max abs diff at most 2e-2 * max|logit| (bf16 outputs summed in another
    order, through every layer).  Kernel C runs once per layer in the first
    where the prompt's prefill takes it (``flash_prefills``), never in the
    second; with ``matmul`` the projection kernel runs once per projection
    and layer in the first, never in the second."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import init_kv_cache
    from nf4_tpu_torch.ops import _cuda

    cfg = eng.cfg
    c_name = "flash_attention_int8" if cfg.kv_quant else "flash_attention"
    p_name, p_label = ("int8_matmul", "D") if int8 else ("matmul_bf16", "B")
    flash_layers = flash_prefills(cfg, [(1, len(prompt))]) * cfg.num_layers
    toks, lens, slots = np.asarray([prompt], np.int32), np.asarray([len(prompt)], np.int32), np.asarray([0])
    runs = []
    for plain in (False, True):
        cache = init_kv_cache(cfg, 1)
        _cuda.reset_launch_counts()
        if plain:
            with plain_attention(matmul):
                logits = eng.prefill_group(cache, toks, lens, slots)
        else:
            logits = eng.prefill_group(cache, toks, lens, slots)
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        runs.append((logits.float(), counts[c_name], counts[p_name]))
    (got, n_kernel, b_kernel), (want, n_plain, b_plain) = runs
    check(n_kernel == flash_layers and n_plain == 0,
          f"{label}: kernel C launched {n_kernel} / {n_plain} times, not {flash_layers} / 0")
    if matmul:
        b_want = projections_per_layer(cfg) * cfg.num_layers
        check(b_kernel == b_want and b_plain == 0,
              f"{label}: kernel {p_label} launched {b_kernel} / {b_plain} times, not {b_want} / 0")
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    what = "attention and projections" if matmul else "attention"
    check(bool(torch.isfinite(got).all()) and diff <= 2e-2 * scale,
          f"{label}: prefill logits against the plain {what} path {diff} at scale {scale}")
    print(f"phase {label} prefill of {len(prompt)} tokens, last-position logits against the plain {what} path "
          f"on the card: max abs diff {diff:.2e} (limit 2e-2 x max |logit| {scale:.2f}); kernel C launched "
          f"{n_kernel} times, 0 on the plain path" + (f"; kernel {p_label} {b_kernel} times, 0 on the plain path"
                                                       if matmul else ""))
    return diff


def phase_qwen2_serving(prompts, profile):
    """Main path (f): greedy serving of Qwen2-7B at full width and depth
    (28 heads over 4 KV heads: G = 7; q/k/v biases), as phase 5b."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.serve.engine import Engine

    cfg = configs.QWEN2_7B
    params = synthetic_params(cfg, seed=3)
    torch.cuda.synchronize()
    packed = projection_bytes(params)
    print(f"phase 5f Qwen2-7B synthetic params (full width and depth, attn_bias): {packed / 1e9:.3f} GB "
          f"packed+scales")
    head = params.lm_head.numel() * params.lm_head.element_size()
    counts, serving = serve_llama("5f", params, cfg, prompts, packed + head, profile, by_bucket=False)
    proj, flash = serve_expected(cfg)
    check(counts["matmul_bf16"] == proj and counts["flash_attention"] == flash,
          f"Qwen2-7B serving launched kernels B and C {counts['matmul_bf16']} and {counts['flash_attention']} "
          f"times, not {proj} and {flash}: {counts}")
    serving["prefill_logits_diff"] = prefill_against_plain("5f Qwen2-7B", Engine(params, cfg, cuda_graphs=False),
                                                           prompts[0])
    return counts, serving


GEMMA_LAYERS = 8


def phase_gemma(rng):
    """Main path (g): Gemma-7B at full width (D = 256, GeGLU, (1 + w) norms,
    scaled embeddings) and GEMMA_LAYERS of its 28 layers: a 1024-token
    prefill through kernel C against the plain attention path, then 8
    greedy tokens from the engine with every kernel-C launch counted."""
    import dataclasses

    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.ops import _cuda
    from nf4_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(configs.GEMMA_7B, num_layers=GEMMA_LAYERS)
    params = synthetic_params(cfg, seed=4)
    prompt = list(map(int, rng.integers(0, cfg.vocab_size, 1024)))
    print(f"phase 5g Gemma-7B synthetic params: full width (hidden {cfg.hidden_size}, {cfg.num_heads} heads of "
          f"D={cfg.head_dim}, ffn {cfg.intermediate_size}, vocab {cfg.vocab_size}), depth cut to "
          f"{cfg.num_layers} of 28 layers")
    eng = Engine(params, cfg, batch_size=1, eos_token=-1)
    diff = prefill_against_plain("5g Gemma-7B", eng, prompt)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate([prompt], max_new_tokens=8)[0]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    check(len(out.tokens) == 8 and all(0 <= t < cfg.vocab_size for t in out.tokens), "8 Gemma tokens")
    check(counts["flash_attention"] == cfg.num_layers and counts["matmul_bf16"] > 0,
          f"Gemma-7B generate launched kernel C {counts['flash_attention']} times, not {cfg.num_layers}: {counts}")
    print(f"phase 5g Gemma-7B generate: 1 request x 8 tokens in {gen_s:.2f} s; launches {counts}")
    return counts, dict(prefill_logits_diff=diff, generate_s=gen_s, layers=cfg.num_layers)


def attention_drift(label, eng, prompts) -> list:
    """The last-position logits of each prompt's prefill through the engine
    three ways on the card: through kernel C, through its plain version,
    and through its plain version on q, k, v in fp32 (the output rounded
    to bf16).  Printed, not checked (``kernels_held_to_plain`` holds each
    kernel C call): the distance between the two plain paths, which differ
    only in the rounding of attention, witnesses how far such a difference
    alone carries through the model's layers."""
    import numpy as np
    import torch

    from nf4_tpu_torch.models.llama import init_kv_cache

    out = []
    for prompt in prompts:
        toks, lens, slots = np.asarray([prompt], np.int32), np.asarray([len(prompt)], np.int32), np.asarray([0])
        runs = []
        for how in ("kernel", "plain", "fp32"):
            with plain_attention(fp32=how == "fp32") if how != "kernel" else contextlib.nullcontext():
                runs.append(eng.prefill_group(init_kv_cache(eng.cfg, 1), toks, lens, slots).float())
            torch.cuda.synchronize()
        got, plain, fp32 = runs
        check(all(bool(torch.isfinite(r).all()) for r in runs), f"{label}: finite prefill logits")
        out.append(dict(kernel_vs_plain=(got - plain).abs().max().item(),
                        kernel_vs_fp32=(got - fp32).abs().max().item(),
                        plain_vs_fp32=(plain - fp32).abs().max().item(), scale=fp32.abs().max().item()))
    print(f"phase {label} prefills of {len(prompts[0])} tokens, last-position logits, max abs diff (kernel C path "
          f"vs plain, vs plain in fp32; plain vs plain in fp32; max |logit|): "
          + "; ".join(f"{r['kernel_vs_plain']:.3f}, {r['kernel_vs_fp32']:.3f}; {r['plain_vs_fp32']:.3f}; "
                      f"{r['scale']:.2f}" for r in out))
    return out


def generate_counted(label, eng, prompts, forwards, groups, budget=32, eager=None, int8=False):
    """One ``generate`` of ``prompts`` on ``eng`` with every launch count set
    to 0 just before and read just after, held to exactly ``forwards``
    forwards' projection launches and kernel C's launches for the prefill
    ``groups``; with ``eager`` (an Engine without graphs) the tokens are
    held to its unpipelined run of the same requests, in which every kernel
    call is held to its plain version (``kernels_held_to_plain``).
    Returns (counts, results, seconds, {kernel: [calls held, largest err /
    limit]} or None)."""
    import torch

    from nf4_tpu_torch.ops import _cuda

    cfg = eng.cfg
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(prompts, max_new_tokens=budget)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    check(all(len(r.tokens) == budget and all(0 <= t < cfg.vocab_size for t in r.tokens) for r in results),
          f"{label}: {budget} tokens in the vocabulary per request")
    proj, flash = serve_expected(cfg, forwards, groups)
    b_name, c_name = ("int8_matmul", "flash_attention_int8") if int8 else ("matmul_bf16", "flash_attention")
    check(counts[b_name] == proj and counts[c_name] == flash,
          f"{label}: launched {b_name} {counts[b_name]} and {c_name} {counts[c_name]} times, not {proj} and "
          f"{flash}: {counts}")
    held = None
    if eager is not None:
        with kernels_held_to_plain(label, cfg.num_experts) as held:
            want = eager.generate(prompts, max_new_tokens=budget)
        check([r.tokens for r in results] == [r.tokens for r in want],
              f"{label}: graphed, pipelined tokens differ from eager, unpipelined decode")
    return counts, results, secs, held


# Phase 5i's long prompt: past Gemma-2-9B's 4096-slot window, so the local
# layers mask; bucket 8192, prefilled in 4 segments of 2048, then 31
# decode steps: 35 forwards, all on the plain attention paths (softcap).
GEMMA2_LONG = 4608
# Depth cuts that keep the script inside its time: Gemma-2-9B (42 layers),
# Gemma-3-4B (34: two of its 5-local-to-1-global patterns) and Mixtral-8x7B
# (32) at full width; Llama-3-70B (phase 5t) shows the full-depth fit.
GEMMA2_LAYERS, GEMMA3_LAYERS, MIXTRAL_LAYERS = 10, 12, 8


def phase_gemma2_serving(prompts, rng, profile):
    """Main path (i): greedy serving of Gemma-2-9B at full width and
    GEMMA2_LAYERS of its 42 layers (D = 256, attention and final softcaps,
    a 4096 window on every other layer, four-norm blocks) as phase 5b, every launch count
    exact (kernel C never: the softcap keeps every prefill plain); one
    prompt of GEMMA2_LONG tokens, its tokens held to eager decode; the
    1024-token prefill held to the plain attention and projection path."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(configs.GEMMA2_9B, num_layers=GEMMA2_LAYERS)
    params = synthetic_params(cfg, seed=6)
    torch.cuda.synchronize()
    packed = projection_bytes(params)
    head = params.lm_head.numel() * params.lm_head.element_size()
    print(f"phase 5i Gemma-2-9B synthetic params (full width, {cfg.num_layers} of 42 layers, D={cfg.head_dim}, "
          f"softcaps {cfg.attn_logit_softcapping} / {cfg.final_logit_softcapping}, window {cfg.sliding_window} on "
          f"every other layer): {packed / 1e9:.3f} GB packed+scales, lm_head {head / 1e9:.3f} GB")
    prompts = in_vocab(prompts, cfg)
    counts, serving = serve_llama("5i", params, cfg, prompts, packed + head, profile, by_bucket=False)
    proj, flash = serve_expected(cfg)
    check(flash == 0 and counts["matmul_bf16"] == proj and counts["flash_attention"] == 0,
          f"Gemma-2-9B serving launched kernels B and C {counts['matmul_bf16']} and {counts['flash_attention']} "
          f"times, not {proj} and 0: {counts}")
    common = dict(batch_size=4, eos_token=-1, decode_chunk=8)
    eng = Engine(params, cfg, **common)
    plain = Engine(params, cfg, pipeline_decode=False, cuda_graphs=False, **common)
    long_prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, GEMMA2_LONG)]
    long_counts, _, long_s, _ = generate_counted("5i long prompt", eng, [long_prompt], 35, [(1, 2048)] * 4,
                                                 eager=plain)
    print(f"phase 5i Gemma-2-9B prompt of {GEMMA2_LONG} tokens (bucket 8192, 4 segments), 32 tokens: "
          f"{long_s:.2f} s, tokens equal to eager decode; launches {long_counts}")
    serving["prefill_logits_diff"] = prefill_against_plain(
        "5i Gemma-2-9B", Engine(params, cfg, cuda_graphs=False), prompts[0], matmul=True)
    serving["long_prompt_s"] = long_s
    return {k: counts[k] + long_counts[k] for k in counts}, serving


DRIFT_PROMPTS = 4  # phase 5j's 2048-token prompts for attention_drift


def phase_gemma3_serving(prompts, rng, profile):
    """Main path (j): greedy serving of Gemma-3-4B at full width and
    GEMMA3_LAYERS of its 34 layers (5 local of window 1024 with their own
    RoPE to 1 global, q/k norms, D = 256), max_seq_len cut from 32768 to 8192, as phase 5b; a
    prompt of 1536 tokens (bucket 2048: kernel C on every layer, windowed on
    the local ones), its tokens held to eager decode in which each layer's
    kernel C call is held to its plain version; the logits of
    DRIFT_PROMPTS 2048-token prefills through kernel C, the plain path and
    the plain path in fp32 (``attention_drift``)."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(configs.GEMMA3_4B, num_layers=GEMMA3_LAYERS, max_seq_len=8192)
    params = synthetic_params(cfg, seed=7)
    torch.cuda.synchronize()
    packed = projection_bytes(params)
    head = params.lm_head.numel() * params.lm_head.element_size()
    print(f"phase 5j Gemma-3-4B synthetic params (full width, {cfg.num_layers} of 34 layers, max_seq_len cut to "
          f"{cfg.max_seq_len}): "
          f"{packed / 1e9:.3f} GB packed+scales, lm_head {head / 1e9:.3f} GB")
    prompts = in_vocab(prompts, cfg)
    counts, serving = serve_llama("5j", params, cfg, prompts, packed + head, profile, by_bucket=False)
    proj, flash = serve_expected(cfg)
    check(counts["matmul_bf16"] == proj and counts["flash_attention"] == flash,
          f"Gemma-3-4B serving launched kernels B and C {counts['matmul_bf16']} and {counts['flash_attention']} "
          f"times, not {proj} and {flash}: {counts}")
    eng = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8)
    plain = Engine(params, cfg, batch_size=4, eos_token=-1, decode_chunk=8, pipeline_decode=False, cuda_graphs=False)
    long_prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 1536)]
    long_counts, _, long_s, held = generate_counted("5j 1536-token prompt", eng, [long_prompt], 32, [(1, 2048)],
                                                    eager=plain)
    check(long_counts["flash_attention"] == held["C"][0] == cfg.num_layers,
          f"kernel C on every layer of the 2048 bucket, each call held to its plain version: {held}")
    print(f"phase 5j Gemma-3-4B prompt of 1536 tokens (bucket 2048), 32 tokens: {long_s:.2f} s, tokens equal to "
          f"eager decode; launches {long_counts}")
    drift_prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 2048)] for _ in range(DRIFT_PROMPTS)]
    serving["held_1536"] = held
    serving["attention_drift"] = attention_drift("5j Gemma-3-4B", plain, drift_prompts)
    return {k: counts[k] + long_counts[k] for k in counts}, serving


def phase_mixtral_serving(prompts, profile):
    """Main path (k): greedy serving of Mixtral-8x7B at full width and
    MIXTRAL_LAYERS of its 32 layers (8 experts, top-2), max_seq_len cut
    from 32768 to 8192, as phase 5b: 18 projection launches per layer and
    forward."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params

    cfg = dataclasses.replace(configs.MIXTRAL_8X7B, num_layers=MIXTRAL_LAYERS, max_seq_len=8192)
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=8)
    torch.cuda.synchronize()
    packed = projection_bytes(params)
    experts = sum(w.nbytes for lp in params.layers for w in (lp.w_gateup, lp.w_down))
    head = params.lm_head.numel() * params.lm_head.element_size()
    print(f"phase 5k Mixtral-8x7B synthetic params (full width, {cfg.num_layers} of 32 layers, {cfg.num_experts} "
          f"experts, top-{cfg.experts_per_token}; max_seq_len cut to {cfg.max_seq_len}): {packed / 1e9:.3f} GB "
          f"packed+scales "
          f"({experts / 1e9:.3f} GB of it experts), lm_head {head / 1e9:.3f} GB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = in_vocab(prompts, cfg)
    counts, serving = serve_llama("5k", params, cfg, prompts, packed + head, profile, by_bucket=False)
    proj, flash = serve_expected(cfg)
    check(counts["matmul_bf16"] == proj and counts["flash_attention"] == flash,
          f"Mixtral-8x7B serving launched kernels B and C {counts['matmul_bf16']} and {counts['flash_attention']} "
          f"times, not {proj} and {flash}: {counts}")
    return counts, dict(serving, weight_gb=packed / 1e9)


def phase_llama70b_serving(prompts, profile):
    """Main path (t): greedy serving of Llama-3-70B at full width and depth
    (80 layers, 64 heads over 8 KV heads, max_seq_len 8192) on its 4-bit
    weights, as phase 5b: every launch count exact (kernel B 67 x 4 x 80,
    kernel C 3 x 80), tokens held to eager, unpipelined decode, each kernel
    B and C call of the eager run held to its plain version, a warm call
    capturing nothing; then the 1024-token prefill and decode at batch 4
    timed, with at most two 4-slot caches alive at once.  Prints the memory
    allocated before the weights, their build seconds and bytes, and the
    peak beside the card's total."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.synthetic import synthetic_params

    cfg = configs.LLAMA3_70B
    free_memory()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = synthetic_params(cfg, seed=10)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - before
    packed = projection_bytes(params)
    head = params.lm_head.numel() * params.lm_head.element_size()
    print(f"phase 5t Llama-3-70B synthetic params (full width and depth: {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_heads} heads over {cfg.num_kv_heads}; max_seq_len {cfg.max_seq_len}; 4-bit): "
          f"{before / 1e9:.3f} GB allocated before; built in {build_s:.1f} s: {weights / 1e9:.3f} GB of weights, "
          f"{packed / 1e9:.3f} GB of it packed+scales, lm_head {head / 1e9:.3f} GB")
    counts, serving = serve_llama("5t", params, cfg, prompts, packed + head, profile, by_bucket=False)
    proj, flash = serve_expected(cfg)
    check((proj, flash) == (21440, 240), f"serve_expected(LLAMA3_70B) is {proj}, {flash}, not 21440, 240")
    check(counts["matmul_bf16"] == proj and counts["flash_attention"] == flash,
          f"Llama-3-70B serving launched kernels B and C {counts['matmul_bf16']} and {counts['flash_attention']} "
          f"times, not {proj} and {flash}: {counts}")
    total = torch.cuda.mem_get_info()[1]
    check(serving["peak_gb"] * 1e9 < total, f"5t peak {serving['peak_gb']} GB over the card's {total / 1e9} GB")
    print(f"phase 5t Llama-3-70B peak memory {serving['peak_gb']:.2f} GB of the card's {total / 1e9:.2f} GB; "
          f"kernel B {counts['matmul_bf16']} and C {counts['flash_attention']} launches, as expected; {card_line()}")
    return counts, dict(serving, weight_gb=weights / 1e9, packed_gb=packed / 1e9, build_s=build_s,
                        allocated_before_gb=before / 1e9, card_total_gb=total / 1e9)


QWEN3_MOE_LAYERS = 2


def phase_qwen3_moe(prompts):
    """Main path (l): Qwen3-30B-A3B at full width (128 experts, top-8, q/k
    norms, expert width 768, K padded to 1024) and QWEN3_MOE_LAYERS of its
    48 layers: phase 5b's requests in the 4-bit mode and in the int8 mode
    (every expert recoded, an int8 KV cache), graphed and pipelined, every
    launch count exact (258 projection launches per layer and forward),
    tokens held to eager, unpipelined decode in which each kernel call is
    held to its plain version; the 1024-token prefill's logits held to the
    plain attention and projection path."""
    import torch

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models.llama import recode_params_int8
    from nf4_tpu_torch.models.synthetic import synthetic_params
    from nf4_tpu_torch.serve.engine import Engine

    res, all_counts = {}, {}
    for mode in ("4-bit", "int8"):
        cfg = dataclasses.replace(configs.QWEN3_MOE_A3B, num_layers=QWEN3_MOE_LAYERS, kv_quant=mode == "int8")
        params = synthetic_params(cfg, seed=9)
        if mode == "int8":
            params = recode_params_int8(params)
        torch.cuda.synchronize()
        nbytes = projection_bytes(params)
        common = dict(batch_size=4, eos_token=-1, decode_chunk=8)
        eng = Engine(params, cfg, **common)
        plain = Engine(params, cfg, pipeline_decode=False, cuda_graphs=False, **common)
        label, int8 = f"5l Qwen3-30B-A3B {mode}", mode == "int8"
        counts, _, secs, held = generate_counted(label, eng, in_vocab(prompts, cfg), SERVE_FORWARDS, SERVE_PREFILLS,
                                                 eager=plain, int8=int8)
        other = "matmul_bf16" if int8 else "int8_matmul"
        check(counts[other] == 0, f"5l {mode} launched {other}: {counts}")
        check(held["D" if int8 else "B"][0] > 0 and held["B" if int8 else "D"][0] == 0,
              f"5l {mode}: the projection kernel held {held}")
        diff = prefill_against_plain(label, plain, in_vocab(prompts, cfg)[0], matmul=True, int8=int8)
        print(f"phase 5l Qwen3-30B-A3B {mode} ({cfg.num_layers} of 48 layers, {cfg.num_experts} experts, top-"
              f"{cfg.experts_per_token}; {nbytes / 1e9:.3f} GB of projections): {len(prompts)} requests x 32 tokens in "
              f"{secs:.2f} s, tokens equal to eager decode; graphs {eng.graph_stats['captured']} captured in "
              f"{eng.graph_stats['capture_s']:.2f} s; launches {counts}")
        res[mode] = dict(generate_s=secs, graph_stats=dict(eng.graph_stats), weight_gb=nbytes / 1e9, held=held,
                         prefill_logits_diff=diff)
        all_counts[mode] = counts
        del params, eng, plain
        free_memory()
    return all_counts, res


# Phase 5m: Llama-3-8B at full width from HF checkpoint directories written
# here, depth cut to CKPT_LAYERS of its 32 layers (disk and time); the bnb
# directory holds the first BNB_LAYERS of the same layers.
CKPT_LAYERS, BNB_LAYERS = 4, 2
# An HF Llama layer's tensors (their shapes from the config), by HF name.
HF_PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj", "mlp.gate_proj",
           "mlp.up_proj", "mlp.down_proj")


def hf_config(cfg, num_layers, bnb=False) -> dict:
    """``cfg`` as an HF ``config.json`` (HF field names); ``bnb`` adds the
    quantization_config transformers writes for a bnb NF4 checkpoint."""
    hf = dict(model_type="llama", architectures=["LlamaForCausalLM"], vocab_size=cfg.vocab_size,
              hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size, num_hidden_layers=num_layers,
              num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps, max_position_embeddings=cfg.max_seq_len,
              hidden_act="silu", tie_word_embeddings=False, torch_dtype="bfloat16")
    if bnb:
        hf["quantization_config"] = dict(quant_method="bitsandbytes", load_in_4bit=True, load_in_8bit=False,
                                         bnb_4bit_quant_type="nf4", bnb_4bit_use_double_quant=True,
                                         bnb_4bit_compute_dtype="bfloat16")
    return hf


def hf_layer_shapes(cfg) -> dict:
    h, inter = cfg.hidden_size, cfg.intermediate_size
    shapes = [(cfg.q_dim, h), (cfg.kv_dim, h), (cfg.kv_dim, h), (h, cfg.q_dim), (inter, h), (inter, h), (h, inter)]
    out = {f"{name}.weight": shape for name, shape in zip(HF_PROJ, shapes)}
    out.update({"input_layernorm.weight": (h,), "post_attention_layernorm.weight": (h,)})
    return out


def write_dense_hf(path, cfg, seed) -> int:
    """A dense bf16 HF checkpoint directory of ``cfg`` (``CKPT_LAYERS``
    layers, an untied lm_head) drawn on the card from ``seed``, in two
    safetensors files with layer 1 split across them (its attention in the
    first, its MLP in the second).  Returns one layer's dense bytes."""
    import os

    import torch
    from safetensors.torch import save_file

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, std=0.02, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(torch.bfloat16).cpu()

    h = cfg.hidden_size
    first = {"model.embed_tokens.weight": draw((cfg.vocab_size, h))}
    second = {"lm_head.weight": draw((cfg.vocab_size, h)), "model.norm.weight": draw((h,), 0.1, 1.0)}
    for i in range(CKPT_LAYERS):
        for name, shape in hf_layer_shapes(cfg).items():
            t = draw(shape, 0.1, 1.0) if len(shape) == 1 else draw(shape)
            into_first = i < 1 or (i == 1 and (name.startswith("self_attn") or name.startswith("input")))
            (first if into_first else second)[f"model.layers.{i}.{name}"] = t
    for k, part in enumerate((first, second)):
        save_file(part, os.path.join(path, f"model-{k + 1:05d}-of-00002.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg, CKPT_LAYERS), f)
    return sum(math.prod(s) * 2 for s in hf_layer_shapes(cfg).values())


def bnb_tensors(prefix, state) -> dict:
    """One QuantState as transformers serializes a bnb ``Linear4bit``
    (``QuantState.as_dict(packed=True)``): the packed weight, absmax, the
    4-bit and the nested code tables, nested absmax and the JSON blob."""
    import numpy as np
    import torch

    from nf4_tpu_torch.nf4.lut import dynamic_code, get_code

    meta = dict(quant_type=state.quant_type, blocksize=int(state.blocksize), dtype="bfloat16",
                shape=list(state.shape), nested_blocksize=int(state.blocksize2), nested_dtype="float32",
                nested_offset=float(state.offset))
    arrays = {
        prefix: np.asarray(state.packed, np.uint8).reshape(-1, 1),
        f"{prefix}.absmax": np.asarray(state.absmax_u8, np.uint8),
        f"{prefix}.nested_absmax": np.asarray(state.absmax32, np.float32),
        f"{prefix}.nested_quant_map": dynamic_code().astype(np.float32),
        f"{prefix}.quant_map": get_code(state.quant_type).astype(np.float32),
        f"{prefix}.quant_state.bitsandbytes__{state.quant_type}": np.frombuffer(json.dumps(meta).encode(), np.uint8),
    }
    return {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}


def _same_packed(a, b) -> bool:
    import torch

    return (a.shape == b.shape and a.padded_shape == b.padded_shape and torch.equal(a.packed.cpu(), b.packed.cpu())
            and torch.equal(a.scales.cpu().view(torch.int32), b.scales.cpu().view(torch.int32)))


def phase_hf_checkpoint(prompts):
    """Main path (m): Llama-3-8B at full width and CKPT_LAYERS of its 32
    layers from an HF checkpoint directory: a dense bf16 one (two files,
    layer 1 across them) quantized on the card as it loads, its layers 0-1
    held against the NumPy oracle on the same fused weights byte for byte,
    ``peak_dense_bytes`` at most one layer's; a bnb NF4 one of the same
    weights for layers 0-1, quantized per projection by the oracle with
    double-quantized statistics as Hub checkpoints are, repacked on load:
    every packed byte equal to the card's, every scale to the oracle's; the
    midpoint stress tensor on the card against the oracle, NF4 and FP4;
    then phase 5b's requests on the loaded params in the 4-bit and the int8
    mode, every launch count exact, tokens held to eager decode in which
    every kernel call is held to its plain version."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from safetensors import safe_open
    from safetensors.torch import save_file

    from nf4_tpu_torch.models import configs
    from nf4_tpu_torch.models import loader
    from nf4_tpu_torch.models.llama import fuse_rows, recode_params_int8
    from nf4_tpu_torch.nf4 import fast_quant
    from nf4_tpu_torch.nf4.fast_quant import midpoint_stress
    from nf4_tpu_torch.nf4.format import pack_codes_for_tpu, qdense_from_state, quantize_for_tpu
    from nf4_tpu_torch.nf4.reference import quantize_nf4
    from nf4_tpu_torch.serve.engine import Engine

    card = card_line()
    want_cfg = dataclasses.replace(configs.LLAMA3_8B, num_layers=CKPT_LAYERS)
    res = {}
    pool = ThreadPoolExecutor(max_workers=7)
    with tempfile.TemporaryDirectory() as tmp:
        dense_dir, bnb_dir = os.path.join(tmp, "dense"), os.path.join(tmp, "bnb")
        os.mkdir(dense_dir)
        os.mkdir(bnb_dir)
        t0 = time.perf_counter()
        layer_bytes = write_dense_hf(dense_dir, want_cfg, seed=14)
        res["write_s"] = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(dense_dir, f)) for f in os.listdir(dense_dir))

        # Load and quantize on the card, each layer's quantize timed and,
        # within it, the host statistics (the oracle's functions).
        layer_s, host_s, quantize = [], [], loader.quantize_layer
        host_fns = fast_quant.quantize_blockwise_u8, fast_quant.dequantize_absmax

        def on_host(fn):
            def run(*a):
                t = time.perf_counter()
                out = fn(*a)
                host_s[-1] += time.perf_counter() - t
                return out
            return run

        def timed(lw, cfg, device=None):
            torch.cuda.synchronize()
            host_s.append(0.0)
            t = time.perf_counter()
            out = quantize(lw, cfg, device)
            torch.cuda.synchronize()
            layer_s.append(time.perf_counter() - t)
            return out

        stats = {}
        loader.quantize_layer = timed
        fast_quant.quantize_blockwise_u8, fast_quant.dequantize_absmax = map(on_host, host_fns)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, cfg = loader.load_hf_llama(dense_dir, stats=stats)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            loader.quantize_layer = quantize
            fast_quant.quantize_blockwise_u8, fast_quant.dequantize_absmax = host_fns
        check(cfg == want_cfg, f"5m: config.json read as {cfg}, not Llama-3-8B at {CKPT_LAYERS} layers")
        check(len(layer_s) == CKPT_LAYERS and stats["peak_dense_bytes"] <= layer_bytes,
              f"5m: peak_dense_bytes {stats['peak_dense_bytes']} over one layer's {layer_bytes}")
        check(params.layers[0].wqkv.packed.is_cuda and params.embed.is_cuda, "5m: params on the card")
        res.update(load_s=load_s, disk_gb=disk / 1e9, layer_ms=[t * 1e3 for t in layer_s],
                   host_statistics_ms=[t * 1e3 for t in host_s],
                   quantize_gb_s=layer_bytes / (sum(layer_s) / len(layer_s)) / 1e9, **stats,
                   layer_dense_bytes=layer_bytes)
        print(f"phase 5m Llama-3-8B HF directory ({CKPT_LAYERS} of 32 layers, full width; {disk / 1e9:.2f} GB bf16 in 2 "
              f"files, written in {res['write_s']:.1f} s): load_hf_llama on the card {load_s:.2f} s; quantize per "
              f"layer {', '.join(f'{t * 1e3:.1f}' for t in layer_s)} ms ({res['quantize_gb_s']:.2f} GB/s of dense "
              f"bf16), of which the host statistics {', '.join(f'{t * 1e3:.1f}' for t in host_s)} ms; "
              f"peak_dense_bytes {stats['peak_dense_bytes']} (one layer {layer_bytes}); {card}")

        # The bnb directory and the oracle on the same weights, layers 0-1.
        dense = {}
        for fname in sorted(os.listdir(dense_dir)):
            if fname.endswith(".safetensors"):
                with safe_open(os.path.join(dense_dir, fname), framework="pt") as f:
                    dense.update({k: f.get_tensor(k) for k in f.keys()})
        per_proj = {f"model.layers.{i}.{p}.weight": dense[f"model.layers.{i}.{p}.weight"]
                    for i in range(BNB_LAYERS) for p in HF_PROJ}

        def oracle_state(t):
            return quantize_nf4(t.float().numpy(), dtype=np.float16)

        t0 = time.perf_counter()
        states = dict(zip(per_proj, pool.map(oracle_state, per_proj.values())))
        res["oracle_per_projection_s"] = time.perf_counter() - t0
        tensors = {k: v for k, v in dense.items() if not k.startswith("model.layers.")
                   or int(k.split(".")[2]) < BNB_LAYERS and k not in per_proj}
        for key, st in states.items():
            tensors.update(bnb_tensors(key, st))
        keys = sorted(tensors)
        for k, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):  # groups across the files
            save_file({n: tensors[n] for n in part}, os.path.join(bnb_dir, f"model-{k + 1:05d}-of-00002.safetensors"))
        with open(os.path.join(bnb_dir, "config.json"), "w") as f:
            json.dump(hf_config(want_cfg, BNB_LAYERS, bnb=True), f)
        del tensors
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params_b, cfg_b = loader.load_hf_llama(bnb_dir)
        torch.cuda.synchronize()
        res["repack_load_s"] = time.perf_counter() - t0
        check(cfg_b == dataclasses.replace(want_cfg, num_layers=BNB_LAYERS), f"5m: bnb config {cfg_b}")

        # The oracle on the fused weights the card quantized.
        fused = {}
        for i in range(BNB_LAYERS):
            w = lambda p: dense[f"model.layers.{i}.{p}.weight"]  # noqa: E731
            fused.update({(i, "wqkv"): fuse_rows([w("self_attn.q_proj"), w("self_attn.k_proj"), w("self_attn.v_proj")]),
                          (i, "wo"): w("self_attn.o_proj"),
                          (i, "w_gateup"): fuse_rows([w("mlp.gate_proj"), w("mlp.up_proj")]),
                          (i, "w_down"): w("mlp.down_proj")})
        t0 = time.perf_counter()
        oracle = dict(zip(fused, pool.map(lambda t: quantize_for_tpu(t, method="oracle", device="cpu"),
                                          fused.values())))
        res["oracle_fused_s"] = time.perf_counter() - t0
        # The C++ host quantizer on the largest of those weights: the
        # oracle's bytes and the card's.
        w_gu = fused[(0, "w_gateup")]
        t0 = time.perf_counter()
        nat = quantize_for_tpu(w_gu, method="native", device="cpu")
        res["native_w_gateup_s"] = time.perf_counter() - t0
        check(_same_packed(nat, oracle[(0, "w_gateup")]) and _same_packed(params.layers[0].w_gateup, nat),
              "5m: the native quantizer differs from the oracle or the card at layer 0 w_gateup")
        print(f"phase 5m native quantizer (C++ on the host), layer 0 w_gateup {tuple(w_gu.shape)}: "
              f"{res['native_w_gateup_s']:.2f} s = {w_gu.numel() / res['native_w_gateup_s'] / 1e6:.1f} M "
              f"elements/s; its bytes equal the oracle's and the card's")
        del dense, fused, nat, w_gu
        for (i, name), want in oracle.items():
            got = getattr(params.layers[i], name)
            check(_same_packed(got, want), f"5m: the card quantizer differs from the oracle at layer {i} {name} "
                                           f"{got.shape}")
            rep = getattr(params_b.layers[i], name)
            check(rep.shape == got.shape and torch.equal(rep.packed, got.packed),
                  f"5m: the bnb repack's bytes differ from the card's at layer {i} {name}")
        for i in range(BNB_LAYERS):
            qd = lambda p: qdense_from_state(states[f"model.layers.{i}.{p}.weight"])  # noqa: E731
            for name, parts in (("wqkv", ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")),
                                ("wo", ("self_attn.o_proj",)), ("w_gateup", ("mlp.gate_proj", "mlp.up_proj")),
                                ("w_down", ("mlp.down_proj",))):
                q = fuse_rows([qd(p) for p in parts])
                check(_same_packed(getattr(params_b.layers[i], name), pack_codes_for_tpu(q.codes, q.scales)),
                      f"5m: the bnb repack differs from the oracle's states at layer {i} {name}")
        del params_b, oracle, states
        print(f"phase 5m bnb NF4 directory (layers 0-{BNB_LAYERS - 1}, double-quantized statistics, groups across 2 "
              f"files): oracle per projection {res['oracle_per_projection_s']:.1f} s and on the fused weights "
              f"{res['oracle_fused_s']:.1f} s (7 threads); repack load {res['repack_load_s']:.2f} s; the card's "
              f"packed bytes and scales equal the oracle's at wqkv, wo, w_gateup, w_down of layers 0-1, the "
              f"repack's bytes equal the card's and its scales the oracle's per projection; {card}")

    # The midpoint stress tensor: normalized values on every decision
    # midpoint and one ulp either side; each method timed on it.
    rates = {}
    for qt in ("nf4", "fp4"):
        w = torch.from_numpy(midpoint_stress(4096, 4096, qt, seed=1))
        out = {}
        for method, where in (("device", "cuda"), ("oracle", "cpu"), ("native", "cpu")):
            quantize_for_tpu(w[:128], method=method, quant_type=qt, device=where)  # warm: build, load, caches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[method] = quantize_for_tpu(w, method=method, quant_type=qt, device=where)
            torch.cuda.synchronize()
            rates[f"{qt}_{method}"] = w.numel() / (time.perf_counter() - t0)
        check(_same_packed(out["device"], out["oracle"]),
              f"5m: the card quantizer differs from the oracle on the {qt} midpoint stress tensor")
        check(_same_packed(out["native"], out["oracle"]),
              f"5m: the native quantizer differs from the oracle on the {qt} midpoint stress tensor")
    pool.shutdown()
    res["elements_per_s"] = rates
    print("phase 5m midpoint stress 4096 x 4096, NF4 and FP4: the card's and the native quantizer's bytes equal "
          "the oracle's; M elements/s " + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in rates.items())
          + f"; {card}")

    counts = {}
    for mode in ("4-bit", "int8"):
        p, c = (params, cfg) if mode == "4-bit" else (recode_params_int8(params), dataclasses.replace(cfg, kv_quant=True))
        common = dict(batch_size=4, eos_token=-1, decode_chunk=8)
        eng = Engine(p, c, **common)
        plain = Engine(p, c, pipeline_decode=False, cuda_graphs=False, **common)
        label = f"5m Llama-3-8B from HF {mode}"
        counts[mode], _, secs, held = generate_counted(label, eng, prompts, SERVE_FORWARDS, SERVE_PREFILLS,
                                                       eager=plain, int8=mode == "int8")
        print(f"phase {label} ({CKPT_LAYERS} layers): {len(prompts)} requests x 32 tokens in {secs:.2f} s, tokens "
              f"equal to eager decode; launches {counts[mode]}")
        res[f"generate_s_{mode}"] = secs
        del eng, plain, p
        free_memory()
    return counts, res


SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=256)


_GEMMA = dict(head_dim=256, activation="gelu_tanh", rmsnorm_one_plus=True, scale_embeddings=True)
_MOE = dict(num_experts=4, experts_per_token=2)
# Phase 5c's variants of the small model: every field of the Llama-family
# variants, Gemma-2's and Gemma-3's on; dense projections; MoE both ways of
# renormalizing, in fp32 activations (kernel E on the experts: a bf16
# route can flip between two programs whose sums differ in order; the bf16
# MoE MLP is held at module level, phase_small_model).
SMALL_VARIANTS = {
    "bias, qk_norm, llama3 rope": dict(attn_bias=True, qk_norm=True, rope_scaling=("llama3", 8.0, 1.0, 4.0, 64)),
    "Gemma flags, D=256": _GEMMA,
    "Gemma-2: softcaps, output norms, window on every other layer": dict(
        _GEMMA, attn_logit_softcapping=50.0, final_logit_softcapping=30.0, query_pre_attn_scalar=256.0,
        sliding_window=48, sliding_window_pattern=2),
    "Gemma-3: local RoPE, qk_norm, windows": dict(
        _GEMMA, qk_norm=True, rope_theta=1e6, rope_local_theta=1e4, rope_scaling=("linear", 8.0), sliding_window=48,
        sliding_window_pattern=2),
    "quantize=False (dense projections)": dict(quantize=False),
    "MoE, moe_norm_topk, fp32": dict(_MOE, dtype="float32"),
    "MoE, moe_norm_topk=False, fp32": dict(_MOE, moe_norm_topk=False, dtype="float32"),
}


def phase_small_model(dev, rng):
    """Main path (c): a small model on the card against the same weights on
    the CPU, plain and with the variants' fields on; the MoE MLP alone in
    bf16 (4-bit and int8 experts), card against CPU on the same input."""
    import torch

    from nf4_tpu_torch.models.llama import LlamaConfig, _moe_mlp, prefill, recode_params_int8
    from nf4_tpu_torch.models.synthetic import synthetic_params

    for name, fields in {"": {}, **SMALL_VARIANTS}.items():
        if isinstance(fields.get("dtype"), str):
            fields = dict(fields, dtype=getattr(torch, fields["dtype"]))
        small = LlamaConfig(**{**SMALL, **fields})
        p_gpu = synthetic_params(small, seed=1)
        p_cpu = params_to(p_gpu, "cpu")
        tk = torch.as_tensor(rng.integers(0, 512, (2, 100)), dtype=torch.int32)
        lg, _ = prefill(p_gpu, small, tk.to(dev))
        lc, _ = prefill(p_cpu, small, tk)
        diff = (lg.cpu() - lc).abs().max().item()
        scale = lc.abs().max().item()
        check(bool(torch.isfinite(lg).all()) and diff <= 2e-2 * scale,
              f"small model {name}: card vs CPU {diff} at scale {scale}")
        print(f"phase 5c small model{f' ({name})' if name else ''} logits, card vs CPU plain path: max abs diff "
              f"{diff:.2e} (max |logit| {scale:.2f})")
    for int8 in (False, True):
        for norm in (True, False):
            small = LlamaConfig(**{**SMALL, **_MOE, "moe_norm_topk": norm})
            p_gpu = synthetic_params(small, seed=2)
            if int8:
                p_gpu = recode_params_int8(p_gpu)
            p_cpu = params_to(p_gpu, "cpu")
            x = torch.randn((2, 100, small.hidden_size)).to(torch.bfloat16)
            got = _moe_mlp(small, x.to(dev), p_gpu.layers[0]).cpu()
            want = _moe_mlp(small, x, p_cpu.layers[0])
            diff, scale = (got - want).abs().max().item(), want.abs().max().item()
            check(diff <= 2e-2 * scale, f"MoE MLP {'int8' if int8 else '4-bit'} norm {norm}: card vs CPU {diff}")
            print(f"phase 5c MoE MLP alone, bf16 x [2, 100], {'int8' if int8 else '4-bit'} experts, moe_norm_topk "
                  f"{norm}: card vs CPU max abs diff {diff:.2e} (max |out| {scale:.2e})")


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
    """Main path (6s): one fp32 training step of a small model on the card
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
    print(f"phase 6s small model fp32 train step, card vs CPU plain path: loss {loss:.6f} vs {want_loss:.6f}; "
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
    t_start = last = time.perf_counter()
    laps = {}

    def lap(name):
        """Print the seconds since the last lap (and since the start)."""
        nonlocal last
        now = time.perf_counter()
        laps[name] = now - last
        print(f"elapsed: phases {name} {now - last:.1f} s (total {now - t_start:.1f} s)")
        last = now

    t0 = time.perf_counter()
    reports = _cuda.build()
    print(f"phase 1 built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if any(w in line for w in ("registers", "spill", "arning", "serialized")):
                print(f"  ptxas {name}: {line.strip()}")

    from nf4_tpu_torch import diagnostics

    t0 = time.perf_counter()
    diag_rc = diagnostics.main()
    check(diag_rc == 0, f"the diagnostics exited {diag_rc}: {diagnostics.failures}")
    print(f"phase 1d diagnostics (python -m nf4_tpu_torch.diagnostics): exit 0, every check passed, in "
          f"{time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    deq = phase_dequant(gen, dev)
    fast = phase_dequant(gen, dev, fast=True)
    mm = phase_matmul(gen, dev)
    mm8 = phase_matmul(gen, dev, int8=True)
    ex, ex_decode = phase_exact(gen, dev)
    fl = phase_flash(gen, dev)
    fl8 = phase_flash(gen, dev, int8=True)
    fls = phase_flash_shapes(gen, dev)
    lap("1-4")

    import numpy as np

    rng = np.random.default_rng(0)
    dequant_counts, fast_counts = phase_dequant_api(dev, rng)
    from nf4_tpu_torch.models.configs import LLAMA3_8B

    prompts = [list(map(int, rng.integers(0, LLAMA3_8B.vocab_size, n))) for n in (1024, 37, 300, 64, 700, 9)]
    lap("5a")
    l70_counts, llama70b = phase_llama70b_serving(prompts, args.profile)
    free_memory()
    lap("5t")
    serve_counts, serving, params = phase_serving(prompts, args.profile)
    lap("5b")
    http_counts, http = phase_http_serving(params, prompts, serving["tokens"], args.profile)
    lap("5h")
    spec_counts, spec = phase_spec(params, LLAMA3_8B, prompts, serving["tokens"], serving["decode_ms_step"])
    lap("5n")
    score_counts, score_prefix = phase_score_prefix(params, LLAMA3_8B, prompts, serving["tokens"])
    lap("5p")
    lora_counts, multi_lora = phase_multi_lora(params, LLAMA3_8B, prompts, serving["tokens"],
                                               serving["decode_ms_step"])
    lap("5r")
    del params
    free_memory()
    phase_small_model(dev, rng)
    lap("5c")
    int8_counts, serving8, spec8_counts, score8_counts, lora8_counts = phase_int8_serving(prompts, args.profile)
    lap("5d (with 5n, 5p and 5r int8)")
    phase_checkpoint(dev, rng)
    qwen_counts, serving_qwen = phase_qwen2_serving(prompts, args.profile)
    free_memory()
    lap("5e, 5f")
    gemma_counts, gemma = phase_gemma(rng)
    free_memory()
    lap("5g")
    gemma2_counts, gemma2 = phase_gemma2_serving(prompts, rng, args.profile)
    free_memory()
    lap("5i")
    gemma3_counts, gemma3 = phase_gemma3_serving(prompts, rng, args.profile)
    free_memory()
    lap("5j")
    mixtral_counts, mixtral = phase_mixtral_serving(prompts, args.profile)
    free_memory()
    lap("5k")
    moe_counts, qwen3_moe = phase_qwen3_moe(prompts)
    free_memory()
    lap("5l")
    hf_counts, hf_ckpt = phase_hf_checkpoint(prompts)
    free_memory()
    lap("5m")
    phase_backward(gen, dev)
    # 7 examples of 60-200 tokens that pack into 2 x 512 slots (97.8% full).
    examples = sft_examples(np.random.default_rng(0), LLAMA3_8B.vocab_size, 7, 60, 200)
    train16 = phase_training("6b", "bf16", examples, args.profile)
    train32 = phase_training("6c", "fp32", examples, args.profile)
    check(train32["launches_per_step"]["matmul_bf16"] == 0 and train16["launches_per_step"]["matmul_exact"] == 0,
          "kernel E only in fp32, kernel B only in bf16")
    lap("6a-6c")
    family_counts, families = phase_train_families(examples)
    lap("6d")
    phase_train_small(rng)
    phase_resume(rng)
    free_memory()
    gate = phase_quality_gate()
    lap("6s, 6e, 7q")

    def decode_layer(res):  # one decode layer's four projections at B=4
        return [res[(name, 4)] for name in LLAMA3_8B_PROJ]

    def matmul_row(name, source, replaces, res, launches, prefill=False, **more):
        rows = decode_layer(res)
        row = dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches, **more,
                   max_abs_err=max(r["max_abs_err"] for r in res.values()),
                   ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                   bound_ms=sum(r["bound_ms"] for r in rows), bound_by="bytes",
                   library_ms=sum(r["library_ms"] for r in rows))
        if prefill:  # one prefill layer's four projections at B=1024
            pre = [res[(n, 1024)] for n in LLAMA3_8B_PROJ]
            row.update(prefill_ms=sum(r["ms"] for r in pre), prefill_bound_ms=sum(r["bound_ms"] for r in pre),
                       prefill_library_ms=sum(r["library_ms"] for r in pre))
        shapes = {f"llama3-70b {k[0][4:]} B={k[1]}": {f: r[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                                          "bound_by", "max_abs_err")}
                  for k, r in res.items() if k[0].startswith("70b ")}
        if shapes:
            row["shapes"] = shapes
        return row

    def flash_row(name, res, launches, int8=False, **more):
        return dict(name=name, route="cuda", source="nf4_tpu_torch/csrc/flash_attn.cu",
                    replaces="nf4_tpu/ops/attention.py:371", launches=launches,
                    max_abs_err=max(r["max_abs_err"] for r in res.values()), ms=res["causal"]["ms"],
                    plain_ms=res["causal"]["plain_ms"], bound_ms=res["causal"]["bound_ms"],
                    bound_by="operations", library_ms=res["causal"]["library_ms"],
                    window_ms=res["window"]["ms"], window_bound_ms=res["window"]["bound_ms"],
                    window_library_ms=res["window"]["library_ms"], shapes=flash_shape_rows(fls, int8), **more)

    kernels = [
        dict(name="dequant_t", route="cuda", source="nf4_tpu_torch/csrc/dequant.cu",
             replaces="nf4_tpu/ops/dequant.py:86", launches=dequant_counts["dequant_t"],
             multi_lora_launches=lora_counts["dequant_t"], train_families_launches=family_counts["dequant_t"],
             max_abs_err=deq["max_abs_err"], ms=deq["w_down"]["ms"], plain_ms=deq["w_down"]["plain_ms"],
             bound_ms=deq["w_down"]["bound_ms"], bound_by="bytes", library_ms=None),
        matmul_row("matmul_bf16", "nf4_tpu_torch/csrc/matmul.cu", "nf4_tpu/ops/matmul.py:148", mm,
                   serve_counts["matmul_bf16"], prefill=True, http_launches=http_counts["matmul_bf16"],
                   spec_launches=spec_counts["matmul_bf16"], score_prefix_launches=score_counts["matmul_bf16"],
                   gemma2_9b_launches=gemma2_counts["matmul_bf16"], gemma3_4b_launches=gemma3_counts["matmul_bf16"],
                   mixtral_8x7b_launches=mixtral_counts["matmul_bf16"],
                   llama3_70b_launches=l70_counts["matmul_bf16"],
                   qwen3_30b_a3b_launches=moe_counts["4-bit"]["matmul_bf16"],
                   hf_checkpoint_launches=hf_counts["4-bit"]["matmul_bf16"],
                   multi_lora_launches=lora_counts["matmul_bf16"],
                   train_families_launches=family_counts["matmul_bf16"]),
        flash_row("flash_attention", fl, serve_counts["flash_attention"],
                  qwen2_7b_launches=qwen_counts["flash_attention"], gemma_7b_launches=gemma_counts["flash_attention"],
                  http_launches=http_counts["flash_attention"], gemma2_9b_launches=gemma2_counts["flash_attention"],
                  spec_launches=spec_counts["flash_attention"],
                  score_prefix_launches=score_counts["flash_attention"],
                  gemma3_4b_launches=gemma3_counts["flash_attention"],
                  mixtral_8x7b_launches=mixtral_counts["flash_attention"],
                  llama3_70b_launches=l70_counts["flash_attention"],
                  qwen3_30b_a3b_launches=moe_counts["4-bit"]["flash_attention"],
                  multi_lora_launches=lora_counts["flash_attention"],
                  train_families_launches=family_counts["flash_attention"]),
        flash_row("flash_attention_int8", fl8, int8_counts["flash_attention_int8"], int8=True,
                  spec_launches=spec8_counts["flash_attention_int8"],
                  score_prefix_launches=score8_counts["flash_attention_int8"],
                  qwen3_30b_a3b_launches=moe_counts["int8"]["flash_attention_int8"],
                  multi_lora_launches=lora8_counts["flash_attention_int8"],
                  train_families_launches=family_counts["flash_attention_int8"]),
        matmul_row("int8_matmul", "nf4_tpu_torch/csrc/int8_matmul.cu", "nf4_tpu/ops/int8_serve.py:151", mm8,
                   int8_counts["int8_matmul"], prefill=True, spec_launches=spec8_counts["int8_matmul"],
                   score_prefix_launches=score8_counts["int8_matmul"],
                   qwen3_30b_a3b_launches=moe_counts["int8"]["int8_matmul"],
                   hf_checkpoint_launches=hf_counts["int8"]["int8_matmul"],
                   multi_lora_launches=lora8_counts["int8_matmul"],
                   train_families_launches=family_counts["int8_matmul"]),
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
             bound_by="operations",
             **{f"decode_{k}": sum(ex[(n, 4)][k] for n in LLAMA3_8B_PROJ)
                for k in ("ms", "fp16_ms", "bound_ms", "library_ms")},
             decode_device_launches_per_call=ex_decode["device_launches_per_call"],
             f64_err=max(r["f64_err"] for r in ex.values()),
             library_f64_err=max(r["library_f64_err"] for r in ex.values())),
    ]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, dequant=deq, fast_dequant=fast,
                           matmul={f"{k[0]} B={k[1]}": v for k, v in mm.items()},
                           int8_matmul={f"{k[0]} B={k[1]}": v for k, v in mm8.items()},
                           exact_matmul={f"{k[0]} B={k[1]}": v for k, v in ex.items()}, exact_decode=ex_decode,
                           flash=fl, flash_int8=fl8, flash_shapes=fls, serving=serving, serving_int8=serving8,
                           serving_qwen2_7b=serving_qwen, gemma_7b=gemma, http_serving=http, speculative=spec,
                           serving_gemma2_9b=gemma2, serving_gemma3_4b=gemma3, serving_mixtral_8x7b=mixtral,
                           serving_llama3_70b=llama70b,
                           qwen3_30b_a3b=qwen3_moe, hf_checkpoint=hf_ckpt, score_prefix=score_prefix,
                           quality_gate=gate, multi_lora=multi_lora, train_families=families, phase_seconds=laps,
                           training_bf16=train16, training_fp32=train32, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
