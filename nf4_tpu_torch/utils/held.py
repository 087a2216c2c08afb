"""Every kernel A, B, C and D call held to its plain version on the same
operands, for runs on the card (``chip_smoke.py``, and the ranks of its
multi-rank phases, which import it from here).  Eager work only: each
check reads its result on the host."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["kernels_held_to_plain"]


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def kernels_held_to_plain(label, experts=0, report=True):
    """Within it (eager work only: each check reads its result on the
    host), kernel A, B, C and D calls are held to their plain versions on
    the same operands, the main path's own (expert views of a stacked
    weight, padded K, each layer's window and cache): A bit for bit (an
    exact dequantization; the backward's ``dx``) and B and D within 2e-2 *
    max|out| per call, as phase 3, each operand shape on its first 2 *
    max(experts, 1) calls (every expert of two layers); C on every call
    within 2e-2 * max|out| of each query position (over heads and dims),
    so that a wrong window at a late position, whose outputs average many
    values and are small, still shows.  The kernel's output goes on, so
    the tokens are the kernel path's.  Yields {kernel: [calls held,
    largest err / limit]} (A's limit is 0: its ratio is 0 when equal),
    printed at the end with ``report``."""
    from ..ops import attention
    from ..ops import dequant as dq
    from ..ops import int8_serve as i8
    from ..ops import matmul as mm

    saved = attention._flash_kernel, mm._matmul_bf16_kernel, i8._int8_matmul_kernel, dq._dequant_t_kernel
    held = {"A": [0, 0.0], "B": [0, 0.0], "C": [0, 0.0], "D": [0, 0.0]}
    seen = {}

    def note(name, err, limit, where):
        _check(err <= limit, f"{label}: kernel {name} {where} against its plain version: max abs err {err}, "
                            f"limit {limit}")
        held[name][0] += 1
        held[name][1] = max(held[name][1], err / limit if limit else 0.0)

    def exact(packed, scales, dtype, quant_type="nf4"):
        out = saved[3](packed, scales, dtype, quant_type)
        key = (tuple(packed.shape), dtype)
        seen["A", key] = seen.get(("A", key), 0) + 1
        if seen["A", key] <= 2 * max(experts, 1):
            want = dq._dequant_t_plain(packed, scales, dtype, quant_type)
            note("A", 0.0 if torch.equal(out, want) else (out.float() - want.float()).abs().max().item(), 0.0,
                 f"packed {key[0]} to {dtype}")
        return out

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
    dq._dequant_t_kernel = exact
    try:
        yield held
    finally:
        attention._flash_kernel, mm._matmul_bf16_kernel, i8._int8_matmul_kernel, dq._dequant_t_kernel = saved
    if report:
        print(f"phase {label} kernel calls held to their plain versions on the same operands (calls, largest err "
              f"/ limit): {', '.join(f'{k} {n} {r:.3f}' for k, (n, r) in held.items() if n)}")
