"""flash_roofline (prefill attention, kernel C: ops/attention.py,
csrc/flash_attn.cu): the least time of the traced slice's prefill segments
that the program sends to kernel C (work.py: causal FLOPs of the real tokens
over 989 TFLOP/s, or q, K, V and out over 3.35 TB/s, the larger) over kernel
C's device seconds in the trace."""

KERNEL_C = ("flash_attn",)


def read(run):
    if run.trace is None or run.slice_work is None:
        return None
    busy = run.trace.kernel_time(KERNEL_C)
    if busy <= 0 or run.slice_work.flash_least_s <= 0:
        return None
    return 100.0 * run.slice_work.flash_least_s / busy
