"""proj_roofline (projections, kernel B: ops/matmul.py, csrc/matmul.cu): the
least time of the traced slice's packed projections (work.py: each weight's
bytes and scales read once per forward over 3.35 TB/s, or its FLOPs over 989
TFLOP/s, the larger; an MoE layer's experts all read, their FLOPs the top-k
share) over kernel B's device seconds in the trace: its decode kernel, its
prefill kernel and the prefill's K-split sum."""

KERNEL_B = ("Nf4Decode", "Nf4Bf16", "splitk_reduce")


def read(run):
    if run.trace is None or run.slice_work is None:
        return None
    busy = run.trace.kernel_time(KERNEL_B)
    if busy <= 0 or run.slice_work.proj_least_s <= 0:
        return None
    return 100.0 * run.slice_work.proj_least_s / busy
