"""mfu.batch (model step, models/llama.py): the traced slice's model FLOPs
(work.py) over the slice's wall seconds x 989 TFLOP/s."""

from portbench import work


def read(run):
    if run.trace is None or run.slice_work is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.slice_work.model_flops / (run.trace.window_s * work.PEAK_BF16_FLOPS)
