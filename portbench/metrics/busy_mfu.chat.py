"""busy_mfu.chat (model step, models/llama.py): the traced slice's model
FLOPs (work.py: the layers' and the logits' parameters x 2 per token served,
causal attention) over the device's busy seconds in the slice x 989 TFLOP/s."""

from portbench import work


def read(run):
    if run.trace is None or run.slice_work is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.slice_work.model_flops / (run.trace.busy_s * work.PEAK_BF16_FLOPS)
