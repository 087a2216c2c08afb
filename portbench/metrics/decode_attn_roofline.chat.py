"""decode_attn_roofline (decode attention, ops/attention.py:decode_attention):
the least time of the traced slice's decode attention (progtrace.py: per
decode record, step and layer, each active slot's K and V up to its own
position and its q and out in bf16 over 3.35 TB/s, or 4 x head_dim x heads
FLOPs per visible key over 989 TFLOP/s, the larger) over the device's busy
time between the program's decode-attention markers in the slice."""

from portbench import progtrace


def read(run):
    return progtrace.decode_attn_roofline(run)
