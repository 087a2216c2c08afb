"""device_idle_pct (device, H100): 1 - the union of the device's busy
intervals in the traced slice over the slice's seconds, from torch.profiler's
CUDA activity."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
