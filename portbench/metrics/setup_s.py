"""setup_s: seconds from the process's start to the window's start (the
kernels' load or build, the weights drawn on the card, the Engine, the cell's
warm shapes and graphs, the untimed ramp); host clock."""


def read(run):
    return run.setup_s
