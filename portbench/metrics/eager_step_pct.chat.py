"""eager_step_pct (scheduler, serve/engine.py): the decode steps of the
program's decode records in the traced slice that no CUDA graph ran, over
all their steps (progtrace.py); 0 when every step was graphed."""

from portbench import progtrace


def read(run):
    return progtrace.eager_step_pct(run)
