"""eager_idle_pct (scheduler, serve/engine.py): the traced slice's
device-idle time inside the launch spans of the program's ungraphed decode
records, mapped onto the device clock, over the slice's seconds
(progtrace.py); 0 when every launch was graphed."""

from portbench import progtrace


def read(run):
    return progtrace.eager_idle_pct(run)
