"""queue_wait_p50_ms (scheduler, serve/engine.py): the median, over the
requests due in the window, of the time from a request's due time to
``admit`` handing it to the Engine (one never handed over counts its wait
at the window's close); the harness's host clock."""

from portbench import work


def read(run):
    return work.percentile(run.window.queue_wait_ms(), 50)
