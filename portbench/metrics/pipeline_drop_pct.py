"""pipeline_drop_pct (scheduler, serve/engine.py): decode chunks dropped over
chunks launched ahead of a read-back, in the window, from the Engine's
``pipeline_stats``; nothing when none was launched ahead."""


def read(run):
    p = run.window.pipeline()
    if p["launched"] <= 0:
        return None
    return 100.0 * p["discarded"] / p["launched"]
