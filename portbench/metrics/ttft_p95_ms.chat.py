"""ttft_p95_ms.chat (scheduler, serve/engine.py): the 95th percentile, over
every request due in the window, of the time from its due time to its first
token (an unanswered one counts the wait it has had when the window closes);
host clock.  A per-layer reading: over the ~65 requests of a chat window its
spread from seed to seed passes what an end-to-end bound may hold."""

from portbench import work


def read(run):
    return work.percentile(run.window.ttft_ms(), 95)
