"""itl_p95_ms: the 95th percentile of every gap between two consecutive
tokens of one request whose later token came inside the window, on the host
clock as ``on_token`` saw them (tokens read back together come close
together; the gap before them is the wait), each request still running at
the close adding its wait since its last token."""

from portbench import work


def read(run):
    return work.percentile(run.window.itl_ms(), 95)
