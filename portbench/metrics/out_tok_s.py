"""out_tok_s: output tokens emitted inside the window over the window's
seconds; host clock."""


def read(run):
    return run.window.tokens_in_window() / run.seconds
