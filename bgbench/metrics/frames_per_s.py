"""Frames completed in the window, over the window (host clock): every
frame the window dispatched, from the first timed dispatch to the
completion of its last work."""


def read(run):
    return run.completed / run.window_s if run.window_s > 0 else None
