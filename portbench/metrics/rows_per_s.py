"""Rows classified per second: every row whose prediction and class sums
came back to host memory, over the window from the first call to the
last result (host clock)."""


def read(run):
    if "call" not in run.spans or not run.window_s:
        return None
    return run.rows / run.window_s
