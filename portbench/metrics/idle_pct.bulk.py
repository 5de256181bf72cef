"""Share of the traced sub-window in which no kernel, copy or memset ran
on the device (bulk cells)."""


def read(run):
    t = run.trace_summary
    if t is None or "call" not in run.spans or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
