"""Median host time of one engine call (``infer_padded``) with its rows
resident on the card, the harness's span around it, over the untraced
part of the window."""

from portbench.harness import median_ms


def read(run):
    return median_ms(run.spans.get("call"))
