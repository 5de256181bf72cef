"""Median host time of one engine call measured inside the program: the
``engine.infer_padded`` spans that ``repro_torch.tracing`` records in the
traced sub-window (``call_ms.bulk`` is the harness's own clock around the
same call, in the untraced part)."""

import statistics


def _calls():
    try:
        from repro_torch import tracing
    except ImportError:         # a program without the tracer
        return []
    return [s for s in tracing.spans()
            if s.name == "engine.infer_padded" and s.end_ns is not None]


def read(run):
    calls = _calls()
    if not calls:
        return None
    return statistics.median(s.end_ns - s.start_ns for s in calls) * 1e-6
