"""Share of the traced sub-window the host spent inside the engine entry:
the union of the ``engine.infer_padded`` spans that ``repro_torch.tracing``
records, over the window the profiler recorded (read beside
``idle_pct.bulk``)."""


def _calls():
    try:
        from repro_torch import tracing
    except ImportError:         # a program without the tracer
        return []
    return [(s.start_ns, s.end_ns) for s in tracing.spans()
            if s.name == "engine.infer_padded" and s.end_ns is not None]


def read(run):
    t, calls = run.trace_summary, _calls()
    if t is None or not calls or t.window_s <= 0:
        return None
    inside, reach = 0, 0
    for a, b in sorted(calls):
        a = max(a, reach)
        if b > a:
            inside += b - a
        reach = max(reach, b)
    return 100.0 * inside * 1e-9 / t.window_s
