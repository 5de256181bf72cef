"""Device operations a call: every kernel, copy and memset that started in
the traced sub-window (the harness's copies back included) over the
``engine.infer_padded`` spans that ``repro_torch.tracing`` records there;
0 where no device operation is traced (the CPU)."""


def _calls():
    try:
        from repro_torch import tracing
    except ImportError:         # a program without the tracer
        return 0
    return sum(1 for s in tracing.spans()
               if s.name == "engine.infer_padded" and s.end_ns is not None)


def read(run):
    t, n = run.trace_summary, _calls()
    if t is None or not n:
        return None
    return sum(t.device_counts.values()) / n
