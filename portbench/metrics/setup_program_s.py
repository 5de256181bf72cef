"""The program's own set-up: engine layouts built, kernel libraries built
with ``nvcc`` and loaded, in seconds, from the counters of
``repro_torch.tracing`` (``engine.build_s``, ``kernel.build_s``,
``kernel.load_s``); ``import torch`` and the CUDA start are not in it."""

KEYS = ("engine.build_s", "kernel.build_s", "kernel.load_s")


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:         # a program without the tracer
        return None
    c = tracing.counters()
    if not any(k in c for k in KEYS):
        return None
    return float(sum(c.get(k, 0.0) for k in KEYS))
