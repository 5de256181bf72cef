"""One run of one benchmark cell, and its result line.

:func:`main` is the command line (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``); :func:`run_cell` runs a
cell on a given device, which is how the CPU tests drive it.  A run:

1. finds the cell from files (:mod:`portbench.spec`);
2. hands the traffic's entry (``portbench/entries/<entry>.py``) a
   :class:`Run`; the entry sets up, warms up every shape it will use,
   measures for ``seconds`` (``setup_s`` ends where the first timed call
   starts; a ``--trace 1`` run records its last part), reads the device's memory peak, frees the program's state and
   compares what the timed path returned with the plain reference
   (:mod:`portbench.reference`);
3. reads each of the cell's metrics with its reader
   (``portbench/metrics/<name>.py``): the end-to-end ones untraced, the
   per-layer ones with ``--trace 1``;
4. checks that no module of JAX or the JAX package was loaded, and
   prints one JSON line; the numbers compared, each beside its limit,
   come last there and as the last lines on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

from . import spec
from .devtrace import TraceSummary

# whole top-level module names the run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What an entry measured and compared in one run."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: object                    # torch.device
    t0: float                         # process start, host clock
    setup_s: float | None = None
    # the untraced part of the window (the whole window with --trace 0):
    window_s: float | None = None     # first timed call to last result
    # result rows back in host memory; the entry's docstring says what a
    # row is
    rows: int = 0
    attempted: int = 0
    failed: int = 0
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [s]
    trace_summary: TraceSummary | None = None
    memory_peak_bytes: int = 0
    compared: dict = dataclasses.field(default_factory=dict)  # (value, limit)
    info: dict = dataclasses.field(default_factory=dict)

    def mark(self, name: str) -> None:
        """Note how far set-up has come (seconds since process start)."""
        self.info.setdefault("setup_marks", []).append(
            (name, time.perf_counter() - self.t0))

    @property
    def correct(self) -> bool:
        return bool(self.compared) and self.failed == 0 and all(
            v <= lim for v, lim in self.compared.values())


class Reservoir:
    """A sample of a run's answers drawn from the seed and spread over the
    whole window, however many answers it brings: answer ``i`` is kept
    while ``(i - offset) % stride == 0``, and past ``capacity`` kept the
    stride doubles and every other kept answer goes."""

    def __init__(self, capacity: int, stride: int, offset: int):
        self.capacity, self.stride, self.offset = capacity, stride, offset
        self.kept: dict = {}

    def wants(self, i: int) -> bool:
        return i >= self.offset and (i - self.offset) % self.stride == 0

    def keep(self, i: int, item) -> None:
        self.kept[i] = item
        while len(self.kept) > self.capacity:
            self.stride *= 2
            for j in [j for j in self.kept
                      if (j - self.offset) % self.stride]:
                del self.kept[j]


def seed_offset(seed: int, stride: int) -> int:
    """Where a run's sample starts, drawn from its seed."""
    import numpy as np
    return int(np.random.default_rng(int(seed)).integers(stride))


def median_ms(values) -> float | None:
    return statistics.median(values) * 1e3 if values else None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device, t0: float | None = None) -> Run:
    """Run ``cell`` once on ``device`` and compare; see the module doc."""
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=device, t0=time.perf_counter() if t0 is None else t0)
    run.mark("start")
    spec.entry_module(cell.traffic["entry"], cell.root).run(run)
    return run


def metrics(run: Run) -> dict:
    """The cell's metrics of this kind of run, by their readers; a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in run.cell.per_layer if run.trace else run.cell.end_to_end:
        value = spec.metric_reader(m["name"], run.cell.root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def result_line(run: Run, device_info: dict) -> dict:
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics(run),
            "device": dict(device_info,
                           memory_peak_bytes=run.memory_peak_bytes)}
    if run.trace and run.trace_summary is not None:
        t = run.trace_summary
        line["device"]["busy_s"] = t.busy_s
        line["device"]["window_s"] = t.window_s
        line["breakdown"] = {
            "device_ops": sorted(t.device_ops.items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(t.idle_by_host.items(),
                                key=lambda kv: -kv[1])[:10]}
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.compared.items()}
    return line


def _cache_dirs(root) -> None:
    """Kernel caches at fixed paths inside the checkout (git-ignored
    ``build/``); the port builds its own CUDA libraries into
    ``build/repro_torch``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / "portbench" / sub)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(spec.ROOT)
    cell = spec.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device=torch.device("cuda", 0), t0=t0)
    line = result_line(run, {"platform": "gpu",
                             "kind": torch.cuda.get_device_name(0),
                             "count": cell.chips})
    # after every reader has loaded and read, just before the result
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                run.info.get("setup_marks", ())),
          file=sys.stderr)
    for k, (v, lim) in run.compared.items():
        print(f"{k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
