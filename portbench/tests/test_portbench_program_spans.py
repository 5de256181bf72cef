"""The readers of the program's own spans and counters
(``repro_torch.tracing``): each on a synthetic run, silent with nothing to
read and right with something, and each silent where the program has no
tracer at all."""

from __future__ import annotations

import dataclasses
import sys

import pytest
import torch

from portbench import harness, spec
from portbench.devtrace import TraceSummary
from repro_torch import tracing

BENCH = spec.load_benchmark()
READERS = ("entry_ms.bulk", "host_pct.bulk", "ops_per_call.bulk",
           "setup_program_s")
MS = 1_000_000


def read(name: str, run) -> float | None:
    return spec.metric_reader(name)(run)


def synthetic_run(window_s: float | None = 0.01, device_ops: int = 0):
    cell = spec.find_cell("tm-mnist-50.bulk", bench=BENCH)
    run = harness.Run(cell=cell, seed=1, seconds=1.0, trace=True,
                      device=torch.device("cpu"), t0=0.0)
    if window_s is not None:
        run.trace_summary = TraceSummary(
            busy_s=0.0, window_s=window_s, device_ops={},
            device_counts={"k": device_ops} if device_ops else {},
            idle_by_host={})
    return run


def call(start_ms: float, end_ms: float, call_id: int) -> tracing.Span:
    return tracing.Span("engine.infer_padded", int(start_ms * MS),
                        int(end_ms * MS), -1, 1, call_id, None)


def child(name: str, start_ms: float, end_ms: float, parent: int,
          call_id: int) -> tracing.Span:
    return tracing.Span(name, int(start_ms * MS), int(end_ms * MS), parent,
                        1, call_id, None)


@pytest.fixture
def recorded(monkeypatch):
    """Three engine calls of 1, 3 and 2 ms (the last two overlapping by
    1 ms, as calls from two threads would) with children, and one span
    left open."""
    spans = [call(0, 1, 1), child("engine.infer", 0.1, 0.9, 0, 1),
             call(2, 5, 2), call(4, 6, 3),
             tracing.Span("engine.infer_padded", 7 * MS, None, -1, 1, 4,
                          None)]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    return spans


@pytest.fixture
def empty(monkeypatch):
    monkeypatch.setattr(tracing, "spans", list)
    monkeypatch.setattr(tracing, "counters", dict)


def test_the_readers_are_the_benchmarks_new_metrics():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["workloads"] == ["tm-mnist-50.bulk", "tm-mnist-100.bulk"]
        assert m["source"] == ("program_counter" if name == "setup_program_s"
                               else "program_span")
        assert m["moves"] == ("setup_s" if name == "setup_program_s"
                              else "rows_per_s")


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_none(empty, name):
    assert read(name, synthetic_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_tracer_reads_none(monkeypatch, recorded,
                                                  name):
    """The benchmark's files laid over a program that has no tracer (the
    parent of the change that added it): each reader is silent."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(name, synthetic_run(device_ops=30)) is None


def test_entry_ms_is_the_median_finished_call(recorded):
    assert read("entry_ms.bulk", synthetic_run()) == pytest.approx(2.0)


def test_host_pct_is_the_union_of_calls_over_the_window(recorded):
    # 1 ms + the 4 ms that [2, 5] and [4, 6] cover, over 10 ms
    assert read("host_pct.bulk", synthetic_run(0.01)) == pytest.approx(50.0)
    assert read("host_pct.bulk", synthetic_run(None)) is None
    assert read("host_pct.bulk", synthetic_run(0.0)) is None


def test_ops_per_call_divides_device_operations_by_calls(recorded):
    assert read("ops_per_call.bulk",
                synthetic_run(device_ops=30)) == pytest.approx(10.0)
    # the CPU traces no device operation: 0, not silence
    assert read("ops_per_call.bulk", synthetic_run()) == 0.0
    assert read("ops_per_call.bulk", synthetic_run(None)) is None


def test_setup_program_s_sums_the_programs_set_up(monkeypatch):
    monkeypatch.setattr(tracing, "counters", lambda: {
        "engine.build_s": 0.25, "kernel.build_s": 1.5, "kernel.load_s": 0.125,
        "kernel.builds": 6, "engine.h2d_bytes": 10**6})
    assert read("setup_program_s", synthetic_run()) == pytest.approx(1.875)
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"engine.build_s": 0.5})
    assert read("setup_program_s", synthetic_run()) == pytest.approx(0.5)


def test_a_traced_cpu_run_reads_its_own_calls():
    """On a whole traced run the readers see the calls of the traced
    sub-window only: as many spans as calls made after the untraced
    part."""
    cell = dataclasses.replace(
        spec.find_cell("tm-mnist-50.bulk", bench=BENCH),
        traffic={"entry": "bulk", "rows_per_call": 64, "pool_chunks": 2,
                 "in_flight": 2, "check_calls": 2, "check_stride": 1,
                 "trace_seconds": 0.1})
    tracing.reset()
    r = harness.run_cell(cell, 7, 0.2, True, device=torch.device("cpu"))
    calls = [s for s in tracing.spans() if s.name == "engine.infer_padded"]
    traced = r.attempted - len(r.spans["call"])
    assert 0 < len(calls) == traced
    got = harness.metrics(r)
    assert got["entry_ms.bulk"]["value"] > 0
    assert 0 < got["host_pct.bulk"]["value"] <= 100
    assert got["ops_per_call.bulk"]["value"] == 0.0
    assert got["setup_program_s"]["value"] > 0
