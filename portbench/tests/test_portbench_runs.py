"""Whole runs of every cell on the CPU, at sizes a test can hold: a sound
run comes out correct with its metrics, and a run whose timed path is
broken underneath comes out not correct, once for each fault the cell
can have (half of the batch's answers left out, an answer altered where
it is produced)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import harness, spec
from repro_torch.engine import EngineResult, clear_engine_cache
from repro_torch.engine.backends import MXUFusedEngine, TimeDomainEngine

torch.set_num_threads(2)

CPU = torch.device("cpu")
SECONDS = 0.25
BULK = dict(rows_per_call=96, pool_chunks=2, check_calls=4, check_stride=1,
            trace_seconds=0.1)
BENCH = spec.load_benchmark()


def small_cell(name: str):
    cell = spec.find_cell(name, bench=BENCH)
    return dataclasses.replace(cell, traffic={**cell.traffic, **BULK})


def run(name: str, trace: bool = False, seed: int = 2**31 + 3):
    clear_engine_cache()
    return harness.run_cell(small_cell(name), seed, SECONDS, trace,
                            device=CPU)


CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(name):
    r = run(name)
    assert r.correct and r.attempted > 0 and r.failed == 0, r.compared
    assert r.setup_s > 0 and r.window_s >= SECONDS
    # every chunk of the pool is compared
    assert r.info["chunks_checked"] == BULK["pool_chunks"]
    got = harness.metrics(r)
    assert set(got) == {m["name"] for m in r.cell.end_to_end}
    assert all(v["value"] > 0 for v in got.values())
    line = harness.result_line(r, {"platform": "cpu"})
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_per_layer_metrics(name):
    r = run(name, trace=True)
    assert r.correct and r.trace_summary is not None
    # the rate is read over the untraced part, before the profiler starts
    assert SECONDS - BULK["trace_seconds"] <= r.window_s < SECONDS
    assert r.rows < r.attempted * BULK["rows_per_call"]
    got = harness.metrics(r)
    # on the CPU no device operation is traced: the roofline stays silent
    assert "k3_roofline" not in got
    want = {m["name"] for m in r.cell.per_layer} - {"k3_roofline"}
    assert set(got) == want
    line = harness.result_line(r, {"platform": "cpu"})
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _drop_half(infer):
    def broken(self, literals):
        res = infer(self, literals)
        h = res.prediction.shape[0] // 2
        pred, sums = res.prediction.clone(), res.class_sums.clone()
        pred[h:], sums[h:] = 0, 0
        return EngineResult(pred, sums, res.aux)
    return broken


def _alter_one(infer, key):
    def broken(self, literals):
        res = infer(self, literals)
        if key == "prediction":
            p = res.prediction.clone()
            p[3] = (p[3] + 1) % self.cfg.n_classes
            return EngineResult(p, res.class_sums, res.aux)
        aux = dict(res.aux)
        aux[key] = aux[key].clone()
        aux[key][3] += 1.0
        return EngineResult(res.prediction, res.class_sums, aux)
    return broken


@pytest.mark.parametrize("name,engine,fault", [
    ("tm-mnist-50.bulk", MXUFusedEngine, "half"),
    ("tm-mnist-50.bulk", MXUFusedEngine, "prediction"),
    ("tm-mnist-100.bulk", TimeDomainEngine, "half"),
    ("tm-mnist-100.bulk", TimeDomainEngine, "latency_ps"),
])
def test_a_broken_answer_is_not_correct(monkeypatch, name, engine, fault):
    infer = engine.infer
    monkeypatch.setattr(engine, "infer", _drop_half(infer)
                        if fault == "half" else _alter_one(infer, fault))
    r = run(name)
    assert r.attempted > 0 and not r.correct, r.compared
