"""Whole runs of every cell on the CPU, at the size its entry's
``small_cell`` gives: a sound run comes out correct with its metrics
(:mod:`cellcheck`, through the entry's hooks), and a run of a bulk cell
whose timed path is broken underneath comes out not correct, once for
each fault the cell can have (half of the batch's answers left out, an
answer altered where it is produced)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, spec
from portbench.entries import bulk
from portbench.tests import cellcheck
from repro_torch.engine import EngineResult, clear_engine_cache
from repro_torch.engine.backends import MXUFusedEngine, TimeDomainEngine

torch.set_num_threads(2)

CPU = cellcheck.CPU
SECONDS = cellcheck.SECONDS
SEED = 2**31 + 3
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def _no_cached_engines():
    """Each run builds its engines anew, whatever an earlier test left."""
    clear_engine_cache()


def run(name: str):
    """A bulk cell's run at the bulk entry's small size."""
    cell = bulk.small_cell(spec.find_cell(name, bench=BENCH))
    return harness.run_cell(cell, SEED, SECONDS, False, device=CPU)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(name):
    cellcheck.sound_run(spec.find_cell(name, bench=BENCH), SEED)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_per_layer_metrics(name):
    cellcheck.traced_run(spec.find_cell(name, bench=BENCH), SEED)


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
