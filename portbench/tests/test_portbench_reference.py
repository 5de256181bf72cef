"""The benchmark's plain reference against the port on the CPU, at small
sizes: prediction and class sums, and the time-domain race's
``latency_ps`` and ``metastable``."""

from __future__ import annotations

import pytest
import torch

from portbench.reference import tm as ref
from repro_torch.core.tm import TMConfig, TMState
from repro_torch.engine import get_engine

torch.set_num_threads(2)

SHAPES = [(3, 8, 16, 0.1), (10, 50, 64, 0.02), (10, 100, 32, 0.05)]


def _state(c, m, f, density, seed, n=128):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((c, m, 2 * f), generator=g)
    return torch.where(u < density, n + 1, n).to(torch.int32)


def _rows(b, f, seed):
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randint(0, 2, (b, f), generator=g, dtype=torch.int8)
    return torch.cat([x, 1 - x], dim=1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("backend", ["oracle", "mxu_fused"])
def test_inference_matches_the_port(shape, backend):
    c, m, f, density = shape
    ta, lits = _state(c, m, f, density, 1), _rows(200, f, 1)
    cfg = TMConfig(n_classes=c, n_clauses=m, n_features=f)
    res = get_engine(backend, cfg, TMState(ta=ta)).infer(lits)
    pred, sums = ref.infer(ta, lits, 128)
    assert torch.equal(pred, res.prediction)
    assert torch.equal(sums, res.class_sums)
    assert len(set(pred.tolist())) > 1


@pytest.mark.parametrize("shape", SHAPES)
def test_race_matches_the_time_domain_engine(shape):
    from repro_torch.core.time_domain import PDLConfig
    c, m, f, density = shape
    pdl = {"d_low": 384.5, "d_high": 617.6, "t_res": 10.0}
    ta, lits = _state(c, m, f, density, 2), _rows(300, f, 2)
    cfg = TMConfig(n_classes=c, n_clauses=m, n_features=f)
    res = get_engine("time_domain", cfg, TMState(ta=ta),
                     pdl=PDLConfig(sigma_elem=0.0, sigma_noise=0.0,
                                   **pdl)).infer(lits)
    winner, sums, latency, meta = ref.infer_race(ta, lits, 128, pdl)
    assert torch.equal(winner, res.prediction)
    assert torch.equal(sums, res.class_sums)
    assert torch.equal(latency, res.aux["latency_ps"])
    assert torch.equal(meta, res.aux["metastable"])
    assert bool(meta.any()) and not bool(meta.all())
