"""Port parity: ``repro_torch.core.hwmodel``, the analytic FPGA cost model
of paper §IV, is a stdlib copy of ``repro.core.hwmodel`` (the port may
not import the JAX package); every function answers exactly as the
original for every paper model and implementation."""

import dataclasses
import math

import pytest

from repro.core import hwmodel as jhw
from repro_torch.core import hwmodel as hw

IMPLS = ("generic", "fpt18", "async21", "timedomain")


def _same(a: dict, b: dict) -> bool:
    """Dict equality with NaN equal to NaN (``async21`` reports no
    latency or power: the paper compares its resources only)."""
    def key(v):
        return "nan" if isinstance(v, float) and math.isnan(v) else v
    return {k: key(v) for k, v in a.items()} == \
        {k: key(v) for k, v in b.items()}


def _shapes(mod):
    return [dataclasses.asdict(s) for s in mod.paper_models()]


def test_paper_models_and_constants_match():
    assert hw.IMPLS == jhw.IMPLS == IMPLS
    assert _shapes(hw) == _shapes(jhw)
    assert [s.name for s in hw.paper_models()] == \
        ["iris-10", "iris-50", "mnist-50", "mnist-100"]
    assert dataclasses.asdict(hw.HWConstants()) == \
        dataclasses.asdict(jhw.HWConstants())
    assert hw.__all__ == jhw.__all__


@pytest.mark.parametrize("activity", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("impl", IMPLS)
def test_cost_matches(impl, activity):
    for s, js in zip(hw.paper_models(), jhw.paper_models()):
        assert _same(hw.cost(impl, s, activity=activity),
                     jhw.cost(impl, js, activity=activity)), s.name


@pytest.mark.parametrize("activity", [0.1, 0.5])
@pytest.mark.parametrize("impl", ["generic", "fpt18", "timedomain"])
def test_popcount_only_power_matches(impl, activity):
    for s, js in zip(hw.paper_models(), jhw.paper_models()):
        assert hw.popcount_only_power(impl, s, activity=activity) == \
            jhw.popcount_only_power(impl, js, activity=activity), s.name


def test_errors_match():
    shape = hw.paper_models()[0]
    for mod, s in ((hw, shape), (jhw, jhw.paper_models()[0])):
        with pytest.raises(ValueError, match="async21"):
            mod.popcount_only_power("async21", s)
    with pytest.raises(ValueError):
        hw.cost("nope", shape)
    with pytest.raises(ValueError):
        jhw.cost("nope", jhw.paper_models()[0])
