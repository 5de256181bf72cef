"""The controls of the comparisons come out as not correct: the reference
computed in the precision below the stated one and fed through the same
comparison a run makes (``portbench/control.py``, by the hook of each
cell's entry).  On the CPU at the size the entry's ``small_cell`` gives;
on the card (``-m cuda``) at each cell's own sizes on three seeds.
"""

from __future__ import annotations

import pytest
import torch

from portbench import control, spec
from portbench.tests import cellcheck

torch.set_num_threads(2)

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _failed(compared: dict) -> bool:
    return any(v > lim for v, lim in compared.values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_the_control_fails_on_the_cpu(name, seed):
    cellcheck.control_fails(spec.find_cell(name, bench=BENCH), seed)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(cuda, name):
    cell = spec.find_cell(name)
    for seed in (11, 12, 2**31 + 13):
        assert _failed(control.control(cell, seed, cuda))
