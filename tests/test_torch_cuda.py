"""The port's CUDA kernels on the card: each held bitwise to its plain
PyTorch version, plus the engines and the server on cuda.

Every test is marked ``cuda`` and skips where no GPU is visible (the
decision is taken inside the fixture, never at import).  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import asyncio

import numpy as np
import pytest
import torch

from repro_torch.convert import state_from_numpy
from repro_torch.core.popcount import pack_bits
from repro_torch.core.tm import TMConfig
from repro_torch.engine import available_backends, get_engine
from repro_torch.kernels.clause_eval import (clause_votes,
                                             clause_votes_plain,
                                             make_vote_matrix)
from repro_torch.kernels.swar_fused import (swar_fused_votes,
                                            swar_fused_votes_plain)
from repro_torch.serve import ServePolicy, TMServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _inputs(dev, b, c, m, lit, density, seed):
    g = torch.Generator().manual_seed(seed)
    lits = torch.randint(0, 2, (b, lit), generator=g, dtype=torch.int8)
    inc = (torch.rand((c * m, lit), generator=g) < density).to(torch.int8)
    if b:
        lits[0] = 1
    return lits.to(dev), inc.to(dev)


# (B, C, M, L, density): tm-mnist-50 widths, ragged batches, L not a
# multiple of 4 (byte loads) or of 32 (ragged last word), a class count
# whose (rows, C) tile needs more than 48 KB of shared memory, and the
# density extremes
CASES = [(64, 10, 50, 1568, 0.05), (37, 10, 50, 1568, 0.05),
         (1, 10, 50, 1568, 0.05), (300, 3, 7, 18, 0.2),
         (13, 4, 9, 30, 1.0), (9, 2, 6, 22, 0.0), (5, 1500, 2, 40, 0.1),
         (70, 5, 33, 130, 0.02)]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "B{}C{}M{}L{}-d{}".format(*c))
def test_kernels_bitwise_vs_plain(cuda, case):
    b, c, m, lit, density = case
    lits, inc = _inputs(cuda, b, c, m, lit, density, seed=b + c + m + lit)
    vm = make_vote_matrix(c, m, cuda)
    n3, n1 = clause_votes.launches, swar_fused_votes.launches
    got3 = clause_votes(lits, inc, vm)
    not_words, inc_words = pack_bits(1 - lits), pack_bits(inc)
    got1 = swar_fused_votes(not_words, inc_words, vm)
    torch.cuda.synchronize()
    assert clause_votes.launches == n3 + 1
    assert swar_fused_votes.launches == n1 + 1
    want = clause_votes_plain(lits, inc, vm)
    assert torch.equal(got3, want)
    assert torch.equal(got1, swar_fused_votes_plain(not_words, inc_words, vm))
    assert torch.equal(want.cpu(), clause_votes_plain(lits.cpu(), inc.cpu(),
                                                      vm.cpu()))


def test_kernels_take_an_arbitrary_vote_matrix(cuda):
    lits, inc = _inputs(cuda, 33, 4, 9, 50, 0.1, seed=3)
    g = torch.Generator().manual_seed(1)
    vm = torch.randint(-7, 8, (36, 6), generator=g,
                       dtype=torch.int8).to(cuda)
    want = clause_votes_plain(lits, inc, vm)
    assert torch.equal(clause_votes(lits, inc, vm), want)
    assert torch.equal(swar_fused_votes(pack_bits(1 - lits), pack_bits(inc),
                                        vm), want)


def test_kernels_reject_non_contiguous(cuda):
    lits, inc = _inputs(cuda, 8, 2, 4, 64, 0.1, seed=4)
    vm = make_vote_matrix(2, 4, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        clause_votes(lits[:, ::2], inc[:, ::2], vm)
    with pytest.raises(ValueError, match="contiguous"):
        swar_fused_votes(pack_bits(lits).T.contiguous().T, pack_bits(inc),
                         vm)


def test_empty_batch(cuda):
    lits, inc = _inputs(cuda, 0, 2, 4, 16, 0.1, seed=5)
    vm = make_vote_matrix(2, 4, cuda)
    assert clause_votes(lits, inc, vm).shape == (0, 2)
    assert swar_fused_votes(pack_bits(1 - lits), pack_bits(inc),
                            vm).shape == (0, 2)


@pytest.mark.parametrize("backend", ["adder_tree", "mxu_fused", "oracle",
                                     "swar_fused", "swar_packed"])
def test_engines_on_cuda_match_cpu_oracle(cuda, backend):
    assert backend in available_backends()
    rng = np.random.default_rng(7)
    ta = np.where(rng.random((10, 50, 1568)) < 0.05, 129, 128)
    ta[2] = ta[1]                                     # tied class sums
    lits = rng.integers(0, 2, (45, 1568), dtype=np.int8)
    cfg = TMConfig(10, 50, 784)
    want = get_engine("oracle", cfg, state_from_numpy(ta, device="cpu")) \
        .infer(lits)
    got = get_engine(backend, cfg, state_from_numpy(ta)).infer(lits)
    assert got.prediction.device.type == "cuda"
    assert torch.equal(got.prediction.cpu(), want.prediction)
    assert torch.equal(got.class_sums.cpu(), want.class_sums)


def test_server_on_cuda(cuda):
    rng = np.random.default_rng(8)
    ta = np.where(rng.random((3, 8, 40)) < 0.2, 129, 128)
    cfg = TMConfig(3, 8, 20)
    oracle = get_engine("oracle", cfg, state_from_numpy(ta, device="cpu"))
    reqs = [rng.integers(0, 2, (int(n), 40), dtype=np.int8)
            for n in rng.integers(1, 9, 24)]

    async def go():
        async with TMServer(cfg, state_from_numpy(ta),
                            ServePolicy(max_batch=16, max_wait_us=300,
                                        backend="mxu_fused")) as srv:
            assert srv.device.type == "cuda"
            await srv.warmup()
            return await asyncio.gather(*[srv.submit(r) for r in reqs])

    for lits, res in zip(reqs, asyncio.run(go())):
        want = oracle.infer(lits)
        np.testing.assert_array_equal(res.prediction, want.prediction)
        np.testing.assert_array_equal(res.class_sums, want.class_sums)
