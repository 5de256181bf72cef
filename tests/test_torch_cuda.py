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

from repro_torch import checkpoint as ckpt
from repro_torch.convert import state_from_numpy
from repro_torch.core import prng
from repro_torch.core.popcount import pack_bits
from repro_torch.core.tm import TMConfig
from repro_torch.engine import (available_backends, get_engine,
                                get_train_engine)
from repro_torch.engine.cascade import subsample_mask
from repro_torch.kernels.clause_eval import (clause_votes,
                                             clause_votes_plain,
                                             make_vote_matrix)
from repro_torch.kernels.swar_fused import (swar_fused_votes,
                                            swar_fused_votes_plain)
from repro_torch.kernels.train_fused import (train_deltas_keyed,
                                             train_deltas_keyed_plain)
from repro_torch.kernels.binary_matmul import (binary_matmul,
                                               binary_matmul_plain)
from repro_torch.kernels.pdl_race import pdl_race, pdl_race_plain
from repro_torch.kernels.popcount import popcount_words, popcount_words_plain
from repro_torch.serve import ServePolicy, TMFleet, TMServer

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

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


def _shifted(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past a 16-byte boundary: one byte for int8 operands (the kernels'
    byte-load path), four for int32 words."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == t.element_size()
    return out


# (B, C, M, L, density): tm-mnist-50 widths, ragged batches, L not a
# multiple of 4 (byte loads) or of 32 (ragged last word), a class count
# whose (rows, C) tile needs more than 48 KB of shared memory, and the
# density extremes; then the edges of K3's tensor-core tiles (64 rows x
# 64 clauses x 128 bytes, mma steps of 16 rows and 32 bytes): B around 16
# and 64, CM = 63 / 65 / 128 around the clause tile, L around 32 and
# tm-mnist-50's 1568 (16-byte copies), and B = 4096 at one, two and four
# depth groups per block
CASES = [(64, 10, 50, 1568, 0.05), (37, 10, 50, 1568, 0.05),
         (1, 10, 50, 1568, 0.05), (300, 3, 7, 18, 0.2),
         (13, 4, 9, 30, 1.0), (9, 2, 6, 22, 0.0), (5, 1500, 2, 40, 0.1),
         (70, 5, 33, 130, 0.02),
         (15, 7, 9, 31, 0.05), (16, 5, 13, 32, 0.05), (17, 7, 9, 33, 0.05),
         (63, 5, 13, 1568, 0.002), (65, 7, 9, 1568, 0.002),
         (16, 4, 32, 32, 0.04), (65, 5, 13, 33, 0.1),
         (4096, 10, 50, 1568, 0.05), (4096, 4, 32, 1568, 0.002),
         (4096, 7, 9, 32, 0.05),
         # K1's cluster design: B around its 8-row serving tile and at the
         # switch to the 32-row bulk tile (B >= 8 x 132 SMs = 1056); CM
         # around one cluster's clause span (8 blocks x 64 clauses = 512)
         # and around 256; Wl = 1, 4, 5 and 49 words and 65 / 128 (two
         # staged 64-word chunks); odd B, whose 49-word rows start off
         # 16-byte alignment; densities at which some clauses fire
         (7, 10, 50, 1568, 0.002), (8, 10, 50, 1568, 0.002),
         (9, 10, 50, 1568, 0.002), (1055, 10, 50, 1568, 0.002),
         (1056, 10, 50, 1568, 0.002), (33, 5, 51, 64, 0.02),
         (33, 8, 32, 64, 0.02), (33, 1, 257, 64, 0.02),
         (21, 7, 73, 96, 0.02), (21, 8, 64, 96, 0.02),
         (21, 27, 19, 96, 0.02), (19, 3, 11, 32, 0.05),
         (19, 3, 11, 128, 0.01), (19, 3, 11, 130, 0.01),
         (41, 4, 9, 2080, 0.001), (41, 4, 9, 4096, 0.0005),
         # a fleet's fused plane: 64 tm-mnist-50 members stacked into 640
         # classes, at a density where clauses fire and at the members'
         (64, 640, 50, 1568, 0.002), (1, 640, 50, 1568, 0.002),
         (64, 640, 50, 1568, 0.05)]


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
    # operands one byte off 16-byte alignment: K3's byte loads
    got3 = clause_votes(_shifted(lits), _shifted(inc), vm)
    torch.cuda.synchronize()
    assert clause_votes.launches == n3 + 2
    assert torch.equal(got3, want)
    # words 4 bytes off 16-byte alignment: K1 stages with 4-byte loads
    got1 = swar_fused_votes(_shifted(not_words), _shifted(inc_words), vm)
    torch.cuda.synchronize()
    assert swar_fused_votes.launches == n1 + 2
    assert torch.equal(got1, want)


# (B, C, M, L, density): K1 alone with many classes — the bulk tile's
# (32, C) vote partial and 128 vote rows in shared memory (C = 500), and
# a class count for which only the serving tile fits (C = 900)
@pytest.mark.parametrize("case", [(2000, 500, 2, 40, 0.1),
                                  (1200, 900, 2, 40, 0.1)],
                         ids=lambda c: "B{}C{}M{}L{}-d{}".format(*c))
def test_swar_fused_kernel_many_classes(cuda, case):
    b, c, m, lit, density = case
    lits, inc = _inputs(cuda, b, c, m, lit, density, seed=b + c)
    vm = make_vote_matrix(c, m, cuda)
    not_words, inc_words = pack_bits(1 - lits), pack_bits(inc)
    n = swar_fused_votes.launches
    got = swar_fused_votes(not_words, inc_words, vm)
    torch.cuda.synchronize()
    assert swar_fused_votes.launches == n + 1
    want = swar_fused_votes_plain(not_words, inc_words, vm)
    assert torch.equal(got, want)
    assert bool(want.any())


# (B, C, M, L, density): class counts whose whole (8, C) vote partial and
# 64 vote rows of C bytes overrun an H100 block's 227 KB (about 128 bytes
# a class beside the staged words), so K1 tiles the class axis: 3,000
# classes in two tiles at a serving and at a bulk-sized batch (the bulk
# tile does not fit, so the serving tile runs tiled), 1,901 (odd: byte
# loads of the vote rows, and a last tile of 941 classes, not a whole
# number of words), and 5,000 classes over two 64-word chunks of Wl = 65
@pytest.mark.parametrize("case", [(4, 3000, 1, 40, 0.1),
                                  (1100, 3000, 1, 40, 0.1),
                                  (9, 1901, 2, 130, 0.05),
                                  (33, 5000, 1, 2080, 0.002)],
                         ids=lambda c: "B{}C{}M{}L{}-d{}".format(*c))
def test_swar_fused_kernel_past_its_old_shared_memory_limit(cuda, case):
    """Once refused (the launch failed and the wrapper raised at 3,000
    classes); now bitwise equal to the plain version."""
    b, c, m, lit, density = case
    lits, inc = _inputs(cuda, b, c, m, lit, density, seed=6 + b + c)
    g = torch.Generator().manual_seed(c)
    vm = torch.randint(-3, 4, (c * m, c), generator=g,
                       dtype=torch.int8).to(cuda)
    not_words, inc_words = pack_bits(1 - lits), pack_bits(inc)
    n = swar_fused_votes.launches
    got = swar_fused_votes(not_words, inc_words, vm)
    torch.cuda.synchronize()
    assert swar_fused_votes.launches == n + 1
    want = swar_fused_votes_plain(not_words, inc_words, vm)
    assert torch.equal(got, want)
    assert bool(want.any())


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


@pytest.mark.parametrize("backend", ["adder_tree", "cascade", "mxu_fused",
                                     "oracle", "sparse_csr", "swar_fused",
                                     "swar_packed"])
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


def _k2_inputs(dev, b, c, m, lit, density, seed, masks="masks"):
    """K2's arguments; ``masks``: "masks" (each on with probability 1/2),
    "off" (all off: a zero update) or "all" (all on)."""
    g = torch.Generator().manual_seed(seed)
    lits = torch.randint(0, 2, (b, lit), generator=g, dtype=torch.int8)
    inc = (torch.rand((c, m, lit), generator=g) < density).to(torch.int8)
    keys = prng.bits(prng.key(seed), (2, b, 2))
    masks = [(torch.rand((b, m), generator=g) < 0.5) & (masks != "off")
             | (masks == "all") for _ in range(4)]
    y = torch.randint(0, c, (b,), generator=g, dtype=torch.int32)
    yn = ((y + torch.randint(1, max(c, 2), (b,), generator=g)) % c) \
        .to(torch.int32)
    return [t.to(dev) for t in (lits, keys[0], keys[1], inc, *masks, y, yn)]


# (B, C, M, L, density, masks): tm-mnist-50 widths, ragged shapes, many
# classes, density extremes, and all masks off (a zero update); then the
# edges of the batch split (4 groups, 128-row chunks: B = 2, 31, 33, 128,
# 129, 257, 512), class counts around the class tile the partials' budget
# holds at L = 1568 (24 classes: C = 13 and 24 in one tile, 25 just
# above, 49 in three), every mask on, L = 2049 / 4096 (two steps of
# four columns per thread), and class tiles that no row addresses
K2_CASES = [(32, 10, 50, 1568, 0.05, "masks"),
            (37, 10, 50, 1568, 1.0, "masks"),
            (1, 10, 50, 1568, 0.0, "masks"), (64, 3, 7, 18, 0.3, "masks"),
            (40, 37, 5, 33, 0.2, "masks"), (9, 4, 6, 40, 0.1, "off"),
            (2, 10, 50, 1568, 0.05, "masks"),
            (31, 10, 50, 1568, 0.05, "masks"),
            (33, 10, 50, 1568, 0.05, "masks"),
            (128, 10, 4, 1568, 0.05, "masks"),
            (129, 10, 4, 1568, 0.05, "masks"),
            (257, 10, 4, 1568, 0.05, "masks"),
            (512, 10, 4, 1568, 0.05, "masks"),
            (40, 13, 5, 1568, 0.2, "masks"), (33, 25, 3, 1568, 0.1, "masks"),
            (30, 24, 3, 1568, 0.1, "masks"), (33, 49, 2, 1568, 0.1, "masks"),
            (32, 10, 50, 1568, 0.05, "all"), (37, 4, 6, 130, 0.3, "all"),
            (20, 4, 3, 2049, 0.01, "masks"), (20, 3, 3, 4096, 0.01, "all"),
            # three class tiles and two rows: a tile no row addresses
            (2, 49, 2, 1568, 0.1, "all")]


@pytest.mark.parametrize("case", K2_CASES,
                         ids=lambda c: "B{}C{}M{}L{}-d{}-{}".format(*c))
def test_train_deltas_kernel_bitwise_vs_plain(cuda, case):
    b, c, m, lit, density, masks = case
    args = _k2_inputs(cuda, b, c, m, lit, density, seed=b + c + m,
                      masks=masks)
    for p_inc in (1.0, 6 / 7):
        kw = dict(n_classes=c, p_inc=p_inc, p_dec=1 / 7)
        n = train_deltas_keyed.launches
        got = train_deltas_keyed(*args, **kw)
        torch.cuda.synchronize()
        assert train_deltas_keyed.launches == n + 1
        want = train_deltas_keyed_plain(*args, **kw)
        assert got.dtype == torch.int32 and got.shape == (c, m, lit)
        assert torch.equal(got, want)
        assert torch.equal(want.cpu(), train_deltas_keyed_plain(
            *[t.cpu() for t in args], **kw))
        assert bool(got.any()) == (masks != "off" and b > 0)


# (B, C, M, L, density, masks): class counts past what K2 stages for every
# class at once (the include tiles, C * TL / 8 bytes, beside the partials
# and the row stage: about 25,000 classes at L = 64 (TL = 64) and 6,100
# at L = 1568 (TL = 256, a 7-block cluster)), so it stages each chunk's
# addressed include rows instead
@pytest.mark.parametrize("case", [(8, 26000, 2, 64, 0.05, "masks"),
                                  (33, 6200, 2, 1568, 0.02, "all")],
                         ids=lambda c: "B{}C{}M{}L{}-d{}-{}".format(*c))
def test_train_deltas_kernel_past_its_old_class_limit(cuda, case):
    b, c, m, lit, density, masks = case
    args = _k2_inputs(cuda, b, c, m, lit, density, seed=b + m,
                      masks=masks)
    kw = dict(n_classes=c, p_inc=6 / 7, p_dec=1 / 7)
    n = train_deltas_keyed.launches
    got = train_deltas_keyed(*args, **kw)
    torch.cuda.synchronize()
    assert train_deltas_keyed.launches == n + 1
    want = train_deltas_keyed_plain(*args, **kw)
    assert got.shape == (c, m, lit)
    assert torch.equal(got, want)
    assert bool(got.any())


def test_train_deltas_kernel_reads_int64_labels(cuda):
    """The fused step hands K2 int64 labels: the kernel reads them as they
    are (no cast launch), and mixed label types agree too."""
    args = _k2_inputs(cuda, 32, 10, 50, 1568, 0.05, seed=5)
    kw = dict(n_classes=10, p_inc=1.0, p_dec=1 / 7)
    want = train_deltas_keyed_plain(*args, **kw)
    y64, yn64 = args[8].to(torch.int64), args[9].to(torch.int64)
    for y, yn in ((y64, yn64), (y64, args[9]), (args[8], yn64)):
        n = train_deltas_keyed.launches
        got = train_deltas_keyed(*args[:8], y, yn, **kw)
        torch.cuda.synchronize()
        assert train_deltas_keyed.launches == n + 1
        assert torch.equal(got, want)


def test_fused_on_cuda_equals_reference_on_cpu(cuda):
    """A 5-step chain at tm-mnist-50 width: the fused engine on the card
    (K1 + K2) publishes exactly the CPU reference engine's states."""
    rng = np.random.default_rng(11)
    cfg = TMConfig(10, 50, 784, T=5, s=7.0)
    ta = np.where(rng.random((10, 50, 1568)) < 0.05, 129, 128)
    gpu, cpu = state_from_numpy(ta), state_from_numpy(ta, device="cpu")
    fused, ref = get_train_engine("fused", cfg), \
        get_train_engine("reference", cfg)
    chain = prng.key(3)
    for _ in range(5):
        lits = rng.integers(0, 2, (32, 1568), dtype=np.int8)
        y = rng.integers(0, 10, (32,), dtype=np.int32)
        chain, k = prng.split(chain)
        gpu = fused.step(gpu, k, lits, y)
        cpu = ref.step(cpu, k, lits, y)
        assert gpu.ta.device.type == "cuda"
        assert torch.equal(gpu.ta.cpu(), cpu.ta)
    assert not np.array_equal(cpu.ta.numpy(), ta)


def test_sparse_on_cuda_equals_reference_on_cpu(cuda):
    """The sparse engine on the card (ELL votes + K2) over a 5-step chain
    at tm-mnist-50 width: each state equals the CPU reference's and the
    CPU sparse engine's, and its layout tracks the state on the card."""
    rng = np.random.default_rng(13)
    cfg = TMConfig(10, 50, 784, T=5, s=7.0)
    ta = np.where(rng.random((10, 50, 1568)) < 0.05, 129, 128)
    gpu = state_from_numpy(ta)
    cpu = cpu_sp = state_from_numpy(ta, device="cpu")
    sparse, ref = get_train_engine("sparse", cfg, cache=False), \
        get_train_engine("reference", cfg)
    sparse_cpu = get_train_engine("sparse", cfg, cache=False)
    chain = prng.key(4)
    n = train_deltas_keyed.launches
    for _ in range(5):
        lits = rng.integers(0, 2, (32, 1568), dtype=np.int8)
        y = rng.integers(0, 10, (32,), dtype=np.int32)
        chain, k = prng.split(chain)
        gpu = sparse.step(gpu, k, lits, y)
        cpu = ref.step(cpu, k, lits, y)
        cpu_sp = sparse_cpu.step(cpu_sp, k, lits, y)
        assert gpu.ta.device.type == "cuda"
        assert torch.equal(gpu.ta.cpu(), cpu.ta)
        assert torch.equal(cpu_sp.ta, cpu.ta)
    assert train_deltas_keyed.launches == n + 5
    assert sparse._ell.layout.indices.device.type == "cuda"
    assert sparse.layout_stats() == sparse_cpu.layout_stats()
    assert not np.array_equal(cpu.ta.numpy(), ta)


def test_learning_server_on_cuda(cuda):
    rng = np.random.default_rng(12)
    cfg = TMConfig(3, 8, 20, T=5, s=3.9)
    ta = rng.integers(128, 130, (3, 8, 40))
    batches = [(rng.integers(0, 2, (16, 40), dtype=np.int8),
                rng.integers(0, 3, (16,), dtype=np.int32)) for _ in range(3)]
    reqs = [rng.integers(0, 2, (int(n), 40), dtype=np.int8)
            for n in rng.integers(1, 9, 12)]

    async def go():
        async with TMServer(cfg, state_from_numpy(ta),
                            ServePolicy(max_batch=16, max_wait_us=300,
                                        backend="mxu_fused"),
                            train_backend="fused", train_seed=4) as srv:
            await srv.warmup(train_batches=(16,))
            n = train_deltas_keyed.launches
            versions = []
            for lits, y in batches:
                versions.append(await srv.submit_labeled(lits, y))
            res = await asyncio.gather(*[srv.submit(r) for r in reqs])
            return versions, res, srv.state, train_deltas_keyed.launches - n

    versions, res, state, launches = asyncio.run(go())
    assert versions == [1, 2, 3] and launches == 3
    chain, want = prng.key(4), state_from_numpy(ta, device="cpu")
    ref = get_train_engine("reference", cfg)
    for lits, y in batches:
        chain, k = prng.split(chain)
        want = ref.step(want, k, lits, y)
    assert torch.equal(state.ta.cpu(), want.ta)
    oracle = get_engine("oracle", cfg, want)
    for lits, r in zip(reqs, res):
        np.testing.assert_array_equal(r.prediction,
                                      oracle.infer(lits).prediction)


# --- K4, K5, K6: the paper-surface kernels -------------------------------

@pytest.mark.parametrize("r,w", [(1, 1), (37, 129), (4096, 512), (5, 3),
                                 (300, 4)])
def test_popcount_kernel_bitwise_vs_plain(cuda, r, w):
    g = torch.Generator().manual_seed(r + w)
    words = torch.randint(-2**31, 2**31, (r, w), generator=g,
                          dtype=torch.int64).to(torch.int32)
    if r > 2:
        words[1] = -1                      # all ones
        words[2] = 0
    words = words.to(cuda)
    n = popcount_words.launches
    got = popcount_words(words)
    torch.cuda.synchronize()
    assert popcount_words.launches == n + 1
    want = popcount_words_plain(words)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(want.cpu(), popcount_words_plain(words.cpu()))
    if r > 2:
        assert int(got[1]) == 32 * w and int(got[2]) == 0
    # rows starting 4 bytes past a 16-byte boundary take the word path
    buf = torch.zeros(r * w + 1, dtype=torch.int32, device=cuda)
    shifted = buf[1:].view(r, w)
    shifted.copy_(words)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert torch.equal(popcount_words(shifted), want)


# (M, K, N): ragged shapes; then the edges of K6's tensor-core tiles
# (64 x 64 blocks, mma steps of 16 rows, 8 columns and 32 bytes, 128-byte
# chunks): the BNN's one launch (launch/bnn_popcount.py), M and N around
# 16 / 64 / 128, K around 32 and a deep K (32 chunks)
@pytest.mark.parametrize("m,k,n", [(1, 784, 128), (37, 129, 65),
                                   (1024, 1024, 1024), (70, 3, 1),
                                   (5, 1, 9), (129, 64, 200),
                                   (120, 784, 128), (15, 31, 17),
                                   (17, 32, 15), (127, 33, 129),
                                   (129, 4096, 127), (16, 4096, 64),
                                   (128, 32, 16), (64, 129, 65)])
def test_binary_matmul_kernel_bitwise_vs_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    x = (torch.randint(0, 2, (m, k), generator=g) * 2 - 1).to(torch.int8)
    w = (torch.randint(0, 2, (k, n), generator=g) * 2 - 1).to(torch.int8)
    x, w = x.to(cuda), w.to(cuda)
    launches = binary_matmul.launches
    got = binary_matmul(x, w)
    torch.cuda.synchronize()
    assert binary_matmul.launches == launches + 1
    want = binary_matmul_plain(x, w)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(want.cpu(), binary_matmul_plain(x.cpu(), w.cpu()))
    # operands one byte off 16-byte alignment: K6's byte loads
    got = binary_matmul(_shifted(x), _shifted(w))
    torch.cuda.synchronize()
    assert binary_matmul.launches == launches + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(33, 77, 40), (70, 4096, 72)])
def test_binary_matmul_kernel_any_int8(cuda, m, k, n):
    """The int32 accumulation is exact for any int8 operands, not only
    ±1: a K that is not a multiple of 4 (byte loads), and K = 4096 with
    values in [-128, 127]; a row and a column of -128 make
    out[0, 0] = 2^14 · K, 2^26 at K = 4096."""
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-128, 128, (m, k), generator=g).to(torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g).to(torch.int8)
    x[0] = -128
    w[:, 0] = -128
    launches = binary_matmul.launches
    got = binary_matmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert binary_matmul.launches == launches + 1
    want = x.to(torch.int32) @ w.to(torch.int32)
    assert int(want[0, 0]) == 2**14 * k
    assert torch.equal(got.cpu(), want)


def _race_args(dev, b, c, m, seed, integer):
    g = torch.Generator().manual_seed(seed)
    sel = torch.randint(0, 2, (b, c, m), generator=g, dtype=torch.int8)
    if integer:
        ed = torch.randint(300, 700, (c, m, 2), generator=g).float()
        skew = torch.randint(-3, 4, (c,), generator=g).float()
    else:
        ed = 500.0 + 100.0 * torch.randn((c, m, 2), generator=g)
        skew = torch.randn((c,), generator=g)
    return [t.to(dev) for t in (sel, ed, skew)]


# (B, C, M): the kernel_bench shape and B = 1; C = 1 (32 lanes a class),
# 10 (3), 16 (2), 17 and 32 (a lane a class), 33 and 100 (lanes walk
# several classes) and 3,000; M = 0, 1 and not a multiple of 4 or 16
# (rows start off 16-byte alignment: head and tail bytes); C * M = 20,000
# (tables and row buffers past shared memory: read from global memory);
# and more rows than warps in the grid (a warp takes several rows)
@pytest.mark.parametrize("b,c,m", [(1, 10, 50), (37, 10, 50),
                                   (1024, 10, 100), (37, 1, 50),
                                   (20, 3000, 4), (9, 33, 1),
                                   (1, 10, 100), (33, 10, 7), (5, 3, 101),
                                   (64, 16, 13), (64, 17, 13), (40, 32, 5),
                                   (16, 100, 9), (6, 5, 0), (9, 1, 1),
                                   (3, 100, 200), (5000, 4, 6)])
def test_pdl_race_kernel_bitwise_on_integer_delays(cuda, b, c, m):
    args = _race_args(cuda, b, c, m, b + c + m, integer=True)
    n = pdl_race.launches
    got = pdl_race(*args, 10.0)
    torch.cuda.synchronize()
    assert pdl_race.launches == n + 1
    want = pdl_race_plain(*args, 10.0)
    assert [t.dtype for t in got] == [torch.int32, torch.float32, torch.bool]
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    for g_, w_ in zip(want, pdl_race_plain(*[t.cpu() for t in args], 10.0)):
        assert torch.equal(g_.cpu(), w_)
    if not m:
        return
    # selects one byte off 16-byte alignment: every row's head and tail
    got = pdl_race(_shifted(args[0]), *args[1:], 10.0)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("c", [1, 3, 10, 40])
def test_pdl_race_kernel_ties_keep_the_kernel_rule(cuda, c):
    """Tied minima on integer delays: the winner is the lowest tied class
    and the gap runs to the next distinct arrival (0, so metastable, when
    every class ties or C = 1), bit for bit with the plain version."""
    sel, ed, skew = _race_args(cuda, 64, c, 9, 7 + c, integer=True)
    if c > 1:
        sel[:, c - 1] = sel[:, 0]          # class c-1 ties class 0 ...
        ed[c - 1] = ed[0]
        skew[c - 1] = skew[0]
        sel[:8] = sel[:8, :1].clone()      # ... and every class ties here
        ed[:] = ed[:1].clone()
        skew[:] = skew[:1].clone()
        sel[8:, 1:c - 1] = 1 - sel[8:, :1]  # elsewhere the others differ
    got = pdl_race(sel, ed, skew, 10.0)
    want = pdl_race_plain(sel, ed, skew, 10.0)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert bool(got[2][:8].all())          # all arrive together: gap 0


def test_pdl_race_kernel_float_delays_and_tied_minimum(cuda):
    args = _race_args(cuda, 1024, 10, 100, 5, integer=False)
    win, lat, meta = pdl_race(*args, 10.0)
    pw, pl, pm = pdl_race_plain(*args, 10.0)
    assert torch.allclose(lat, pl, rtol=1e-6, atol=0)
    d = torch.sort(torch.where(args[0] != 0, args[1][..., 0],
                               args[1][..., 1]).double().sum(-1)
                   + args[2].double(), -1).values
    gaps = d.diff(dim=-1)
    clear = (gaps.min(-1).values > 1e-3) & ((gaps[:, 0] - 10.0).abs() > 1e-3)
    assert float(clear.float().mean()) > 0.9
    assert torch.equal(win[clear], pw[clear])
    assert torch.equal(meta[clear], pm[clear])
    sel = torch.ones((1, 3, 1), dtype=torch.int8, device=cuda)
    ed = torch.tensor([[[4.0, 4.0]], [[4.0, 4.0]], [[400.0, 400.0]]],
                      device=cuda)
    win, lat, meta = pdl_race(sel, ed, torch.zeros(3, device=cuda), 10.0)
    assert (int(win[0]), float(lat[0]), bool(meta[0])) == (0, 4.0, False)


def test_time_domain_engine_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    ta = np.where(rng.random((10, 50, 1568)) < 0.002, 129, 128)
    lits = rng.integers(0, 2, (45, 1568), dtype=np.int8)
    cfg = TMConfig(10, 50, 784)
    want = get_engine("time_domain", cfg,
                      state_from_numpy(ta, device="cpu")).infer(lits)
    got = get_engine("time_domain", cfg, state_from_numpy(ta)).infer(lits)
    assert got.prediction.device.type == "cuda"
    assert torch.equal(got.prediction.cpu(), want.prediction)
    assert torch.equal(got.class_sums.cpu(), want.class_sums)
    for k in ("latency_ps", "metastable"):
        assert torch.equal(got.aux[k].cpu(), want.aux[k])


def test_bnn_launcher_on_cuda(cuda):
    from repro_torch.launch.bnn_popcount import run
    n = binary_matmul.launches
    out = run(device="cuda")
    assert binary_matmul.launches == n + 1
    assert out["h_shape"] == (120, 128)


# --- the cascade on K1, and checkpoints across devices -------------------

def _indicator_rows(rng, c, m, f, n_random):
    """tm-mnist-width indicator machine (class k's +clauses include x_k,
    its -clauses not-x_k) with its one-hot rows, which settle in stage 1,
    and random rows, whose tied indicator sums escalate."""
    ta = np.full((c, m, 2 * f), 128, np.int32)
    for k in range(c):
        ta[k, 0::2, k] = 129
        ta[k, 1::2, f + k] = 129
    x = np.zeros((c + n_random, f), np.int8)
    x[np.arange(c), np.arange(c)] = 1
    x[c:] = rng.integers(0, 2, (n_random, f), dtype=np.int8)
    return ta, np.concatenate([x, 1 - x], axis=1)


@pytest.mark.parametrize("fraction", [0.625, 0.01, 1.0],
                         ids=["M1=31", "M1=1", "M1=M"])
@pytest.mark.parametrize("exact_sums", [True, False])
def test_cascade_on_cuda_equals_cpu(cuda, fraction, exact_sums):
    """The cascade on the card (stage 1 and the completion pass on K1 at
    the subsampled C*M1, escalation on K3) against its CPU run, bitwise:
    prediction, class sums and the escalated mask; K1 launches once per
    pass, K3 once per escalated sub-batch."""
    c, m, f = 10, 50, 784
    ta, lits = _indicator_rows(np.random.default_rng(21), c, m, f, 54)
    cfg = TMConfig(c, m, f)
    opts = dict(stage1_fraction=fraction, exact_sums=exact_sums,
                full_backend="mxu_fused", cache=False)
    want = get_engine("cascade", cfg, state_from_numpy(ta, device="cpu"),
                      **opts).infer(lits)
    eng = get_engine("cascade", cfg, state_from_numpy(ta), **opts)
    k1, k3 = swar_fused_votes.launches, clause_votes.launches
    got = eng.infer(lits)
    torch.cuda.synchronize()
    assert got.prediction.device.type == "cuda"
    for a, b in ((got.prediction, want.prediction),
                 (got.class_sums, want.class_sums),
                 (got.aux["escalated"], want.aux["escalated"])):
        assert torch.equal(a.cpu(), b)
    assert eng._s1[0].shape[0] == c * int(subsample_mask(m, fraction).sum())
    assert swar_fused_votes.launches - k1 == \
        eng.passes["stage1"] + eng.passes["completion"]
    assert clause_votes.launches - k3 == eng.passes["escalation"]
    oracle = get_engine("oracle", cfg, state_from_numpy(ta, device="cpu")) \
        .infer(lits)
    assert torch.equal(got.prediction.cpu(), oracle.prediction)
    esc = got.aux["escalated"].cpu()
    if fraction == 1.0:                 # a zero-width bound: all settle
        assert not esc.any()
    elif fraction > 0.5:                # one-hot rows settle, ties do not
        assert not esc[:c].any() and esc[c:].any()
    else:                               # one clause per class: all escalate
        assert esc.all()


def test_checkpoint_of_cuda_tensors_restores_on_cpu(cuda, tmp_path):
    rng = np.random.default_rng(22)
    ta = rng.integers(1, 257, (10, 50, 1568)).astype(np.int32)
    key = prng.key(2**31 + 9).to(cuda)
    d = str(tmp_path / "ck")
    t = ckpt.save_async(d, 5, ckpt.tm_lifecycle_tree(
        torch.as_tensor(ta, device=cuda), key),
        extra={"version": 5, "has_cursor": True, "key_impl": prng.IMPL})
    t.join(timeout=60)
    assert not t.is_alive()
    step, tree, extra = ckpt.restore_tm_lifecycle(d)
    assert step == 5 and tree["ta"].dtype == np.int32
    np.testing.assert_array_equal(tree["ta"], ta)
    assert tree["cursor"].dtype == np.uint32
    np.testing.assert_array_equal(tree["cursor"], [0, 2**31 + 9])


def test_cpu_snapshot_restores_onto_cuda(cuda, tmp_path):
    """A snapshot a CPU server wrote resumes on a cuda server: the state
    publishes on the card and the next fused update (K1 + K2) equals the
    CPU reference replay of the same key chain."""
    rng = np.random.default_rng(23)
    cfg = TMConfig(3, 8, 20, T=5, s=3.9)
    ta = rng.integers(128, 130, (3, 8, 40)).astype(np.int32)
    batches = [(rng.integers(0, 2, (16, 40), dtype=np.int8),
                rng.integers(0, 3, (16,), dtype=np.int32)) for _ in range(4)]
    d = str(tmp_path / "ck")

    async def cpu_run():
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=16, backend="oracle"),
                            device="cpu", train_backend="fused",
                            train_seed=6, checkpoint_dir=d) as srv:
            for b in batches[:2]:
                await srv.submit_labeled(*b)

    async def cuda_run():
        srv = TMServer(cfg, state_from_numpy(np.full_like(ta, 128)),
                       ServePolicy(max_batch=16, backend="mxu_fused"),
                       train_backend="fused", checkpoint_dir=d)
        assert srv.restore() == 2
        assert srv.state.ta.device.type == "cuda"
        async with srv:
            for b in batches[2:]:
                await srv.submit_labeled(*b)
            return srv.state

    asyncio.run(cpu_run())
    k2 = train_deltas_keyed.launches
    state = asyncio.run(cuda_run())
    assert train_deltas_keyed.launches - k2 == 2
    chain, want = prng.key(6), state_from_numpy(ta, device="cpu")
    ref = get_train_engine("reference", cfg)
    for lits, y in batches:
        chain, k = prng.split(chain)
        want = ref.step(want, k, lits, y)
    assert torch.equal(state.ta.cpu(), want.ta)


def test_packed_fleet_on_cuda_equals_cpu_oracle(cuda):
    """A packed fleet on cuda — two pack groups, a solo model and a
    learning member — answers every request as the CPU oracle of its
    model (the learner's at its replayed version), its published states
    equal the CPU reference replay, and K3 launches once per batch the
    group planes and the solo model served, K1 and K2 once per update."""
    rng = np.random.default_rng(31)
    shapes = {"a": (3, 8, 20), "b": (5, 8, 20), "c": (2, 8, 20),
              "d": (4, 6, 20), "e": (3, 6, 20), "f": (3, 8, 12)}
    tas = {n: np.where(rng.random((c, m, 2 * f)) < 0.1, 129, 128)
           .astype(np.int32) for n, (c, m, f) in shapes.items()}
    cfgs = {n: TMConfig(c, m, f, T=5, s=3.9)
            for n, (c, m, f) in shapes.items()}
    batches = [(rng.integers(0, 2, (16, 40), dtype=np.int8),
                rng.integers(0, 3, (16,), dtype=np.int32)) for _ in range(2)]
    reqs = [(n, rng.integers(0, 2, (int(rng.integers(1, 9)),
                                    2 * shapes[n][2]), dtype=np.int8))
            for n in rng.choice(list(shapes), 40)]
    specs = {n: {"cfg": cfgs[n], "state": state_from_numpy(tas[n])}
             for n in shapes}
    specs["a"].update(train_backend="fused", train_seed=3)

    async def go():
        fleet = TMFleet(specs, ServePolicy(max_batch=16, max_wait_us=300,
                                           backend="mxu_fused"))
        async with fleet:
            assert fleet.device.type == "cuda"
            await fleet.warmup(train_batches=(16,))
            n3, n1 = clause_votes.launches, swar_fused_votes.launches
            n2 = train_deltas_keyed.launches
            published = []
            for b in batches:
                await fleet.submit_labeled("a", *b)
                published.append(fleet.server_for("a").state.ta.cpu())
            out = await asyncio.gather(*[fleet.submit(n, lits)
                                         for n, lits in reqs])
            stats = fleet.stats()
            served = sum(g.server.stats()["batches"]
                         for g in fleet._groups) + sum(
                m["server"]["batches"] for m in stats["models"].values()
                if not m["packed"])
            launches = (clause_votes.launches - n3,
                        swar_fused_votes.launches - n1,
                        train_deltas_keyed.launches - n2)
        return out, published, stats, served, launches

    out, published, stats, served, launches = asyncio.run(go())
    assert stats["n_groups"] == 2 and not stats["models"]["f"]["packed"]
    chain, ref = prng.key(3), state_from_numpy(tas["a"], device="cpu")
    eng = get_train_engine("reference", cfgs["a"])
    for (lits, y), got in zip(batches, published):
        chain, k = prng.split(chain)
        ref = eng.step(ref, k, lits, y)
        assert torch.equal(got, ref.ta)
    states = {n: state_from_numpy(tas[n], device="cpu") for n in shapes}
    states["a"] = ref
    for (name, lits), res in zip(reqs, out):
        want = get_engine("oracle", cfgs[name], states[name]).infer(lits)
        np.testing.assert_array_equal(res.prediction, want.prediction)
        np.testing.assert_array_equal(res.class_sums, want.class_sums)
    assert launches == (served, 2, 2)
