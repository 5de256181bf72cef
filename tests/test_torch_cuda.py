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
from repro_torch.core.time_domain import (PDLConfig, ideal_delays,
                                          low_select, make_device, race)
from repro_torch.core.tm import TMConfig, clause_polarity, include_mask
from repro_torch.distributed import data_mesh
from repro_torch import tracing
from repro_torch.engine import (available_backends, get_engine,
                                get_train_engine, infer_padded)
from repro_torch.engine.backends import _clause_bits
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
from repro_torch.kernels.ops import launches
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
    n3, n1 = launches("clause_votes"), launches("swar_fused_votes")
    got3 = clause_votes(lits, inc, vm)
    not_words, inc_words = pack_bits(1 - lits), pack_bits(inc)
    got1 = swar_fused_votes(not_words, inc_words, vm)
    torch.cuda.synchronize()
    assert launches("clause_votes") == n3 + 1
    assert launches("swar_fused_votes") == n1 + 1
    want = clause_votes_plain(lits, inc, vm)
    assert torch.equal(got3, want)
    assert torch.equal(got1, swar_fused_votes_plain(not_words, inc_words, vm))
    assert torch.equal(want.cpu(), clause_votes_plain(lits.cpu(), inc.cpu(),
                                                      vm.cpu()))
    # operands one byte off 16-byte alignment: K3's byte loads
    got3 = clause_votes(_shifted(lits), _shifted(inc), vm)
    torch.cuda.synchronize()
    assert launches("clause_votes") == n3 + 2
    assert torch.equal(got3, want)
    # words 4 bytes off 16-byte alignment: K1 stages with 4-byte loads
    got1 = swar_fused_votes(_shifted(not_words), _shifted(inc_words), vm)
    torch.cuda.synchronize()
    assert launches("swar_fused_votes") == n1 + 2
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
    n = launches("swar_fused_votes")
    got = swar_fused_votes(not_words, inc_words, vm)
    torch.cuda.synchronize()
    assert launches("swar_fused_votes") == n + 1
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
    n = launches("swar_fused_votes")
    got = swar_fused_votes(not_words, inc_words, vm)
    torch.cuda.synchronize()
    assert launches("swar_fused_votes") == n + 1
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


def test_spans_under_the_benchmarks_cuda_only_profiler(cuda):
    """A profiler of the card's activity alone (the benchmark's) sets
    torch's flag in its recorded step, not in its warm-up, so the
    program records one ``engine.infer_padded`` span a call there; on
    the profiler's clock every runtime call that launches, copies or
    sets memory lies inside a call's span, and K3 counts one launch a
    call."""
    from torch.profiler import ProfilerActivity, profile, schedule
    rng = np.random.default_rng(29)
    cfg = TMConfig(10, 50, 784)
    st = state_from_numpy(np.where(rng.random((10, 50, 1568)) < 0.002,
                                   129, 128))
    eng = get_engine("mxu_fused", cfg, st)
    lits = torch.as_tensor(rng.integers(0, 2, (512, 1568), dtype=np.int8),
                           device=cuda)
    infer_padded(eng, lits, 512)
    torch.cuda.synchronize()
    kept = []
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=kept.append)
    prof.start()
    infer_padded(eng, lits, 512)          # warm-up: not recorded
    prof.step()
    n = launches("clause_votes")
    for _ in range(3):
        infer_padded(eng, lits, 512)
    torch.cuda.synchronize()
    prof.step()
    prof.stop()
    assert launches("clause_votes") == n + 3
    calls = [s for s in tracing.spans() if s.name == "engine.infer_padded"]
    assert len(calls) == 3
    start = kept[0].profiler.kineto_results.trace_start_ns()
    wins = [(tracing.to_profiler_us(s.start_ns, start),
             tracing.to_profiler_us(s.end_ns, start)) for s in calls]
    runtime = [e.time_range for e in kept[0].events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith(("cudaLaunchKernel", "cudaMemsetAsync",
                                      "cudaMemcpyAsync"))]
    assert len(runtime) >= 3 * 2
    for tr in runtime:
        assert any(a - 20.0 <= tr.start and tr.end <= b + 20.0
                   for a, b in wins), (tr.start, tr.end, wins)


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
        n = launches("train_deltas")
        got = train_deltas_keyed(*args, **kw)
        torch.cuda.synchronize()
        assert launches("train_deltas") == n + 1
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
    n = launches("train_deltas")
    got = train_deltas_keyed(*args, **kw)
    torch.cuda.synchronize()
    assert launches("train_deltas") == n + 1
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
        n = launches("train_deltas")
        got = train_deltas_keyed(*args[:8], y, yn, **kw)
        torch.cuda.synchronize()
        assert launches("train_deltas") == n + 1
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
    n = launches("train_deltas")
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
    assert launches("train_deltas") == n + 5
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
            n = launches("train_deltas")
            versions = []
            for lits, y in batches:
                versions.append(await srv.submit_labeled(lits, y))
            res = await asyncio.gather(*[srv.submit(r) for r in reqs])
            return versions, res, srv.state, launches("train_deltas") - n

    versions, res, state, k2 = asyncio.run(go())
    assert versions == [1, 2, 3] and k2 == 3
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
    n = launches("popcount_words")
    got = popcount_words(words)
    torch.cuda.synchronize()
    assert launches("popcount_words") == n + 1
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
    before = launches("binary_matmul")
    got = binary_matmul(x, w)
    torch.cuda.synchronize()
    assert launches("binary_matmul") == before + 1
    want = binary_matmul_plain(x, w)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(want.cpu(), binary_matmul_plain(x.cpu(), w.cpu()))
    # operands one byte off 16-byte alignment: K6's byte loads
    got = binary_matmul(_shifted(x), _shifted(w))
    torch.cuda.synchronize()
    assert launches("binary_matmul") == before + 2
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
    before = launches("binary_matmul")
    got = binary_matmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert launches("binary_matmul") == before + 1
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
    n = launches("pdl_race")
    got = pdl_race(*args, 10.0)
    torch.cuda.synchronize()
    assert launches("pdl_race") == n + 1
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


def _mnist_like(c, m, f, density, b, seed):
    """(C, M, 2F) states and (B, 2F) ``[x, ¬x]`` literals drawn as the
    benchmark draws them: each clause includes Binomial(F, 2·density)
    features, each as x or as ¬x, so about a fifth of the clauses fire
    on a random row at tm-mnist-100's 0.2 %."""
    rng = np.random.default_rng(seed)
    counts = rng.binomial(f, 2 * density, c * m)
    chosen = rng.random((c * m, f)).argsort(-1).argsort(-1) < counts[:, None]
    neg = rng.integers(0, 2, (c * m, f)).astype(bool)
    inc = np.concatenate([chosen & ~neg, chosen & neg], -1)
    ta = np.where(inc, 129, 128).reshape(c, m, 2 * f)
    x = rng.integers(0, 2, (b, f), dtype=np.int8)
    return ta, np.concatenate([x, 1 - x], -1)


# tm-mnist-100's widths either side of K3's 64-row tile and at a bulk
# size; odd M with C·M = 21, short of one 64-clause tile
@pytest.mark.parametrize("c,m,f,density,b", [
    (10, 100, 784, 0.002, 1), (10, 100, 784, 0.002, 63),
    (10, 100, 784, 0.002, 65), (10, 100, 784, 0.002, 4096),
    (3, 7, 40, 0.025, 65)], ids=lambda v: str(v))
def test_time_domain_ideal_engine_counts_on_k3(cuda, c, m, f, density, b):
    """The ideal device's low-net count from one K3 launch, bitwise to the
    CPU engine and to the per-clause route (clause bits, ``low_select``,
    ``ideal_delays``, ``race``) on the card; the physical device keeps
    that route and launches no K3."""
    ta, lits = _mnist_like(c, m, f, density, b, seed=b + c + m)
    cfg = TMConfig(c, m, f)
    eng = get_engine("time_domain", cfg, state_from_numpy(ta))
    n = launches("clause_votes")
    got = eng.infer(lits)
    torch.cuda.synchronize()
    assert launches("clause_votes") == n + 1
    want = get_engine("time_domain", cfg,
                      state_from_numpy(ta, device="cpu")).infer(lits)
    bits = _clause_bits(include_mask(cfg, state_from_numpy(ta)),
                        torch.from_numpy(lits).to(cuda))
    low = low_select(bits, clause_polarity(m, cuda)).sum(-1,
                                                          dtype=torch.int32)
    res = race(eng.pdl, ideal_delays(eng.pdl, low, m))
    per_clause = (res.winner, low - m // 2, res.latency, res.metastable)
    for g_, w_, p_ in zip((got.prediction, got.class_sums,
                           got.aux["latency_ps"], got.aux["metastable"]),
                          (want.prediction, want.class_sums,
                           want.aux["latency_ps"], want.aux["metastable"]),
                          per_clause):
        assert g_.device.type == cuda.type
        assert torch.equal(g_.cpu(), w_)
        assert torch.equal(g_, p_)
    pdl = PDLConfig(sigma_elem=2.0, sigma_noise=0.0)
    phys = get_engine("time_domain", cfg, state_from_numpy(ta), pdl=pdl,
                      device=make_device(pdl, c, m, prng.key(1)))
    n = launches("clause_votes")
    phys.infer(lits)
    torch.cuda.synchronize()
    assert launches("clause_votes") == n


def test_bnn_launcher_on_cuda(cuda):
    from repro_torch.launch.bnn_popcount import run
    n = launches("binary_matmul")
    out = run(device="cuda")
    assert launches("binary_matmul") == n + 1
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
    k1, k3 = launches("swar_fused_votes"), launches("clause_votes")
    got = eng.infer(lits)
    torch.cuda.synchronize()
    assert got.prediction.device.type == "cuda"
    for a, b in ((got.prediction, want.prediction),
                 (got.class_sums, want.class_sums),
                 (got.aux["escalated"], want.aux["escalated"])):
        assert torch.equal(a.cpu(), b)
    assert eng._s1[0].shape[0] == c * int(subsample_mask(m, fraction).sum())
    assert launches("swar_fused_votes") - k1 == \
        eng.passes["stage1"] + eng.passes["completion"]
    assert launches("clause_votes") - k3 == eng.passes["escalation"]
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
    k2 = launches("train_deltas")
    state = asyncio.run(cuda_run())
    assert launches("train_deltas") - k2 == 2
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
            n3, n1 = launches("clause_votes"), launches("swar_fused_votes")
            n2 = launches("train_deltas")
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
            counted = (launches("clause_votes") - n3,
                       launches("swar_fused_votes") - n1,
                       launches("train_deltas") - n2)
        return out, published, stats, served, counted

    out, published, stats, served, counted = asyncio.run(go())
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
    assert counted == (served, 2, 2)


# --- the mesh: data-parallel serving and training on the card ---------


def _card_mesh(cuda, d):
    """The card's own mesh at d=1, else d simulated shards of it."""
    return data_mesh(1) if d == 1 else data_mesh(d, devices=[cuda] * d)


@pytest.mark.parametrize("d", [1, 4])
def test_sharded_on_cuda_equals_fused(cuda, d):
    """A 5-step chain at tm-mnist-50 width, the last batch ragged (37
    rows): ``sharded`` on the card's mesh publishes exactly ``fused``'s
    states on the card and the CPU reference's, with K1 and K2 launched
    once per shard per step."""
    rng = np.random.default_rng(17)
    cfg = TMConfig(10, 50, 784, T=5, s=7.0)
    ta = np.where(rng.random((10, 50, 1568)) < 0.05, 129, 128)
    sh = fu = state_from_numpy(ta)
    cpu = state_from_numpy(ta, device="cpu")
    sharded = get_train_engine("sharded", cfg, mesh=_card_mesh(cuda, d))
    fused, ref = get_train_engine("fused", cfg), \
        get_train_engine("reference", cfg)
    chain = prng.key(6)
    n1, n2 = launches("swar_fused_votes"), launches("train_deltas")
    for b in (32, 32, 32, 32, 37):
        lits = rng.integers(0, 2, (b, 1568), dtype=np.int8)
        y = rng.integers(0, 10, (b,), dtype=np.int32)
        chain, k = prng.split(chain)
        sh = sharded.step(sh, k, lits, y)
        fu = fused.step(fu, k, lits, y)
        cpu = ref.step(cpu, k, lits, y)
        assert sh.ta.device.type == "cuda"
        assert torch.equal(sh.ta, fu.ta)
        assert torch.equal(sh.ta.cpu(), cpu.ta)
    # the fused engine launched K1 and K2 once a step too
    assert launches("swar_fused_votes") - n1 == 5 * d + 5
    assert launches("train_deltas") - n2 == 5 * d + 5


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("backend", ["mxu_fused", "swar_fused"])
def test_sharded_engine_on_cuda(cuda, backend, d):
    """``ShardedEngine`` over the kernel backends on the card's mesh:
    bitwise the unsharded engine at a divisible and a ragged batch, one
    kernel launch per shard."""
    rng = np.random.default_rng(19)
    cfg = TMConfig(10, 50, 784)
    st = state_from_numpy(np.where(rng.random((10, 50, 1568)) < 0.002,
                                   129, 128))
    plain = get_engine(backend, cfg, st)
    sharded = get_engine(backend, cfg, st,
                         shard_batch=_card_mesh(cuda, d))
    kernel = "clause_votes" if backend == "mxu_fused" else \
        "swar_fused_votes"
    for b in (64, 37):
        lits = rng.integers(0, 2, (b, 1568), dtype=np.int8)
        want = plain.infer(lits)
        n = launches(kernel)
        got = sharded.infer(lits)
        assert launches(kernel) - n == d
        assert got.class_sums.device.type == "cuda"
        assert torch.equal(got.prediction, want.prediction)
        assert torch.equal(got.class_sums, want.class_sums)


def test_mixed_cpu_and_cuda_mesh(cuda):
    """A mesh of the card and the CPU: the serving engine's layout is
    copied to the CPU shard (plain version there, kernel on the card) and
    the sharded step gathers and reduces across the two devices — both
    bitwise the single-device results."""
    rng = np.random.default_rng(23)
    cfg = TMConfig(4, 10, 30, T=5, s=3.9)
    ta = np.where(rng.random((4, 10, 60)) < 0.1, 129, 128)
    st = state_from_numpy(ta)
    mesh = data_mesh(devices=[cuda, torch.device("cpu"), cuda])
    lits = rng.integers(0, 2, (13, 60), dtype=np.int8)
    sharded = get_engine("mxu_fused", cfg, st, shard_batch=mesh)
    assert set(sharded.replicas) == {torch.device("cuda", 0),
                                     torch.device("cpu")}
    want = get_engine("mxu_fused", cfg, st).infer(lits)
    got = sharded.infer(lits)
    assert torch.equal(got.prediction, want.prediction)
    assert torch.equal(got.class_sums, want.class_sums)
    y = rng.integers(0, 4, (13,), dtype=np.int32)
    k = prng.key(8)
    got = get_train_engine("sharded", cfg, mesh=mesh).step(st, k, lits, y)
    want = get_train_engine("fused", cfg).step(st, k, lits, y)
    assert got.ta.device.type == "cuda" and torch.equal(got.ta, want.ta)


def test_mesh_server_elastic_restore_on_cuda(cuda, tmp_path):
    """A learning server on 4 simulated shards of the card, killed after
    2 updates and restored onto the card's own mesh, publishes the CPU
    reference replay's states and serves the CPU oracle's answers."""
    rng = np.random.default_rng(29)
    cfg = TMConfig(3, 8, 20, T=5, s=3.9)
    ta = rng.integers(128, 130, (3, 8, 40))
    batches = [(rng.integers(0, 2, (13, 40), dtype=np.int8),
                rng.integers(0, 3, (13,), dtype=np.int32)) for _ in range(4)]
    probe = rng.integers(0, 2, (5, 40), dtype=np.int8)
    d = str(tmp_path / "ck")
    policy = ServePolicy(max_batch=8, backend="mxu_fused")

    async def go(mesh, part, restore):
        srv = TMServer(cfg, state_from_numpy(ta), policy, mesh=mesh,
                       train_backend="sharded", train_seed=9,
                       checkpoint_dir=d)
        if restore:
            srv.restore(mesh=data_mesh(1))
        async with srv:
            for lits, y in part:
                await srv.submit_labeled(lits, y)
            return srv.state.ta.cpu(), (await srv.submit(probe)), \
                srv._train_engine.n_devices, srv.stats()["mesh"]

    _, _, n, mesh = asyncio.run(go(_card_mesh(cuda, 4), batches[:2], False))
    assert n == 4 and mesh == {"devices": 4, "axis": "data"}
    got, res, n, mesh = asyncio.run(go(_card_mesh(cuda, 4), batches[2:],
                                       True))
    assert n == 1 and mesh == {"devices": 1, "axis": "data"}
    chain, want = prng.key(9), state_from_numpy(ta, device="cpu")
    ref = get_train_engine("reference", cfg)
    for lits, y in batches:
        chain, k = prng.split(chain)
        want = ref.step(want, k, lits, y)
    assert torch.equal(got, want.ta)
    oracle = get_engine("oracle", cfg, want).infer(probe)
    np.testing.assert_array_equal(res.prediction, oracle.prediction)
    np.testing.assert_array_equal(res.class_sums, oracle.class_sums)


# -- the LM zoo's dense family: the port on cuda against the port on the CPU
#
# float32 on both devices (TF32 stays off: torch's default), reduced
# widths.  Tolerance on logits, hidden states, block outputs and KV
# caches: rtol 1e-4 and an absolute 1e-4 of the compared tensor's
# largest magnitude (at least 1e-4) — cuBLAS and the CPU sum float32
# products in another order, an error that scales with the operands (a
# block output of magnitude 18 differed by 1.2e-4 at an entry near 0.1);
# greedy tokens equal except where the CPU logits of the two picks lie
# within 1e-4.

LM_DENSE = ["tinyllama-1.1b", "qwen1.5-4b", "qwen1.5-110b", "starcoder2-7b",
            "internvl2-26b"]
LM_TOL = 1e-4


def _lm_pair(cuda, arch, tp=1):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models.model import LM
    cfg = reduced(get_config(arch))
    cpu = LM(cfg, tp=tp, device="cpu", dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(0))
    dev = LM(cfg, tp=tp, device=cuda, dtype=torch.float32)
    dev.load_state_dict(cpu.state_dict())
    return cfg, cpu, dev


def _lm_close(got, want):
    want = want.float().numpy()
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want, rtol=LM_TOL,
        atol=LM_TOL * max(1.0, float(np.abs(want).max(initial=0.0))))


def _lm_tokens_agree(got, want, logits):
    got, want = got.cpu().numpy(), want.numpy()
    logits = logits.numpy()
    rows = np.arange(len(want))
    gap = np.abs(logits[rows, got] - logits[rows, want])
    assert ((got == want) | (gap <= LM_TOL)).all(), (got, want, gap)


@pytest.mark.parametrize("arch", LM_DENSE)
def test_lm_prefill_and_decode_on_cuda_equal_cpu(cuda, arch):
    """Prefill (hidden states, last logits, greedy token, the ``(k, v)``
    cache) and 20 decode steps (tokens, caches; starcoder2's window-16
    ring wraps) on cuda against the same weights on the CPU."""
    cfg, cpu, dev = _lm_pair(cuda, arch)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20),
                                        np.int32))
    batch = {"tokens": toks}
    if cfg.prefix_len:
        batch["prefix"] = torch.as_tensor(rng.normal(
            0, 1, (2, cfg.prefix_len, cfg.d_model)).astype(np.float32))
    tok, (k, v) = cpu.prefill(batch)
    dtok, (dk, dv) = dev.prefill({n: t.to(cuda) for n, t in batch.items()})
    h, _ = cpu._forward(toks, prefix=batch.get("prefix"))
    pre = batch.get("prefix")
    dh, _ = dev._forward(toks.to(cuda),
                         prefix=None if pre is None else pre.to(cuda))
    logits = cpu._logits(h[:, -1:])[:, 0]
    _lm_close(dh, h)
    _lm_close(dev._logits(dh[:, -1:])[:, 0], logits)
    _lm_tokens_agree(dtok, tok, logits)
    _lm_close(dk, k)
    _lm_close(dv, v)
    cache, dcache = cpu.init_cache(2, 20), dev.init_cache(2, 20)
    for pos in range(20):
        t = toks[:, pos:pos + 1]
        logits = cpu._logits(cpu._decode_hidden(
            {n: c.clone() for n, c in cache.items()}, t, pos))[:, 0]
        nxt, cache = cpu.decode_step(cache, t, pos)
        dnxt, dcache = dev.decode_step(dcache, t.to(cuda), pos)
        _lm_tokens_agree(dnxt, nxt, logits)
        _lm_close(dcache["k"], cache["k"])
        _lm_close(dcache["v"], cache["v"])


@pytest.mark.parametrize("kw", [dict(window=16), dict(chunk=8),
                                dict(n_heads=6, n_kv_heads=2, tp=4)],
                         ids=["window-ring", "chunk-ring", "padded-heads"])
def test_attn_decode_ring_on_cuda_equals_cpu(cuda, kw):
    """``attn_decode`` step by step across two wraps of the ring (40
    steps into 16 / 8 slots), and with padded heads, on both devices."""
    from repro_torch.models import attention as attn
    from repro_torch.models.common import init_params
    c = attn.AttnCfg(64, kw.pop("n_heads", 4), kw.pop("n_kv_heads", 2), 16,
                     qkv_bias=True, tp=kw.pop("tp", 1), **kw)
    p = init_params(attn.attn_defs(c), torch.Generator().manual_seed(2))
    dp = {n: t.to(cuda) for n, t in p.items()}
    s_cache = c.window or c.chunk or 40
    ck = torch.zeros((2, s_cache, c.hkv, 16))
    cv = torch.zeros_like(ck)
    dck, dcv = ck.to(cuda), cv.to(cuda)
    xs = torch.randn((40, 2, 1, 64), generator=torch.Generator()
                     .manual_seed(3))
    for pos in range(40):
        y, ck, cv = attn.attn_decode(c, p, xs[pos], ck, cv, pos)
        dy, dck, dcv = attn.attn_decode(c, dp, xs[pos].to(cuda), dck, dcv,
                                        pos)
        _lm_close(dy, y)
        _lm_close(dck, ck)
        _lm_close(dcv, cv)


def test_lm_params_from_numpy_onto_cuda(cuda):
    """A JAX-layout numpy tree (layers stacked first) loads onto cuda and
    onto the CPU alike; the two generate the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.common import init_params
    from repro_torch.models.model import LM
    from repro_torch.serve.decode import generate

    def numpy_tree(t):
        return {k: numpy_tree(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.numpy()
    cfg = reduced(get_config("qwen1.5-4b"))
    cpu = LM(cfg, device="cpu", dtype=torch.float32)
    tree = numpy_tree(init_params(cpu.param_defs(),
                                  torch.Generator().manual_seed(4)))
    lm_params_from_numpy(tree, cpu)
    dev = lm_params_from_numpy(tree, LM(cfg, device=cuda,
                                        dtype=torch.float32))
    assert dev.layers[1].attn["wq"].device.type == "cuda"
    np.testing.assert_array_equal(dev.layers[1].attn["wq"].cpu().numpy(),
                                  tree["layers"]["attn"]["wq"][1])
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8), np.int32))
    want = generate(cpu, toks, max_new=6)
    got = generate(dev, toks.to(cuda), max_new=6)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_serve_launcher_on_cuda(cuda):
    """``launch.serve`` at its defaults on cuda (reduced widths,
    bfloat16): its closing line and tokens in the vocabulary."""
    from repro_torch.launch.serve import main
    res = main(["--arch", "tinyllama-1.1b"])
    out = res["out"]
    assert tuple(out.shape) == (8, 16) and out.device.type == "cuda"
    assert int(out.min()) >= 0 and int(out.max()) < res["cfg"].vocab_size
    assert res["line"].startswith("tinyllama-1.1b-smoke: (8, 16) in ")


# -- the ssm and hybrid families, and LM training: cuda against the CPU
#
# float32, reduced widths, the tolerances above (LM_TOL); gradients
# within 5e-4 of each leaf's largest CPU magnitude (the CPU parity tests'
# bound against JAX, tests/test_torch_lm_train.py).

LM_SSM = ["mamba2-130m", "zamba2-2.7b"]


def _lm_trainable_pair(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models.model import LM
    cfg = reduced(get_config(arch))
    cpu = LM(cfg, device="cpu", dtype=torch.float32, trainable=True)
    cpu.init(torch.Generator().manual_seed(0))
    dev = LM(cfg, device=cuda, dtype=torch.float32, trainable=True)
    dev.load_state_dict(cpu.state_dict())
    return cfg, cpu, dev


@pytest.mark.parametrize("arch", LM_SSM)
def test_lm_ssm_prefill_and_decode_on_cuda_equal_cpu(cuda, arch):
    """mamba2 / zamba2: prefill (hidden states, logits, token, every
    cache leaf) at S = 21 (a ragged chunk) and 20 decode steps (tokens,
    conv / SSM states, zamba2's per-site KV caches) on both devices."""
    from repro_torch import tree as ttree
    cfg, cpu, dev = _lm_pair(cuda, arch)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 21), np.int32))
    h, _ = cpu._forward(toks)
    dh, _ = dev._forward(toks.to(cuda))
    logits = cpu._logits(h[:, -1:])[:, 0]
    _lm_close(dh, h)
    _lm_close(dev._logits(dh[:, -1:])[:, 0], logits)
    tok, cache = cpu.prefill({"tokens": toks})
    dtok, dcache = dev.prefill({"tokens": toks.to(cuda)})
    _lm_tokens_agree(dtok, tok, logits)
    for got, want in zip(ttree.leaves(dcache), ttree.leaves(cache)):
        _lm_close(got, want)
    cache, dcache = cpu.init_cache(2, 20), dev.init_cache(2, 20)
    assert dcache["ssm"].dtype == torch.float32
    for pos in range(20):
        t = toks[:, pos:pos + 1]
        logits = cpu._logits(cpu._decode_hidden(
            ttree.map(torch.clone, cache), t, pos))[:, 0]
        nxt, cache = cpu.decode_step(cache, t, pos)
        dnxt, dcache = dev.decode_step(dcache, t.to(cuda), pos)
        _lm_tokens_agree(dnxt, nxt, logits)
        for got, want in zip(ttree.leaves(dcache), ttree.leaves(cache)):
            _lm_close(got, want)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-26b"] + LM_SSM)
def test_lm_loss_and_grads_on_cuda_equal_cpu(cuda, arch):
    """``LM.loss`` with remat (the default) and every leaf's gradient, on
    both devices."""
    from repro_torch import tree as ttree
    cfg, cpu, dev = _lm_trainable_pair(cuda, arch)
    rng = np.random.default_rng(7)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20),
                                             np.int32))
             for k in ("tokens", "targets")}
    if cfg.prefix_len:
        batch["prefix"] = torch.as_tensor(rng.normal(
            0, 1, (2, cfg.prefix_len, cfg.d_model)).astype(np.float32))
    loss, m = cpu.loss(batch)
    loss.backward()
    dloss, dm = dev.loss({k: v.to(cuda) for k, v in batch.items()})
    dloss.backward()
    np.testing.assert_allclose(float(dm["loss"]), float(m["loss"]),
                               rtol=1e-5)
    assert float(dm["acc"]) == float(m["acc"])
    for got, want in zip(ttree.leaves(dev.grads), ttree.leaves(cpu.grads)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                   atol=5e-4 * np.abs(want).max())


def test_train_step_on_cuda_equals_cpu(cuda):
    """Two 2-microbatch AdamW steps (clip 5, peak lr 1e-3, warmup 1) on
    both devices: metrics, moments to the gradients' tolerance, the
    parameters within a tenth of the summed learning rates at every
    entry and a thousandth on average (tests/test_torch_lm_train.py)."""
    from repro_torch import tree as ttree
    from repro_torch.optim import AdamWConfig, cosine_warmup
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    cfg, cpu, dev = _lm_trainable_pair(cuda, "tinyllama-1.1b")
    hp = TrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, n_micro=2,
                      adamw=AdamWConfig(clip_norm=5.0))
    states = {"cpu": init_train_state(cpu.params),
              "cuda": init_train_state(dev.params)}
    assert states["cuda"].step.device.type == "cuda"
    steps = {"cpu": make_train_step(cpu, hp), "cuda": make_train_step(dev, hp)}
    rng = np.random.default_rng(8)
    for _ in range(2):
        batch = {k: rng.integers(0, cfg.vocab_size, (4, 10), np.int32)
                 for k in ("tokens", "targets")}
        ms = {}
        for d in ("cpu", "cuda"):
            states[d], ms[d] = steps[d](states[d], batch)
        for k in ms["cpu"]:
            np.testing.assert_allclose(float(ms["cuda"][k]),
                                       float(ms["cpu"][k]), rtol=5e-4)
    lr_sum = sum(float(cosine_warmup(torch.tensor(i), peak_lr=1e-3,
                                     warmup=1, total=10)) for i in range(2))
    for got, want in zip(ttree.leaves(states["cuda"].params),
                         ttree.leaves(states["cpu"].params)):
        diff = (got.detach().cpu() - want.detach()).abs()
        assert float(diff.max()) <= 0.1 * lr_sum
        assert float(diff.mean()) <= 1e-3 * lr_sum
    for t in ("mu", "nu"):
        for got, want in zip(ttree.leaves(getattr(states["cuda"].opt, t)),
                             ttree.leaves(getattr(states["cpu"].opt, t))):
            want = want.numpy()
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                       atol=5e-4 * np.abs(want).max())


def test_bf16_and_train_state_checkpoint_from_cuda(cuda, tmp_path):
    """bfloat16 and float32 cuda leaves of a ``TrainState`` written by
    ``save_async`` (host copies taken up front) and restored onto cuda
    through ``shardings=`` bitwise."""
    from repro_torch import tree as ttree
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState
    gen = torch.Generator(device=cuda).manual_seed(9)
    params = {"w": torch.randn((4, 6), generator=gen, device=cuda),
              "b": torch.randn((6,), generator=gen, device=cuda)
              .to(torch.bfloat16)}
    state = TrainState(params=params, opt=adamw_init(params),
                       step=torch.tensor(5, dtype=torch.int32, device=cuda))
    want = ttree.map(torch.clone, state)
    t = ckpt.save_async(str(tmp_path), 5, state)
    params["w"].fill_(0)
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = ckpt.restore(str(tmp_path), 5, state, shardings=cuda)
    assert isinstance(got, TrainState)
    for a, b in zip(ttree.leaves(got), ttree.leaves(want)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


# -- the moe and encdec families: cuda against the CPU
#
# float32, reduced widths, LM_TOL.  Routing: the inputs' k-th and
# (k+1)-th gates must lie more than 1e-5 apart (a stated precondition:
# cuBLAS and the CPU round the router product differently, so a closer
# pair could route differently on the two devices); then the expert
# picks are equal.

LM_MOE_ENCDEC = ["llama4-scout-17b-a16e", "deepseek-v2-236b",
                 "seamless-m4t-large-v2"]


@pytest.mark.parametrize("case", [(64, 4, 1, 128, 1, 128, 3, 12),
                                  (64, 8, 2, 64, 2, 128, 3, 12),
                                  (64, 160, 6, 16, 2, 32, 8, 1)],
                         ids=["llama4-reduced", "deepseek-reduced",
                              "deepseek-E160-decode"])
def test_moe_apply_on_cuda_equals_cpu(cuda, case):
    """``moe_apply`` with dropped tokens (and a decode step's B=8, S=1
    at deepseek's E and k) on both devices: routing equal, output within
    LM_TOL."""
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    *args, b, s = case
    c = moe.MoECfg(*args)
    p = init_params(moe.moe_defs(c), torch.Generator().manual_seed(7))
    p["router"] = p["router"] * 8.0
    g = torch.Generator().manual_seed(8)
    x = torch.randn((64,), generator=g) + torch.randn((b, s, 64), generator=g)
    r = moe.moe_route(c, p["router"], x.reshape(-1, 64))
    top = r.gates.sort(-1, descending=True).values
    assert float((top[:, c.top_k - 1] - top[:, c.top_k]).min()) > 1e-5
    assert int((~r.keep).sum()) > 0
    dp = {k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict)
              else v.to(cuda)) for k, v in p.items()}
    dr = moe.moe_route(c, dp["router"], x.reshape(-1, 64).to(cuda))
    np.testing.assert_array_equal(dr.top_i.cpu().numpy(), r.top_i.numpy())
    np.testing.assert_array_equal(dr.keep.cpu().numpy(), r.keep.numpy())
    _lm_close(moe.moe_apply(c, dp, x.to(cuda)), moe.moe_apply(c, p, x))


@pytest.mark.parametrize("absorbed", [True, False])
@pytest.mark.parametrize("tp", [1, 3])
def test_mla_decode_on_cuda_equals_cpu(cuda, tp, absorbed):
    """``mla_decode`` step by step over 12 positions into a 10-slot
    latent cache (the last two clamp), both forms, padded heads."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models import mla
    from repro_torch.models.common import init_params
    cfg = reduced(get_config("deepseek-v2-236b"))
    c = mla.MLACfg(cfg.d_model, cfg.n_heads, kv_lora=cfg.kv_lora,
                   q_lora=cfg.q_lora, rope_head_dim=cfg.rope_head_dim,
                   nope_head_dim=cfg.nope_head_dim,
                   v_head_dim=cfg.v_head_dim, tp=tp)
    p = init_params(mla.mla_defs(c), torch.Generator().manual_seed(9))
    dp = {n: t.to(cuda) for n, t in p.items()}
    ckv, kpe = torch.zeros(2, 10, c.kv_lora), torch.zeros(2, 10,
                                                          c.rope_head_dim)
    dckv, dkpe = ckv.to(cuda), kpe.to(cuda)
    xs = torch.randn((12, 2, 1, 64), generator=torch.Generator()
                     .manual_seed(10))
    for pos in range(12):
        y, ckv, kpe = mla.mla_decode(c, p, xs[pos], ckv, kpe, pos,
                                     absorbed=absorbed)
        dy, dckv, dkpe = mla.mla_decode(c, dp, xs[pos].to(cuda), dckv, dkpe,
                                        pos, absorbed=absorbed)
        _lm_close(dy, y)
        _lm_close(dckv, ckv)
        _lm_close(dkpe, kpe)


@pytest.mark.parametrize("arch", LM_MOE_ENCDEC)
def test_lm_moe_encdec_prefill_and_decode_on_cuda_equal_cpu(cuda, arch):
    """llama4 / deepseek / seamless: prefill (hidden states, logits,
    token, every cache leaf; seamless with ``frames``) at S = 24 and 24
    decode steps (tokens and every cache leaf; llama4's chunk-16 ring
    wraps at position 16, a wrap that published widths, chunk 8,192,
    never reach in ``chip_smoke.py``) on both devices."""
    from repro_torch import tree as ttree
    cfg, cpu, dev = _lm_pair(cuda, arch)
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24),
                                        np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(
            0, 1, (2, 24 // cfg.enc_len_ratio, cfg.d_model))
            .astype(np.float32))
    dbatch = {k: t.to(cuda) for k, t in batch.items()}
    kw = {k: v for k, v in batch.items() if k == "frames"}
    h, _ = cpu._forward(toks, **kw)
    dh, _ = dev._forward(toks.to(cuda),
                         **{k: v for k, v in dbatch.items() if k == "frames"})
    logits = cpu._logits(h[:, -1:])[:, 0]
    _lm_close(dh, h)
    _lm_close(dev._logits(dh[:, -1:])[:, 0], logits)
    tok, cache = cpu.prefill(batch)
    dtok, dcache = dev.prefill(dbatch)
    _lm_tokens_agree(dtok, tok, logits)
    for got, want in zip(ttree.leaves(dcache), ttree.leaves(cache)):
        _lm_close(got, want)
    cache, dcache = cpu.init_cache(2, 24), dev.init_cache(2, 24)
    for pos in range(24):
        t = toks[:, pos:pos + 1]
        logits = cpu._logits(cpu._decode_hidden(
            ttree.map(torch.clone, cache), t, pos))[:, 0]
        nxt, cache = cpu.decode_step(cache, t, pos)
        dnxt, dcache = dev.decode_step(dcache, t.to(cuda), pos)
        _lm_tokens_agree(dnxt, nxt, logits)
        for got, want in zip(ttree.leaves(dcache), ttree.leaves(cache)):
            _lm_close(got, want)


# -- LM sharding: the dense family on a mesh of cuda members against the
# unsharded port on the CPU (float32, reduced widths, the tolerances
# above; gradients within 5e-4 of each leaf's largest, as
# tests/test_torch_lm_sharding.py)


def _mesh_of(cuda, kind):
    from repro_torch.launch.mesh import mesh_from_devices
    cpu = torch.device("cpu")
    if kind == "mixed":         # cross-device copies in every collective
        return mesh_from_devices([cuda, cpu, cuda, cpu], model=2)
    model = {"2x2": 2, "1x4": 4, "4x1": 1}[kind]
    return mesh_from_devices([cuda] * 4, model=model)


def _flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("kind", ["2x2", "1x4", "4x1", "mixed"])
def test_lm_mesh_on_cuda_equals_unsharded_cpu(cuda, kind):
    """tinyllama reduced on a mesh of cuda members (1x4: the KV heads
    replicated): logits, the prefill token, 4 decode steps, ``loss`` and
    every gradient against the unsharded model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models.model import LM
    mesh = _mesh_of(cuda, kind)
    tp = mesh.shape["model"]
    cfg = reduced(get_config("tinyllama-1.1b"))
    cpu = LM(cfg, tp=tp, device="cpu", dtype=torch.float32, trainable=True,
             remat=False).init(torch.Generator().manual_seed(0))
    dev = LM(cfg, tp=tp, mesh=mesh, dtype=torch.float32, trainable=True)
    for path, t in _flat_leaves(cpu.params):
        dev.load_leaf(path, t)
    for _, st in _flat_leaves(dev.params):
        assert [t.device.type for t in st.shards] == \
            [d.type for d in mesh.devices]
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 12),
                                             np.int32))
             for k in ("tokens", "targets")}
    with torch.no_grad():
        logits = cpu._logits(cpu._forward(batch["tokens"])[0])
    _lm_close(dev._mesh_exec().logits(batch), logits)
    tok, _ = cpu.prefill(batch)
    dtok, _ = dev.prefill(batch)
    _lm_tokens_agree(dtok, tok, logits[:, -1])
    cache, dcache = cpu.init_cache(4, 16), dev.init_cache(4, 16)
    for pos in range(4):
        t = batch["tokens"][:, pos:pos + 1]
        nxt, cache = cpu.decode_step(cache, t, pos)
        dnxt, dcache = dev.decode_step(dcache, t.to(cuda), pos)
        assert (dnxt.cpu() == nxt).all()
    _lm_close(dcache["k"].gather(), cache["k"])
    loss, _ = cpu.loss(batch)
    loss.backward()
    dloss, _ = dev.loss(batch)
    dloss.backward()
    dev.reduce_grads()
    np.testing.assert_allclose(float(dloss.detach()), float(loss.detach()),
                               rtol=1e-5)
    for path, g in _flat_leaves(dev.grads):
        want = _flat_get(cpu.grads, path).numpy()
        np.testing.assert_allclose(g.gather().numpy(), want, rtol=0,
                                   atol=5e-4 * np.abs(want).max())


def _flat_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_lm_mesh_train_step_and_launchers_on_cuda(cuda, tmp_path):
    """Two 2-microbatch AdamW steps on a (2, 2) mesh of cuda members
    against the unsharded CPU steps (the bounds of
    ``test_train_step_on_cuda_equals_cpu``), then both LM launchers'
    ``--mesh host4`` on cuda at reduced width."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.launch import serve, train
    from repro_torch.models.model import LM
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    cfg = reduced(get_config("tinyllama-1.1b"))
    cpu = LM(cfg, tp=2, device="cpu", dtype=torch.float32,
             trainable=True).init(torch.Generator().manual_seed(1))
    dev = LM(cfg, tp=2, mesh=_mesh_of(cuda, "2x2"), dtype=torch.float32,
             trainable=True)
    for path, t in _flat_leaves(cpu.params):
        dev.load_leaf(path, t)
    hp = TrainHParams(peak_lr=1e-3, warmup=0, total_steps=10, n_micro=2)
    sc, sd = init_train_state(cpu.params), init_train_state(dev.params)
    step_c, step_d = make_train_step(cpu, hp), make_train_step(dev, hp)
    rng = np.random.default_rng(9)
    lr_sum = 0.0
    for _ in range(2):
        batch = {k: rng.integers(0, cfg.vocab_size, (4, 10), np.int32)
                 for k in ("tokens", "targets")}
        sc, mc = step_c(sc, batch)
        sd, md = step_d(sd, batch)
        lr_sum += float(mc["lr"])
        np.testing.assert_allclose(float(md["loss"]), float(mc["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(md["grad_norm"]),
                                   float(mc["grad_norm"]), rtol=5e-4)
    for path, st in _flat_leaves(sd.params):
        diff = (st.gather() - _flat_get(sc.params, path).detach()).abs()
        assert float(diff.max()) <= 0.1 * lr_sum
        assert float(diff.mean()) <= 1e-3 * lr_sum
    res = serve.run(device="cuda", mesh="host4", max_new=4)
    assert res["mesh"].dims == (2, 2) and tuple(res["out"].shape) == (8, 4)
    out = train.run(device="cuda", mesh="host4", steps=2, seq=16,
                    ckpt_dir=str(tmp_path), ckpt_every=1)
    assert int(out["state"].step) == 2
    assert all(np.isfinite(out["losses"]))


# -- LM sharding: the moe family and length-sharded decode caches on a mesh
# of cuda members against the unsharded port on the CPU (float32, reduced
# widths, the tolerances above)

LM_MOE = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]


def _mesh_pair(cuda, arch, kind):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models.model import LM
    mesh = _mesh_of(cuda, kind)
    tp = mesh.shape["model"]
    cfg = reduced(get_config(arch))
    cpu = LM(cfg, tp=tp, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    dev = LM(cfg, tp=tp, mesh=mesh, dtype=torch.float32)
    for path, t in _flat_leaves(cpu.params):
        dev.load_leaf(path, t)
    return cfg, cpu, dev


@pytest.mark.parametrize("kind", ["2x2", "1x4", "mixed"])
@pytest.mark.parametrize("arch", LM_MOE)
def test_lm_moe_mesh_on_cuda_equals_unsharded_cpu(cuda, arch, kind,
                                                  monkeypatch):
    """llama4 / deepseek reduced on a mesh of cuda members (mixed: cuda
    and the CPU alternating, so the routing, the dispatch and the
    combine's running sum cross devices): logits, the prefill token, 4
    decode steps and their cache, and ``loss`` against the unsharded
    model on the CPU; each MoE layer routes once, on the first member."""
    from repro_torch import tree as ttree
    from repro_torch.models import sharded
    from repro_torch.models.moe import moe_route
    cfg, cpu, dev = _mesh_pair(cuda, arch, kind)
    routed = []
    monkeypatch.setattr(sharded, "moe_route", lambda *a: routed.append(
        a[2].device) or moe_route(*a))
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 12),
                                             np.int32))
             for k in ("tokens", "targets")}
    with torch.no_grad():
        logits = cpu._logits(cpu._forward(batch["tokens"])[0])
    _lm_close(dev._mesh_exec().logits(batch), logits)
    n_moe = sum(u.ffn == "moe" for u in dev._mesh_exec().units)
    assert len(routed) == n_moe and set(routed) == {dev.mesh.devices[0]}
    assert dev.mesh.devices[0].type == "cuda"
    tok, _ = cpu.prefill(batch)
    dtok, _ = dev.prefill(batch)
    _lm_tokens_agree(dtok, tok, logits[:, -1])
    cache, dcache = cpu.init_cache(4, 16), dev.init_cache(4, 16)
    for pos in range(4):
        t = batch["tokens"][:, pos:pos + 1]
        nxt, cache = cpu.decode_step(cache, t, pos)
        dnxt, dcache = dev.decode_step(dcache, t.to(cuda), pos)
        assert (dnxt.cpu() == nxt).all()
    for got, want in zip(ttree.leaves(dcache), ttree.leaves(cache),
                         strict=True):
        _lm_close(got.gather(), want)
    with torch.no_grad():
        loss, _ = cpu.loss(batch)
        dloss, _ = dev.loss(batch)
    np.testing.assert_allclose(float(dloss), float(loss), rtol=LM_TOL)


def _unit_module(lm, u):
    """The unsharded ``lm``'s module of mesh unit ``u``."""
    if u.prefix == ("blocks", "local"):
        return lm.blocks[u.idx[0]].local[u.idx[1]]
    if u.prefix == ("blocks", "global"):
        return lm.blocks[u.idx[0]]["global"]
    return lm.first if u.prefix == ("first",) else lm.layers[u.idx[0]]


@pytest.mark.parametrize("arch,kind,batch", [
    ("tinyllama-1.1b", "1x4", 1), ("tinyllama-1.1b", "2x2", 1),
    ("deepseek-v2-236b", "1x4", 4), ("deepseek-v2-236b", "mixed", 4),
    ("llama4-scout-17b-a16e", "1x4", 4)])
def test_lm_length_sharded_decode_on_cuda_equals_cpu(cuda, arch, kind, batch):
    """A cache of 1,024 positions whose spec shards its length (over
    ``model``: tinyllama's replicated KV heads at tp 4, deepseek's
    latents, llama4's global layers; over ``data``: tinyllama at B=1 on
    2x2), filled with the same random entries on both sides, at
    positions across the members' slices: tinyllama decodes whole steps
    (tokens and cache); the moe models step each unit's attention half
    on the same inputs (outputs and cache), so that a routing near-tie
    between the two devices' MoE halves cannot move what is compared."""
    from repro_torch import tree as ttree
    cfg, cpu, dev = _mesh_pair(cuda, arch, kind)
    cache, dcache = cpu.init_cache(batch, 1024), dev.init_cache(batch, 1024)

    def split(path, st):        # the member's length under the cache's
        ld = -2 if path[-1] in ("ckv", "kpe") else -3
        return st.shards[0].shape[ld] < st.shape[ld]
    assert any(split(p, st) for p, st in _flat_leaves(dcache))
    rng = np.random.default_rng(6)
    for t, d in zip(ttree.leaves(cache), ttree.leaves(dcache), strict=True):
        t.copy_(torch.as_tensor(rng.normal(0, 1, tuple(t.shape))
                                .astype(np.float32)))
        d.copy_(t)
    ex = dev._mesh_exec()
    for pos in (255, 256, 700, 1023, 1030):
        if cfg.family == "dense":
            tok = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                               (batch, 1), np.int32))
            nxt, cache = cpu.decode_step(cache, tok, pos)
            dnxt, dcache = dev.decode_step(dcache, tok.to(cuda), pos)
            assert (dnxt.cpu() == nxt).all(), pos
            continue
        rows = ex._rows(batch)
        work = ex._working(dcache, batch)
        for u in ex.units:
            x = torch.as_tensor(rng.normal(0, 1, (batch, 1, cfg.d_model))
                                .astype(np.float32))
            names = ("ckv", "kpe") if cfg.use_mla else ("k", "v")
            ca, cb = (_flat_get(cache, u.site + (n,))[u.idx] for n in names)
            want = cpu._attn_decode(u.attn, _unit_module(cpu, u), x, ca, cb,
                                    pos)
            got = ex._join(ex._attn_step(u, ex._split(x, rows), work, pos),
                           rows)
            _lm_close(got, want)
        ex._write_back(dcache, work)
    for got, want in zip(ttree.leaves(dcache), ttree.leaves(cache),
                         strict=True):
        _lm_close(got.gather(), want)


def test_lm_moe_serve_launcher_on_a_cuda_mesh(cuda):
    """``launch.serve.run(mesh="host4")`` on cuda at reduced width for
    both moe configs, deepseek with a length-sharded 1,024-position
    cache."""
    from repro_torch.launch import serve
    for arch in LM_MOE:
        kw = {"cache_len": 1024} if arch == "deepseek-v2-236b" else {}
        res = serve.run(arch, device="cuda", mesh="host4", batch=4,
                        prompt_len=8, max_new=4, **kw)
        assert res["mesh"].dims == (2, 2)
        out = res["out"]
        assert tuple(out.shape) == (4, 4) and out.device.type == "cuda"
        assert 0 <= int(out.min()) and int(out.max()) < res["cfg"].vocab_size


# -- LM sharding: the ssm, hybrid and encdec families on a mesh of cuda
# members against the unsharded port on the CPU (float32, reduced widths,
# the tolerances above; greedy tokens under the CPU logits' tie rule)

LM_SSM_MESH = ["mamba2-130m", "zamba2-2.7b", "seamless-m4t-large-v2"]


def _with_frames(cfg, batch, rng):
    """``batch`` plus seeded ``frames`` for an encdec config."""
    if cfg.family == "encdec":
        s = batch["tokens"].shape[1]
        batch["frames"] = torch.as_tensor(rng.normal(
            0, 1, (batch["tokens"].shape[0], s // cfg.enc_len_ratio,
                   cfg.d_model)).astype(np.float32))
    return batch


def _decode_both(cpu, dev, cache, dcache, toks, positions, cuda):
    """Decode steps on both at ``positions``: tokens under the tie rule
    against the CPU step's logits, then every cache leaf close."""
    from repro_torch import tree as ttree
    for pos, t in zip(positions, toks):
        logits = cpu._logits(cpu._decode_hidden(
            ttree.map(torch.clone, cache), t, pos))[:, 0]
        nxt, cache = cpu.decode_step(cache, t, pos)
        dnxt, dcache = dev.decode_step(dcache, t.to(cuda), pos)
        _lm_tokens_agree(dnxt, nxt, logits)
    for got, want in zip(ttree.leaves(dcache), ttree.leaves(cache),
                         strict=True):
        _lm_close(got.gather(), want)


@pytest.mark.parametrize("kind", ["2x2", "1x4", "mixed"])
@pytest.mark.parametrize("arch", LM_SSM_MESH)
def test_lm_ssm_encdec_mesh_on_cuda_equals_unsharded_cpu(cuda, arch, kind):
    """mamba2 / zamba2 / seamless reduced on a mesh of cuda members
    (mixed: cuda and the CPU alternating, so the ``in_proj`` block
    exchange, the norm's partial sums and the cross-attention's partials
    cross devices): logits (seamless over ``frames``), the prefill token
    and every cache leaf, 4 decode steps and their cache (conv / SSM
    states, k / v, the unwritten xk / xv), and ``loss``, against the
    unsharded model on the CPU."""
    from repro_torch import tree as ttree
    cfg, cpu, dev = _mesh_pair(cuda, arch, kind)
    rng = np.random.default_rng(8)
    batch = _with_frames(cfg, {k: torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (4, 12), np.int32)) for k in ("tokens",
                                                         "targets")}, rng)
    inputs = {k: v for k, v in batch.items() if k != "targets"}
    kw = {"frames": batch["frames"]} if "frames" in batch else {}
    with torch.no_grad():
        logits = cpu._logits(cpu._forward(batch["tokens"], **kw)[0])
    _lm_close(dev._mesh_exec().logits(inputs), logits)
    tok, pcache = cpu.prefill(inputs)
    dtok, dpcache = dev.prefill(inputs)
    _lm_tokens_agree(dtok, tok, logits[:, -1])
    for got, want in zip(ttree.leaves(dpcache), ttree.leaves(pcache),
                         strict=True):
        _lm_close(got.gather(), want)
    toks = [batch["tokens"][:, p:p + 1] for p in range(4)]
    _decode_both(cpu, dev, cpu.init_cache(4, 16), dev.init_cache(4, 16),
                 toks, range(4), cuda)
    with torch.no_grad():
        loss, _ = cpu.loss(batch)
        dloss, _ = dev.loss(batch)
    np.testing.assert_allclose(float(dloss), float(loss), rtol=LM_TOL)


@pytest.mark.parametrize("arch,kind", [
    ("zamba2-2.7b", "2x2"), ("zamba2-2.7b", "mixed"),
    ("seamless-m4t-large-v2", "2x2"), ("mamba2-130m", "1x4")])
def test_lm_ssm_encdec_b1_long_decode_on_cuda_equals_cpu(cuda, arch, kind):
    """A batch of 1 into a cache of 1,024 positions filled with the same
    random entries on both sides (xk / xv included): zamba2's shared
    block and seamless's self-attention split their length over
    ``data`` (sequence-parallel), mamba2's state splits ``P`` over
    ``model``; decode steps at positions across the members' slices give
    the CPU's tokens and cache."""
    from repro_torch import tree as ttree
    cfg, cpu, dev = _mesh_pair(cuda, arch, kind)
    cache, dcache = cpu.init_cache(1, 1024), dev.init_cache(1, 1024)
    rng = np.random.default_rng(12)
    for t, d in zip(ttree.leaves(cache), ttree.leaves(dcache), strict=True):
        t.copy_(torch.as_tensor(rng.normal(0, 1, tuple(t.shape))
                                .astype(np.float32)))
        d.copy_(t)
    positions = (255, 511, 512, 1023, 1030)
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1),
                                         np.int32)) for _ in positions]
    _decode_both(cpu, dev, cache, dcache, toks, positions, cuda)


def test_lm_ssm_encdec_serve_launcher_on_a_cuda_mesh(cuda):
    """``launch.serve.run(mesh="host4")`` on cuda at reduced width for the
    three families (seamless decodes without ``frames``, R6), zamba2
    also at a batch of 1 into a 1,024-position cache."""
    from repro_torch.launch import serve
    for arch, kw in (("mamba2-130m", {}), ("zamba2-2.7b", {}),
                     ("zamba2-2.7b", {"batch": 1, "cache_len": 1024}),
                     ("seamless-m4t-large-v2", {})):
        kw = {"batch": 4, **kw}
        res = serve.run(arch, device="cuda", mesh="host4", prompt_len=8,
                        max_new=4, **kw)
        assert res["mesh"].dims == (2, 2)
        out = res["out"]
        assert tuple(out.shape) == (kw["batch"], 4)
        assert out.device.type == "cuda"
        assert 0 <= int(out.min()) and int(out.max()) < res["cfg"].vocab_size
