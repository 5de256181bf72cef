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
from repro_torch.core import prng
from repro_torch.core.popcount import pack_bits
from repro_torch.core.tm import TMConfig
from repro_torch.engine import (available_backends, get_engine,
                                get_train_engine)
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
from repro_torch.serve import ServePolicy, TMServer

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


def _k2_inputs(dev, b, c, m, lit, density, seed, masks_on=True):
    g = torch.Generator().manual_seed(seed)
    lits = torch.randint(0, 2, (b, lit), generator=g, dtype=torch.int8)
    inc = (torch.rand((c, m, lit), generator=g) < density).to(torch.int8)
    keys = prng.bits(prng.key(seed), (2, b, 2))
    masks = [(torch.rand((b, m), generator=g) < 0.5) & masks_on
             for _ in range(4)]
    y = torch.randint(0, c, (b,), generator=g, dtype=torch.int32)
    yn = ((y + torch.randint(1, max(c, 2), (b,), generator=g)) % c) \
        .to(torch.int32)
    return [t.to(dev) for t in (lits, keys[0], keys[1], inc, *masks, y, yn)]


# (B, C, M, L, density, masks on): tm-mnist-50 widths, ragged shapes, a
# class count above the kernel's 16-class tile, density extremes, and all
# masks off (a zero update)
K2_CASES = [(32, 10, 50, 1568, 0.05, True), (37, 10, 50, 1568, 1.0, True),
            (1, 10, 50, 1568, 0.0, True), (64, 3, 7, 18, 0.3, True),
            (40, 37, 5, 33, 0.2, True), (9, 4, 6, 40, 0.1, False)]


@pytest.mark.parametrize("case", K2_CASES,
                         ids=lambda c: "B{}C{}M{}L{}-d{}-{}".format(
                             *c[:5], "masks" if c[5] else "off"))
def test_train_deltas_kernel_bitwise_vs_plain(cuda, case):
    b, c, m, lit, density, on = case
    args = _k2_inputs(cuda, b, c, m, lit, density, seed=b + c + m,
                      masks_on=on)
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
        assert bool(got.any()) == (on and b > 0)


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


@pytest.mark.parametrize("m,k,n", [(1, 784, 128), (37, 129, 65),
                                   (1024, 1024, 1024), (70, 3, 1),
                                   (5, 1, 9), (129, 64, 200)])
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


def test_binary_matmul_kernel_any_int8(cuda):
    """The int32 accumulation is exact for any int8 operands, not only
    ±1, and for a K that is not a multiple of 4 (byte loads)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randint(-128, 128, (33, 77), generator=g).to(torch.int8)
    w = torch.randint(-128, 128, (77, 40), generator=g).to(torch.int8)
    got = binary_matmul(x.to(cuda), w.to(cuda))
    assert torch.equal(got.cpu(), x.to(torch.int32) @ w.to(torch.int32))


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


@pytest.mark.parametrize("b,c,m", [(1, 10, 50), (37, 10, 50),
                                   (1024, 10, 100), (37, 1, 50),
                                   (20, 3000, 4), (9, 33, 1)])
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
