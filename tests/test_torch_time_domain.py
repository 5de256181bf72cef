"""Port parity for the paper's time-domain surface: ``prng.normal``,
``core/time_domain`` (PDL delays, the arbiter race, async latency), the
``time_domain`` engine and ``TMServer(backend="time_domain")``, each
against the JAX package on the same numpy inputs.

Tolerances, with their reasons:

- ``prng.normal`` vs ``jax.random.normal``: the uniforms are bit for
  bit; ``erfinv`` is XLA's polynomial step for step but its ``log1p`` is
  XLA's own, so draws agree to allclose(rtol=1e-6, atol=1e-6) (measured:
  a few float32 ulps).
- ``pdl_delays``: float32 sums over M elements in torch's order, not
  XLA's → rtol 1e-6.  ``race`` and ``async_latency`` on identical delays:
  bitwise.
- ``time_domain`` engine, ideal device: prediction, class sums,
  ``latency_ps`` and ``metastable`` bitwise (the port rounds XLA's fused
  multiply-add once too).  Device path: ``latency_ps`` rtol 1e-6,
  prediction and ``metastable`` exact on these seeds, where no arbiter
  gap lies within float rounding of a tie or of ``t_res``.

Agreement between a physical device and the ideal one is physics, not
parity: no bar on it is inherited from the JAX suite.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import time_domain as jtd
from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.core.tm import clause_polarity as jclause_polarity
from repro.engine import get_engine as jget_engine
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMServer as JServer
from repro_torch.convert import device_from_numpy, state_from_numpy
from repro_torch.core import prng
from repro_torch.core import time_domain as td
from repro_torch.core.tm import TMConfig, clause_polarity
from repro_torch.engine import get_engine, infer_padded
from repro_torch.serve import ServePolicy, TMServer

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

LIMIT_S = 120          # wall-clock bound on every event-loop test


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _key(seed):
    return prng.wrap_key_data(jax.random.key_data(jax.random.key(seed)))


def _dev(jdev):
    return device_from_numpy(np.asarray(jdev.elem_offset),
                             np.asarray(jdev.skew), device="cpu")


# --- prng.normal ---------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, ()), (5, (7,)),
                                        (2**32 + 5, (10, 50, 2)),
                                        (11, (128, 256))])
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(_key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_normal_batched_keys_match_vmap():
    keys = jax.random.split(jax.random.key(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (5, 3)))(keys))
    got = prng.normal(prng.wrap_key_data(jax.random.key_data(keys)), (5, 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_make_device_matches_jax():
    cfg = jtd.PDLConfig(sigma_elem=2.0)
    want = jtd.make_device(cfg, 10, 50, jax.random.key(5), skew_ps=30.0)
    got = td.make_device(td.PDLConfig(sigma_elem=2.0), 10, 50, _key(5),
                         skew_ps=30.0)
    # sigma · normal: the normal's tolerance scaled by sigma
    np.testing.assert_allclose(got.elem_offset.numpy(),
                               np.asarray(want.elem_offset), rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_allclose(got.skew.numpy(), np.asarray(want.skew),
                               rtol=1e-6, atol=3e-5)


# --- pdl_delays, race, async_latency ------------------------------------

@pytest.mark.parametrize("noise", [False, True])
def test_pdl_delays_match_jax(noise):
    cfg = jtd.PDLConfig(sigma_elem=2.0, sigma_noise=0.5)
    b, c, m = 17, 10, 100
    bits = np.random.default_rng(1).integers(0, 2, (b, c, m), dtype=np.int8)
    jdev = jtd.make_device(cfg, c, m, jax.random.key(5), skew_ps=20.0)
    want = np.asarray(jtd.pdl_delays(
        cfg, jdev, jnp.asarray(bits), jclause_polarity(m),
        key=jax.random.key(6) if noise else None))
    got = td.pdl_delays(td.PDLConfig(sigma_elem=2.0, sigma_noise=0.5),
                        _dev(jdev), torch.from_numpy(bits),
                        clause_polarity(m), key=_key(6) if noise else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_race_and_async_latency_bitwise_on_identical_delays():
    """Ties, near ties (within t_res), infinities and class counts that
    are not powers of two: winner, latency, flag and async latency all
    bitwise."""
    rng = np.random.default_rng(2)
    cfg = jtd.PDLConfig(t_res=10.0)
    for c in (1, 2, 3, 5, 8, 10):
        d = rng.integers(0, 40, (64, c)).astype(np.float32) * 7.5
        d[0] = 100.0                                 # all tied
        if c > 2:
            d[1, 2] = np.inf
        want = jtd.race(cfg, jnp.asarray(d))
        got = td.race(td.PDLConfig(t_res=10.0), torch.from_numpy(d))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got.winner.dtype == torch.int32
        np.testing.assert_array_equal(
            td.async_latency(td.PDLConfig(), got, c, 3000.0).numpy(),
            np.asarray(jtd.async_latency(jtd.PDLConfig(), want, c, 3000.0)))


def test_delay_monotone_in_hamming_weight_fig6():
    """Paper Fig. 6, ideal device: delay strictly decreasing in Hamming
    weight, Spearman ρ = −1 (tests/test_time_domain.py's case)."""
    cfg = td.PDLConfig(sigma_elem=0.0, sigma_noise=0.0)
    m = 150
    dev = td.PDLDevice(torch.zeros((1, m, 2)), torch.zeros((1,)))
    bits = np.zeros((m + 1, 1, m), np.int8)
    for w in range(m + 1):
        bits[w, 0, :w] = 1
    d = td.pdl_delays(cfg, dev, torch.from_numpy(bits),
                      torch.ones(m, dtype=torch.int32))[:, 0].numpy()
    assert (np.diff(d) < 0).all()
    assert td.spearman_rho(np.arange(m + 1), d) == pytest.approx(-1.0)


def test_monotonicity_under_variation_fig6():
    """With process variation and jitter, ρ ≈ −1 and the larger Δ is at
    least as monotone — on the JAX device and key, carried across."""
    m = 150
    rhos = {}
    for name, (low, high) in {"d60ps": (0.5, 0.56),
                              "d600ps": (0.38, 0.98)}.items():
        kw = dict(d_low=low * 1000, d_high=high * 1000, sigma_elem=12.0,
                  sigma_noise=4.0)
        jdev = jtd.make_device(jtd.PDLConfig(**kw), 1, m, jax.random.key(3))
        weights = np.arange(0, m + 1, 5)
        bits = np.zeros((len(weights), 1, m), np.int8)
        rng = np.random.default_rng(0)
        for i, w in enumerate(weights):
            bits[i, 0, rng.choice(m, w, replace=False)] = 1
        d = td.pdl_delays(td.PDLConfig(**kw), _dev(jdev),
                          torch.from_numpy(bits),
                          torch.ones(m, dtype=torch.int32), key=_key(1))
        rhos[name] = td.spearman_rho(weights, d[:, 0].numpy())
        assert rhos[name] == jtd.spearman_rho(
            weights, np.asarray(jtd.pdl_delays(
                jtd.PDLConfig(**kw), jdev, jnp.asarray(bits),
                jnp.ones((m,), jnp.int32), key=jax.random.key(1)))[:, 0])
    assert rhos["d60ps"] < -0.95
    assert rhos["d600ps"] < rhos["d60ps"] + 0.02


def test_metastability_flag_on_near_ties():
    cfg = td.PDLConfig(sigma_elem=0.0, sigma_noise=0.0, t_res=10.0)
    res = td.race(cfg, torch.tensor([[100.0, 105.0, 400.0],
                                     [100.0, 400.0, 800.0]]))
    assert res.metastable.tolist() == [True, False]
    assert res.winner.tolist() == [0, 0]


# --- the time_domain engine ----------------------------------------------

def _random_tm(c, m, f, *, density=0.15, seed=0, batch=17):
    """numpy ta + literals, built like tests/test_engine.py::_random_tm."""
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
        .astype(np.int32)
    lits = rng.integers(0, 2, (batch, 2 * f), dtype=np.int8)
    return ta, lits


def _assert_engine_equal(got, want, *, exact_latency=True):
    np.testing.assert_array_equal(got.prediction.numpy(),
                                  np.asarray(want.prediction))
    np.testing.assert_array_equal(got.class_sums.numpy(),
                                  np.asarray(want.class_sums))
    np.testing.assert_array_equal(got.aux["metastable"].numpy(),
                                  np.asarray(want.aux["metastable"]))
    lat = got.aux["latency_ps"]
    assert lat.dtype == torch.float32 and lat.shape == got.prediction.shape
    if exact_latency:
        np.testing.assert_array_equal(lat.numpy(),
                                      np.asarray(want.aux["latency_ps"]))
    else:
        np.testing.assert_allclose(lat.numpy(),
                                   np.asarray(want.aux["latency_ps"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 10, 16), (3, 8, 10), (10, 50, 64),
                                   (2, 7, 5)],
                         ids=lambda s: "C{}M{}F{}".format(*s))
def test_time_domain_engine_ideal_bitwise(shape):
    c, m, f = shape
    ta, lits = _random_tm(c, m, f, seed=sum(shape))
    want = jget_engine("time_domain", JConfig(c, m, f),
                       JState(ta=jnp.asarray(ta))).infer(jnp.asarray(lits))
    got = get_engine("time_domain", TMConfig(c, m, f),
                     state_from_numpy(ta, device="cpu")).infer(lits)
    _assert_engine_equal(got, want)
    oracle = get_engine("oracle", TMConfig(c, m, f),
                        state_from_numpy(ta, device="cpu")).infer(lits)
    np.testing.assert_array_equal(got.prediction, oracle.prediction)


@pytest.mark.parametrize("noise", [False, True])
def test_time_domain_engine_device_path(noise):
    c, m, f = 4, 10, 16
    ta, lits = _random_tm(c, m, f, seed=9)
    jpdl = jtd.PDLConfig(sigma_elem=2.0, sigma_noise=0.5)
    jdev = jtd.make_device(jpdl, c, m, jax.random.key(1))
    want = jget_engine("time_domain", JConfig(c, m, f),
                       JState(ta=jnp.asarray(ta)), pdl=jpdl, device=jdev,
                       noise_key=jax.random.key(4) if noise else None
                       ).infer(jnp.asarray(lits))
    got = get_engine("time_domain", TMConfig(c, m, f),
                     state_from_numpy(ta, device="cpu"),
                     pdl=td.PDLConfig(sigma_elem=2.0, sigma_noise=0.5),
                     device=_dev(jdev),
                     noise_key=_key(4) if noise else None).infer(lits)
    _assert_engine_equal(got, want, exact_latency=False)


def test_time_domain_engine_padding_and_aux_slicing():
    """infer_padded strips pad rows from aux as from the prediction."""
    c, m, f = 3, 8, 10
    ta, lits = _random_tm(c, m, f, seed=4, batch=5)
    eng = get_engine("time_domain", TMConfig(c, m, f),
                     state_from_numpy(ta, device="cpu"))
    full = eng.infer(lits)
    padded = infer_padded(eng, lits, 16)
    for k in ("latency_ps", "metastable"):
        assert padded.aux[k].shape == (5,)
        np.testing.assert_array_equal(np.asarray(padded.aux[k]),
                                      full.aux[k].numpy())


# --- TMServer(backend="time_domain") -------------------------------------

def test_server_time_domain_matches_jax_server():
    """One mixed-size trace through both servers pinned to time_domain:
    identical predictions, class sums and per-row aux."""
    c, m, f = 3, 7, 9
    ta, _ = _random_tm(c, m, f, seed=21)
    rng = np.random.default_rng(22)
    sizes = [1, 3, 2, 5, 1, 1, 4, 2, 7, 1, 3]
    reqs = [rng.integers(0, 2, (n, 2 * f), dtype=np.int8) for n in sizes]
    kw = dict(max_batch=8, max_wait_us=500, backend="time_domain")

    async def serve(server):
        async with server:
            return await asyncio.gather(
                *[server.submit(lits, client=i % 3)
                  for i, lits in enumerate(reqs)])

    jres = _run(serve(JServer(JConfig(c, m, f), JState(ta=jnp.asarray(ta)),
                              JPolicy(**kw))))
    tres = _run(serve(TMServer(TMConfig(c, m, f),
                               state_from_numpy(ta, device="cpu"),
                               ServePolicy(**kw), device="cpu")))
    for lits, want, got in zip(reqs, jres, tres):
        np.testing.assert_array_equal(got.prediction,
                                      np.asarray(want.prediction))
        np.testing.assert_array_equal(got.class_sums,
                                      np.asarray(want.class_sums))
        assert set(got.aux) == set(want.aux) == {"latency_ps", "metastable"}
        for k in got.aux:
            assert got.aux[k].shape == (len(lits),)
            np.testing.assert_array_equal(got.aux[k], np.asarray(want.aux[k]))


def test_launcher_time_domain_on_cpu(capsys):
    from repro_torch.launch.tm_serve import main
    main(["--device", "cpu", "--backend", "time_domain", "--classes", "3",
          "--clauses", "4", "--features", "6", "--clients", "2",
          "--duration", "0.3", "--stats-every", "0.1"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "closed-loop x2" in out
