"""Port parity: every ported VoteEngine backend against the JAX package's
same-named backend, bit for bit (prediction and class sums), plus the
engine layer's padding seam, tie-breaking, registry and cache.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.engine import get_engine as jget_engine
from repro.engine import infer_padded as jinfer_padded
from repro_torch.convert import state_from_numpy
from repro_torch.core.tm import TMConfig
from repro_torch.engine import (EngineResult, ServiceStats,
                                available_backends, clear_engine_cache,
                                engine_cache_info, evict_engines_for_state,
                                get_engine, infer_padded, nearest_rank,
                                pad_batch, state_nbytes)

PORTED = ["adder_tree", "mxu_fused", "oracle", "swar_fused", "swar_packed"]
SHAPES = [(2, 6, 9), (3, 10, 12), (4, 8, 40)]


def _random_tm(c, m, f, *, density=0.15, seed=0, batch=17):
    """numpy ta + literals, built like tests/test_engine.py::_random_tm."""
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
        .astype(np.int32)
    lits = rng.integers(0, 2, (batch, 2 * f), dtype=np.int8)
    return ta, lits


def _both(c, m, f, ta):
    jcfg = JConfig(n_classes=c, n_clauses=m, n_features=f)
    tcfg = TMConfig(n_classes=c, n_clauses=m, n_features=f)
    return (jcfg, JState(ta=jnp.asarray(ta)),
            tcfg, state_from_numpy(ta, device="cpu"))


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got.prediction),
                                  np.asarray(want.prediction))
    np.testing.assert_array_equal(np.asarray(got.class_sums),
                                  np.asarray(want.class_sums))


def test_registry_holds_the_ported_backends():
    assert available_backends() == PORTED


@pytest.mark.parametrize("name", ["sparse_csr", "time_domain", "cascade"])
def test_unported_backends_raise(name):
    _, _, cfg, st = _both(2, 4, 3, _random_tm(2, 4, 3)[0])
    with pytest.raises(KeyError, match="unknown VoteEngine backend"):
        get_engine(name, cfg, st)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "C{}M{}F{}".format(*s))
@pytest.mark.parametrize("backend", PORTED)
def test_backend_parity_vs_jax(backend, shape):
    ta, lits = _random_tm(*shape, seed=sum(shape))
    jcfg, jst, tcfg, tst = _both(*shape, ta)
    want = jget_engine(backend, jcfg, jst).infer(jnp.asarray(lits))
    got = get_engine(backend, tcfg, tst).infer(torch.from_numpy(lits))
    assert isinstance(got, EngineResult)
    assert got.prediction.dtype == torch.int32
    assert got.class_sums.dtype == torch.int32
    _assert_same(got, want)


@pytest.mark.parametrize("density", [0.0, 1.0])
@pytest.mark.parametrize("backend", PORTED)
def test_backend_parity_density_extremes(backend, density):
    """No-include (every clause fires: sums tie at 0 with even M) and
    all-include (a clause fires only on an all-ones literal row)."""
    ta, lits = _random_tm(3, 6, 7, density=density, seed=9)
    lits[0] = 1
    jcfg, jst, tcfg, tst = _both(3, 6, 7, ta)
    want = jget_engine("oracle", jcfg, jst).infer(jnp.asarray(lits))
    _assert_same(get_engine(backend, tcfg, tst).infer(lits), want)


@pytest.mark.parametrize("backend", PORTED)
def test_backend_tie_break_lowest_index(backend):
    """Duplicate class blocks ⇒ exactly tied sums ⇒ lowest index wins."""
    ta, lits = _random_tm(4, 8, 11, seed=3)
    ta[2] = ta[1] = ta[0]
    jcfg, jst, tcfg, tst = _both(4, 8, 11, ta)
    got = get_engine(backend, tcfg, tst).infer(lits)
    sums = got.class_sums.numpy()
    np.testing.assert_array_equal(sums[:, 0], sums[:, 1])
    np.testing.assert_array_equal(got.prediction.numpy(), np.argmax(sums, -1))
    assert set(got.prediction.tolist()) <= {0, 3}
    _assert_same(got, jget_engine("oracle", jcfg, jst).infer(
        jnp.asarray(lits)))


@pytest.mark.parametrize("backend", PORTED)
def test_infer_padded_neutral(backend):
    """Zero pad rows change nothing: padded results equal unpadded ones
    and the JAX seam's, for numpy (host) and tensor callers."""
    ta, lits = _random_tm(3, 7, 9, seed=4, batch=5)
    jcfg, jst, tcfg, tst = _both(3, 7, 9, ta)
    eng = get_engine(backend, tcfg, tst)
    plain = eng.infer(lits)
    host = infer_padded(eng, lits, 8)
    assert isinstance(host.prediction, np.ndarray)
    assert host.prediction.shape == (5,) and host.class_sums.shape == (5, 3)
    _assert_same(host, plain)
    dev = infer_padded(eng, torch.from_numpy(lits), 16)
    assert isinstance(dev.prediction, torch.Tensor)
    _assert_same(dev, plain)
    _assert_same(host, jinfer_padded(jget_engine(backend, jcfg, jst),
                                     lits, 8))
    exact = infer_padded(eng, lits, 5)          # no padding: still numpy
    assert isinstance(exact.class_sums, np.ndarray)
    _assert_same(exact, plain)


def test_pad_batch():
    lits = np.ones((3, 4), np.int8)
    out = pad_batch(lits, 5)
    assert isinstance(out, np.ndarray) and out.shape == (5, 4)
    assert out[3:].sum() == 0
    assert pad_batch(lits, 3) is lits
    t = pad_batch(torch.from_numpy(lits), 4)
    assert t.shape == (4, 4) and t.dtype == torch.int8 and t[3].sum() == 0
    with pytest.raises(ValueError, match="does not fit"):
        pad_batch(lits, 2)


def test_engine_cache_keys_state_identity_and_evicts():
    clear_engine_cache()
    ta, _ = _random_tm(2, 4, 5, seed=1)
    _, _, cfg, st = _both(2, 4, 5, ta)
    a = get_engine("oracle", cfg, st)
    assert get_engine("oracle", cfg, st) is a
    assert get_engine("oracle", cfg, st, cache=False) is not a
    # a different tensor with equal contents is a different state
    other = state_from_numpy(ta, device="cpu")
    assert get_engine("oracle", cfg, other) is not a
    info = engine_cache_info()
    assert info["hits"] == 1 and info["misses"] == 2 and info["size"] == 2
    assert evict_engines_for_state(st) == 1
    assert engine_cache_info()["superseded"] == 1
    del other
    gc.collect()                   # the weakref callback drops its entry
    assert engine_cache_info()["size"] == 0
    assert state_nbytes(st) == ta.nbytes
    clear_engine_cache()


def test_engine_cache_lru_bound():
    from repro_torch.engine.base import KeyedEngineCache
    cache = KeyedEngineCache(maxsize=2)
    states = [(torch.zeros(1),) for _ in range(3)]
    for i, s in enumerate(states):
        cache.insert(("k", i), s, f"e{i}")
    assert cache.get(("k", 0)) is None and cache.get(("k", 2)) == "e2"
    info = cache.info()
    assert info["size"] == 2 and info["evictions"] == 1
    assert info["misses"] == info["size"] + info["evictions"] + \
        info["superseded"]


def test_service_stats_and_nearest_rank():
    assert nearest_rank([1, 2, 3, 4], 0.5) == 2
    assert nearest_rank([5], 0.99) == 5
    svc = ServiceStats(alpha=0.5, window=3)
    for s in (0.004, 0.002, 0.006, 0.008):
        svc.observe(8, s)
    assert svc.floor(8) == 0.002 and svc.floor(1) is None
    assert svc.ewma(8) == pytest.approx(0.5 * 0.008 + 0.5 * (
        0.5 * 0.006 + 0.5 * (0.5 * 0.002 + 0.5 * 0.004)))
    snap = svc.snapshot()[8]
    assert snap["count"] == 4 and snap["min_ms"] == 2.0
    with pytest.raises(ValueError):
        ServiceStats(alpha=0.0)
