"""Port parity: the ``repro_torch`` early-exit cascade, mirroring
``tests/test_cascade``: predictions equal to the full backend's at every
density, shape and stage-1 fraction, exact ties and margin-one near
ties, the indicator machine settling every row, ``exact_sums=False``,
the subsample layout, option validation, the registry, padding, the
engine cache and the server shed tier end to end.

Every parity case also holds the port to the JAX package's
``CascadeEngine`` on the same inputs: prediction, class sums and
``aux["escalated"]`` bit for bit.  The JAX ``_infer_traced`` fallback has
no counterpart (torch has no tracer), so its test is not mirrored.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.engine import get_engine as jget_engine
from repro.engine.cascade import subsample_mask as jsubsample_mask
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMServer as JServer
from repro_torch.convert import state_from_numpy
from repro_torch.core.tm import TMConfig
from repro_torch.engine import (EngineResult, available_backends,
                                engine_cache_info, get_engine, infer_padded)
from repro_torch.engine.cascade import (CascadeEngine, _next_pow2,
                                        subsample_mask)
from repro_torch.kernels.swar_fused import swar_fused_votes
from repro_torch.serve import ServePolicy, TMServer

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

DENSITIES = (0.0, 0.05, 0.3, 1.0)
SHAPES = [(2, 6, 9), (3, 10, 12), (5, 7, 33), (10, 25, 49)]

# wall-clock bound on every event-loop run
LIMIT_S = 120


def _run(coro):
    """``asyncio.run(coro)`` under the ``LIMIT_S`` wall-clock limit."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _random_tm(c, m, f, *, density=0.15, seed=0, batch=17):
    """numpy ta + literals, built like tests/test_cascade.py::_random_tm."""
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
        .astype(np.int32)
    lits = rng.integers(0, 2, (batch, 2 * f), dtype=np.int8)
    return TMConfig(n_classes=c, n_clauses=m, n_features=f), ta, lits


def _indicator_tm(c=4, m=32, f=16):
    """The wide-margin machine of tests/test_cascade.py: class k's
    +clauses include x_k, its −clauses ¬x_k; one-hot rows."""
    ta = np.full((c, m, 2 * f), 128, np.int32)
    for k in range(c):
        ta[k, 0::2, k] = 129
        ta[k, 1::2, f + k] = 129
    rows = np.zeros((c, 2 * f), np.int8)
    rows[np.arange(c), np.arange(c)] = 1
    rows[:, f:] = 1 - rows[:, :f]
    return TMConfig(n_classes=c, n_clauses=m, n_features=f), ta, rows


def _st(ta):
    return state_from_numpy(ta, device="cpu")


def _jax(cfg, ta, lits, **opts):
    """The JAX package's cascade on the same inputs."""
    jcfg = JConfig(n_classes=cfg.n_classes, n_clauses=cfg.n_clauses,
                   n_features=cfg.n_features)
    return jget_engine("cascade", jcfg, JState(ta=jnp.asarray(ta)),
                       **opts).infer(jnp.asarray(lits))


def _assert_same(res, ref, *, sums=True):
    np.testing.assert_array_equal(np.asarray(res.prediction),
                                  np.asarray(ref.prediction))
    if sums:
        np.testing.assert_array_equal(np.asarray(res.class_sums),
                                      np.asarray(ref.class_sums))


def _assert_jax(res, cfg, ta, lits, **opts):
    """Prediction, class sums and ``escalated`` equal JAX's, bitwise."""
    want = _jax(cfg, ta, lits, **opts)
    _assert_same(res, want)
    esc = res.aux["escalated"]
    assert esc.dtype == torch.bool and esc.shape == (lits.shape[0],)
    np.testing.assert_array_equal(esc.numpy(),
                                  np.asarray(want.aux["escalated"]))


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: f"C{s[0]}M{s[1]}F{s[2]}")
def test_parity_across_densities(shape, density):
    """Bit-exact vs the oracle and JAX's cascade at every density,
    including the all-empty (0.0) and all-included (1.0) extremes."""
    cfg, ta, lits = _random_tm(*shape, density=density, seed=sum(shape))
    ref = get_engine("oracle", cfg, _st(ta)).infer(lits)
    res = get_engine("cascade", cfg, _st(ta)).infer(lits)
    assert isinstance(res, EngineResult)
    _assert_same(res, ref)
    _assert_jax(res, cfg, ta, lits)


@pytest.mark.parametrize("fraction", (0.01, 0.33, 0.625, 1.0))
def test_parity_across_fractions(fraction):
    """Any stage-1 fraction is exact; 1.0 makes the bound width zero so
    every row settles without escalation."""
    cfg, ta, lits = _random_tm(3, 10, 12, density=0.2, seed=5)
    ref = get_engine("oracle", cfg, _st(ta)).infer(lits)
    res = get_engine("cascade", cfg, _st(ta),
                     stage1_fraction=fraction).infer(lits)
    _assert_same(res, ref)
    _assert_jax(res, cfg, ta, lits, stage1_fraction=fraction)
    if fraction == 1.0:
        assert not res.aux["escalated"].any()


def test_exact_ties_duplicated_classes():
    """Duplicated class blocks ⇒ margin-0 ties everywhere; the strict
    bound against lower indices reproduces ties → lowest exactly."""
    cfg, ta, lits = _random_tm(4, 8, 11, density=0.2, seed=3)
    ta[2] = ta[1] = ta[0]
    ref = get_engine("oracle", cfg, _st(ta)).infer(lits)
    res = get_engine("cascade", cfg, _st(ta), stage1_fraction=0.5) \
        .infer(lits)
    _assert_same(res, ref)
    _assert_jax(res, cfg, ta, lits, stage1_fraction=0.5)


def test_margin_one_near_ties():
    """Class 1 is class 0 plus one always-firing positive clause: the
    winner flips on a single vote."""
    cfg = TMConfig(n_classes=2, n_clauses=6, n_features=5)
    rng = np.random.default_rng(11)
    ta = np.where(rng.random((2, 6, 10)) < 0.25, 129, 128).astype(np.int32)
    ta[1] = ta[0]
    # clause 4 (even ⇒ +1): x_0 AND ¬x_0 for class 0 — never fires;
    # empty for class 1 — always fires
    ta[0, 4, :] = 128
    ta[0, 4, 0] = ta[0, 4, 5] = 129
    ta[1, 4, :] = 128
    x = rng.integers(0, 2, (32, 5), dtype=np.int8)
    lits = np.concatenate([x, 1 - x], axis=1)
    ref = get_engine("oracle", cfg, _st(ta)).infer(lits)
    for fraction in (0.5, 0.75):
        res = get_engine("cascade", cfg, _st(ta),
                         stage1_fraction=fraction).infer(lits)
        _assert_same(res, ref)
        _assert_jax(res, cfg, ta, lits, stage1_fraction=fraction)
        sums = ref.class_sums.numpy()
        assert (np.abs(sums[:, 1] - sums[:, 0]) == 1).all()


def test_wide_margin_settles_without_escalation():
    """The indicator machine settles every one-hot row in stage 1 at the
    default fraction; stage 1 and the completion pass are one K1 call
    each, and nothing escalates."""
    cfg, ta, rows = _indicator_tm()
    eng = get_engine("cascade", cfg, _st(ta), cache=False)
    res = eng.infer(rows)
    ref = get_engine("oracle", cfg, _st(ta)).infer(rows)
    _assert_same(res, ref)
    _assert_jax(res, cfg, ta, rows)
    assert not res.aux["escalated"].any()
    np.testing.assert_array_equal(res.prediction.numpy(),
                                  np.arange(cfg.n_classes))
    assert eng.passes == {"stage1": 1, "completion": 1, "escalation": 0}


def test_exact_sums_false_predictions_exact():
    """``exact_sums=False`` (the shed-tier default): predictions exact on
    every row; escalated rows carry full-backend sums; settled rows the
    stage-1 midpoint, which still ranks the winner first."""
    cfg, ta, lits = _random_tm(5, 7, 33, density=0.1, seed=9, batch=64)
    ref = get_engine("oracle", cfg, _st(ta)).infer(lits)
    eng = get_engine("cascade", cfg, _st(ta), stage1_fraction=0.5,
                     exact_sums=False, cache=False)
    res = eng.infer(lits)
    _assert_same(res, ref, sums=False)
    _assert_jax(res, cfg, ta, lits, stage1_fraction=0.5, exact_sums=False)
    esc = res.aux["escalated"].numpy()
    sums = res.class_sums.numpy()
    np.testing.assert_array_equal(sums[esc], ref.class_sums.numpy()[esc])
    pred = res.prediction.numpy()
    best = sums[np.arange(len(pred)), pred]
    assert (best == sums.max(axis=1)).all()
    assert eng.passes["completion"] == 0 and eng.passes["stage1"] == 1
    assert eng.passes["escalation"] == int(esc.any())


@pytest.mark.parametrize("full_backend", ["mxu_fused", "swar_fused",
                                          "sparse_csr"])
def test_full_backends_and_stage1_on_k1(full_backend, monkeypatch):
    """Escalation runs through any registered backend; stage 1 and the
    completion pass go through K1's wrapper (its plain version on the
    CPU) with a (C·M₁, C) vote matrix over the subsampled clauses."""
    import repro_torch.engine.cascade as cascade_mod
    calls = []

    def spy(not_words, inc_words, vm):
        calls.append((tuple(inc_words.shape), tuple(vm.shape)))
        return swar_fused_votes(not_words, inc_words, vm)

    monkeypatch.setattr(cascade_mod, "swar_fused_votes", spy)
    cfg, ta, lits = _random_tm(3, 10, 12, density=0.2, seed=6, batch=33)
    res = get_engine("cascade", cfg, _st(ta), full_backend=full_backend,
                     cache=False).infer(lits)
    _assert_same(res, get_engine("oracle", cfg, _st(ta)).infer(lits))
    _assert_jax(res, cfg, ta, lits, full_backend=full_backend)
    m1 = int(subsample_mask(10, 0.625).sum())
    assert calls[0] == ((3 * m1, 1), (3 * m1, 3))
    assert all(c == ((3 * (10 - m1), 1), (3 * (10 - m1), 3))
               for c in calls[1:])


# --------------------------------------------------- layout + validation

def test_subsample_mask_properties():
    for m in (1, 2, 7, 25, 50, 64):
        for fraction in (0.01, 0.3, 0.625, 1.0):
            mask = subsample_mask(m, fraction)
            assert mask.shape == (m,) and mask.dtype == np.bool_
            k = int(mask.sum())
            assert 1 <= k <= m
            assert k == min(m, max(1, int(round(m * fraction))))
            np.testing.assert_array_equal(mask, jsubsample_mask(m, fraction))
    np.testing.assert_array_equal(subsample_mask(8, 1.0), np.ones(8, bool))
    assert [_next_pow2(n) for n in (0, 1, 2, 3, 5, 64, 65)] == \
        [1, 1, 2, 4, 8, 64, 128]


def test_invalid_options_raise():
    cfg, ta, _ = _random_tm(2, 4, 3)
    with pytest.raises(ValueError, match="stage1_fraction"):
        CascadeEngine(cfg, _st(ta), stage1_fraction=0.0)
    with pytest.raises(ValueError, match="stage1_fraction"):
        CascadeEngine(cfg, _st(ta), stage1_fraction=1.5)
    with pytest.raises(ValueError, match="escalate to itself"):
        CascadeEngine(cfg, _st(ta), full_backend="cascade")


def test_registered_in_available_backends():
    assert "cascade" in available_backends()


# ------------------------------------------------------------- padding

@pytest.mark.parametrize("pad_to", (8, 16, 32))
def test_infer_padded_neutral(pad_to):
    """Bucket padding never changes the first rows' results, and the
    escalated mask is sliced like any other aux entry, for numpy (host)
    and tensor callers."""
    cfg, ta, lits = _random_tm(3, 10, 12, density=0.2, seed=2, batch=5)
    eng = get_engine("cascade", cfg, _st(ta), stage1_fraction=0.5)
    plain = eng.infer(lits)
    padded = infer_padded(eng, lits, pad_to)
    assert isinstance(padded.prediction, np.ndarray)
    assert padded.prediction.shape == (5,)
    _assert_same(padded, plain)
    np.testing.assert_array_equal(padded.aux["escalated"],
                                  plain.aux["escalated"].numpy())
    dev = infer_padded(eng, torch.from_numpy(lits), pad_to)
    _assert_same(dev, plain)
    assert torch.equal(dev.aux["escalated"], plain.aux["escalated"])


# ------------------------------------------------------- cache + serving

def test_engine_cache_distinguishes_opts():
    cfg, ta, _ = _random_tm(3, 10, 12, seed=6)
    st = _st(ta)
    a = get_engine("cascade", cfg, st, stage1_fraction=0.5)
    b = get_engine("cascade", cfg, st, stage1_fraction=0.5)
    c = get_engine("cascade", cfg, st, stage1_fraction=0.75)
    assert a is b and a is not c
    info = engine_cache_info()
    assert {"size", "maxsize", "hits", "misses", "evictions"} <= set(info)


def _serve(server, batches, **submit_kw):
    async def go():
        async with server:
            results = await asyncio.gather(
                *[server.submit(b, **submit_kw) for b in batches])
            return results, server.stats()
    return _run(go())


def test_server_shed_tier_end_to_end():
    """``shed_backend="cascade"`` at ``shed_qdepth=0`` sheds every batch:
    responses stay bit-exact per request, the tier counters account for
    every row, and they equal the JAX server's on the same traffic."""
    cfg, ta, _ = _random_tm(3, 10, 12, density=0.2, seed=8)
    kw = dict(max_batch=8, max_wait_us=500, backend="swar_packed",
              shed_backend="cascade", shed_qdepth=0,
              shed_opts={"stage1_fraction": 0.5})
    rng = np.random.default_rng(12)
    batches = [rng.integers(0, 2, (n, cfg.n_literals), dtype=np.int8)
               for n in (1, 3, 8, 2)]
    oracle = get_engine("oracle", cfg, _st(ta))

    results, stats = _serve(TMServer(cfg, _st(ta), ServePolicy(**kw),
                                     device="cpu"), batches)
    for lits, res in zip(batches, results):
        ref = oracle.infer(lits)
        np.testing.assert_array_equal(res.prediction, ref.prediction.numpy())
        assert res.aux["escalated"].shape == (lits.shape[0],)
    tiers = stats["tiers"]
    assert tiers["shed_backend"] == "cascade"
    assert tiers["shed_batches"] >= 1
    assert tiers["shed_rows"] == sum(len(b) for b in batches)
    assert tiers["cascade_rows"] == tiers["shed_rows"]
    assert 0.0 <= tiers["escalation_rate"] <= 1.0
    assert tiers["escalated_rows"] <= tiers["cascade_rows"]
    assert tiers["escalated_rows"] == sum(
        int(r.aux["escalated"].sum()) for r in results)
    cache = stats["engine_cache"]
    assert {"size", "maxsize", "hits", "misses", "evictions"} <= set(cache)

    jcfg = JConfig(n_classes=3, n_clauses=10, n_features=12)
    jresults, jstats = _serve(JServer(jcfg, JState(ta=jnp.asarray(ta)),
                                      JPolicy(**kw)), batches)
    for res, jres in zip(results, jresults):
        _assert_same(res, jres)
        np.testing.assert_array_equal(res.aux["escalated"],
                                      np.asarray(jres.aux["escalated"]))
    assert set(tiers) == set(jstats["tiers"])
    assert tiers["shed_rows"] == jstats["tiers"]["shed_rows"]


def test_slack_exhaustion_sheds_a_shallow_queue():
    """Past ``shed_qdepth``'s reach, a batch whose deadline is inside the
    bucket's EWMA service time still sheds (``slack_shed_batches``)."""
    cfg, ta, lits = _random_tm(3, 10, 12, density=0.2, seed=14, batch=4)
    policy = ServePolicy(max_batch=4, max_wait_us=0, backend="oracle",
                         shed_backend="cascade", shed_qdepth=1 << 20,
                         admission_control=False)
    server = TMServer(cfg, _st(ta), policy, device="cpu")

    async def go():
        async with server:
            await server.warmup()
            first = await server.submit(lits)       # seeds the EWMA
            late = await server.submit(lits, deadline_us=1)
            return first, late, server.stats()

    first, late, stats = _run(go())
    ref = get_engine("oracle", cfg, _st(ta)).infer(lits)
    for res in (first, late):
        np.testing.assert_array_equal(res.prediction, ref.prediction.numpy())
    assert "escalated" not in first.aux and "escalated" in late.aux
    assert stats["deadline"]["slack_shed_batches"] == 1
    assert stats["tiers"]["shed_batches"] == 1
    assert stats["tiers"]["cascade_rows"] == 4


def test_server_routes_bucket_to_cascade():
    """The cascade is an ordinary registered backend, so explicit routing
    entries can name it: responses bit-exact (sums too, ``exact_sums``
    by default) and the tier counters see its rows."""
    cfg, ta, _ = _random_tm(3, 10, 12, density=0.2, seed=10)
    routes = {1: "cascade", 2: "cascade", 4: "cascade", 8: "cascade"}
    rng = np.random.default_rng(13)
    lits = rng.integers(0, 2, (6, cfg.n_literals), dtype=np.int8)
    ref = get_engine("oracle", cfg, _st(ta)).infer(lits)
    (res,), stats = _serve(TMServer(cfg, _st(ta),
                                    ServePolicy(max_batch=8,
                                                max_wait_us=500),
                                    routing=routes, device="cpu"), [lits])
    np.testing.assert_array_equal(res.prediction, ref.prediction.numpy())
    np.testing.assert_array_equal(res.class_sums, ref.class_sums.numpy())
    assert stats["routing"] == {"1": "cascade", "2": "cascade",
                                "4": "cascade", "8": "cascade"}
    assert stats["tiers"]["cascade_rows"] == 6
    assert stats["tiers"]["shed_batches"] == 0


def test_server_without_shed_reports_inactive_tier():
    cfg, ta, _ = _random_tm(2, 6, 9, seed=1)
    policy = ServePolicy(max_batch=4, max_wait_us=500, backend="swar_packed")
    _, stats = _serve(TMServer(cfg, _st(ta), policy, device="cpu"),
                      [np.zeros((2, cfg.n_literals), np.int8)])
    tiers = stats["tiers"]
    assert tiers["shed_backend"] is None
    assert tiers["shed_batches"] == 0 and tiers["cascade_rows"] == 0
    assert stats["deadline"]["slack_shed_batches"] == 0


def test_unknown_shed_backend_rejected():
    cfg, ta, _ = _random_tm(2, 6, 9, seed=1)
    policy = ServePolicy(max_batch=4, backend="swar_packed",
                         shed_backend="fpga")
    with pytest.raises(ValueError, match="shed_backend"):
        TMServer(cfg, _st(ta), policy, device="cpu")
    server = TMServer(cfg, _st(ta), ServePolicy(backend="oracle"),
                      device="cpu")
    with pytest.raises(RuntimeError, match="no shed tier"):
        server.shed_engine_for(4)


def test_resolved_shed_opts_defaults_fast_sums():
    p = ServePolicy(shed_backend="cascade")
    assert p.resolved_shed_opts()["exact_sums"] is False
    p2 = ServePolicy(shed_backend="cascade",
                     shed_opts={"exact_sums": True, "stage1_fraction": 0.75})
    opts = p2.resolved_shed_opts()
    assert opts["exact_sums"] is True and opts["stage1_fraction"] == 0.75
    assert ServePolicy(shed_backend="oracle").resolved_shed_opts() == {}
    for policy in (p, p2):
        assert JPolicy(shed_backend=policy.shed_backend,
                       shed_opts=policy.shed_opts).resolved_shed_opts() \
            == policy.resolved_shed_opts()
