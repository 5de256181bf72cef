"""Port parity: the clause-indexed sparse layer (``repro_torch.engine.
sparse``, ``repro_torch.kernels.ell_gather``, the ``sparse_csr`` backend,
the ``sparse`` train backend and the ``TMServer`` publish refresh)
against the JAX package's, on the same seeded numpy inputs.

Mirrors ``tests/test_sparse_train.py`` (its tracer test excepted: torch
has no trace that needs the packed fallback):

1. layout — ``ell_from_include``, ``ell_apply_deltas`` and
   ``IncrementalEll`` give the JAX package's indices and ``nnz`` element
   for element, patched layouts equal from-scratch builds, and the
   refresh policy rebuilds where the JAX one does;
2. training — ``sparse`` is bitwise equal to JAX ``sparse`` and to the
   port's ``fused`` and ``reference`` over 20-step key chains;
3. serving — default routing serves a 5%-dense state through
   ``sparse_csr`` bit for bit with the oracle and the JAX server, routes
   flip across the 0.10 boundary, pinned routes stay, and the serving
   layout equals a from-scratch build after publishes.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.engine import get_engine as jget_engine
from repro.engine import get_train_engine as jget_train_engine
from repro.engine.sparse import IncrementalEll as JIncrementalEll
from repro.engine.sparse import ell_apply_deltas as jell_apply_deltas
from repro.engine.sparse import ell_from_include as jell_from_include
from repro.kernels.ell_gather import ell_clause_votes as jell_clause_votes
from repro.kernels.ell_gather import ell_clause_words as jell_clause_words
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMServer as JServer
from repro_torch.convert import state_from_numpy
from repro_torch.core import prng
from repro_torch.core.tm import TMConfig, TMState, clause_polarity
from repro_torch.engine import (available_backends,
                                available_train_backends,
                                clear_engine_cache, engine_cache_info,
                                get_engine, get_train_engine,
                                train_engine_opts)
from repro_torch.engine.base import KeyedEngineCache
from repro_torch.engine.sparse import (DEFAULT_K_SLACK,
                                       DEFAULT_REBUILD_THRESHOLD,
                                       IncrementalEll, ell_apply_deltas,
                                       ell_from_include)
from repro_torch.kernels.ell_gather import (ell_clause_votes,
                                            ell_clause_words)
from repro_torch.serve import ServePolicy, TMServer

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

# wall-clock bound on every event-loop run: a scheduler fault fails its
# test instead of hanging the whole run
LIMIT_S = 120


def _run(coro):
    """``asyncio.run(coro)`` under the ``LIMIT_S`` wall-clock limit."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _loop_ell(inc: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The per-row-loop oracle the vectorized build replaced."""
    r, l = inc.shape
    idx = np.full((r, k), l, np.int32)
    for i in range(r):
        nz = np.nonzero(inc[i])[0]
        idx[i, :len(nz)] = nz
    return idx, inc.sum(axis=1).astype(np.int32)


def _same_layout(got, want):
    """A port layout equals a JAX layout element for element."""
    assert got.indices.dtype == torch.int32 and got.nnz.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.nnz.numpy(), np.asarray(want.nnz))
    assert got.n_literals == want.n_literals
    assert got.k_max == want.k_max
    assert got.density == want.density


def _drifting_tm(c=3, m=8, f=12, *, density=0.15, seed=0, batch=16):
    """numpy inputs built like tests/test_sparse_train.py::_drifting_tm:
    included TAs one step above N and excluded at N, so feedback flips
    include bits readily (maximal layout churn)."""
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density, 128 + 1, 128) \
        .astype(np.int32)
    lits = rng.integers(0, 2, (batch, 2 * f), dtype=np.int8)
    y = rng.integers(0, c, (batch,), dtype=np.int32)
    return (JConfig(n_classes=c, n_clauses=m, n_features=f, T=5, s=3.9),
            TMConfig(n_classes=c, n_clauses=m, n_features=f, T=5, s=3.9),
            ta, lits, y)


def _keys(root, i):
    """JAX's ``fold_in(key(root), i)`` and the same key in the port."""
    key = jax.random.fold_in(jax.random.key(root), i)
    return key, prng.wrap_key_data(np.asarray(jax.random.key_data(key)))


# -- layout: vectorized build == JAX == loop oracle ------------------------


def test_ell_from_include_matches_jax_and_loop_on_random_masks():
    rng = np.random.default_rng(0)
    for trial in range(50):
        r = int(rng.integers(1, 40))
        l = int(rng.integers(1, 64))
        inc = rng.random((r, l)) < rng.random()
        lay = ell_from_include(inc)
        _same_layout(lay, jell_from_include(inc))
        idx, nnz = _loop_ell(inc, lay.k_max)
        np.testing.assert_array_equal(lay.indices.numpy(), idx,
                                      err_msg=f"trial {trial}")
        np.testing.assert_array_equal(lay.nnz.numpy(), nnz)
    # a tensor mask (the engines pass one) gives the same layout
    inc = rng.random((12, 30)) < 0.2
    _same_layout(ell_from_include(torch.from_numpy(inc.astype(np.int8))),
                 jell_from_include(inc))


def test_ell_from_include_k_override_and_validation():
    inc = np.array([[1, 0, 1, 0], [0, 0, 0, 0]], bool)
    lay = ell_from_include(inc, k=3)
    np.testing.assert_array_equal(lay.indices.numpy(),
                                  [[0, 2, 4], [4, 4, 4]])
    _same_layout(lay, jell_from_include(inc, k=3))
    wide = ell_from_include(inc, k=6)             # sentinel columns past L
    assert wide.indices.shape == (2, 6)
    assert (wide.indices.numpy()[:, 4:] == 4).all()
    _same_layout(wide, jell_from_include(inc, k=6))
    with pytest.raises(ValueError, match="below the max"):
        ell_from_include(inc, k=1)


def test_ell_from_include_empty_rows_and_zero_k():
    lay = ell_from_include(np.zeros((5, 7), bool))
    assert lay.k_max == 0 and lay.density == 0.0
    np.testing.assert_array_equal(lay.nnz.numpy(), np.zeros(5))
    _same_layout(lay, jell_from_include(np.zeros((5, 7), bool)))


# -- layout: delta patch == from-scratch == JAX ----------------------------


def test_ell_apply_deltas_matches_fresh_build_and_jax():
    rng = np.random.default_rng(1)
    inc = rng.random((24, 32)) < 0.2
    lay = ell_from_include(inc, k=12)
    idx, nnz = lay.indices.numpy().copy(), lay.nnz.numpy().copy()
    jlay = jell_from_include(inc, k=12)
    jidx, jnnz = np.asarray(jlay.indices).copy(), np.asarray(jlay.nnz).copy()
    new = inc.copy()
    rows = np.array([0, 3, 17])
    new[rows] = rng.random((3, 32)) < 0.2
    assert ell_apply_deltas(idx, nnz, new, rows)
    assert jell_apply_deltas(jidx, jnnz, new, rows)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(nnz, jnnz)
    fresh = ell_from_include(new, k=12)
    np.testing.assert_array_equal(idx, fresh.indices.numpy())
    np.testing.assert_array_equal(nnz, fresh.nnz.numpy())


def test_ell_apply_deltas_overflow_refuses_without_writing():
    inc = np.zeros((4, 16), bool)
    inc[1, :3] = True
    lay = ell_from_include(inc)                  # K = 3
    idx, nnz = lay.indices.numpy().copy(), lay.nnz.numpy().copy()
    before = idx.copy()
    new = inc.copy()
    new[2, :5] = True                            # nnz 5 > K 3
    assert not ell_apply_deltas(idx, nnz, new, np.array([2]))
    np.testing.assert_array_equal(idx, before)   # nothing written
    jlay = jell_from_include(inc)
    assert not jell_apply_deltas(np.asarray(jlay.indices).copy(),
                                 np.asarray(jlay.nnz).copy(), new,
                                 np.array([2]))


# -- layout: the incremental refresh policy --------------------------------


def test_incremental_refresh_equals_from_scratch_and_jax_soak():
    rng = np.random.default_rng(2)
    inc = rng.random((48, 40)) < 0.1
    ell = IncrementalEll(inc, k_slack=8)
    jell = JIncrementalEll(inc, k_slack=8)
    for t in range(60):
        flip = rng.random(inc.shape) < rng.choice([0.001, 0.01, 0.08])
        inc = inc ^ flip
        lay = ell.refresh(inc)
        _same_layout(lay, jell.refresh(inc))
        fresh = ell_from_include(inc, k=lay.k_max)
        np.testing.assert_array_equal(lay.indices.numpy(),
                                      fresh.indices.numpy(),
                                      err_msg=f"step {t}")
        np.testing.assert_array_equal(lay.nnz.numpy(), fresh.nnz.numpy())
        assert ell.stats() == jell.stats(), f"step {t}"
    stats = ell.stats()
    assert stats["patches"] > 0 and stats["rebuilds"] >= 1
    assert stats["rows"] == 48


def test_handed_out_layout_does_not_move_on_patch():
    """A layout an engine already holds (pinned to an older state) keeps
    its indices when the mirror patches its host arrays in place."""
    inc = np.zeros((6, 20), bool)
    inc[:, 0] = True
    ell = IncrementalEll(inc)
    old = ell.layout
    before = old.indices.clone()
    new = inc.copy()
    new[2, 5] = True
    assert ell.refresh(new) is not old and ell.patches == 1
    assert torch.equal(old.indices, before)


def test_incremental_k_overflow_triggers_rebuild():
    inc = np.zeros((16, 64), bool)
    inc[:, 0] = True
    ell = IncrementalEll(inc, k_slack=0)
    jell = JIncrementalEll(inc, k_slack=0)
    k0 = ell.layout.k_max                        # quantized alloc (8)
    assert k0 == 8 == jell.layout.k_max
    new = inc.copy()
    new[3, :k0 + 1] = True                       # overflows the alloc
    lay = ell.refresh(new)
    _same_layout(lay, jell.refresh(new))
    assert ell.rebuilds == 2 == jell.rebuilds    # initial + overflow
    assert lay.k_max >= k0 + 1
    fresh = ell_from_include(new, k=lay.k_max)
    np.testing.assert_array_equal(lay.indices.numpy(), fresh.indices.numpy())


def test_incremental_drift_threshold_triggers_rebuild():
    rng = np.random.default_rng(3)
    inc = rng.random((40, 24)) < 0.3
    ell = IncrementalEll(inc, rebuild_threshold=0.25)
    jell = JIncrementalEll(inc, rebuild_threshold=0.25)
    new = inc.copy()
    new[:15] = rng.random((15, 24)) < 0.3        # 37% of rows drift
    _same_layout(ell.refresh(new), jell.refresh(new))
    assert ell.rebuilds == 2 == jell.rebuilds


def test_incremental_noop_and_shape_change():
    inc = np.eye(6, 10, dtype=bool)
    ell = IncrementalEll(inc)
    lay0 = ell.refresh(inc)                      # nothing flipped
    assert lay0 is ell.layout and ell.patches == 0
    lay1 = ell.refresh(np.eye(8, 10, dtype=bool))
    assert lay1.indices.shape[0] == 8 and ell.rebuilds == 2
    assert (DEFAULT_K_SLACK, DEFAULT_REBUILD_THRESHOLD) == (8, 0.25)


def test_incremental_validation():
    with pytest.raises(ValueError, match="k_slack"):
        IncrementalEll(np.zeros((2, 4), bool), k_slack=-1)
    with pytest.raises(ValueError, match="rebuild_threshold"):
        IncrementalEll(np.zeros((2, 4), bool), rebuild_threshold=1.5)


# -- the gather bodies ------------------------------------------------------


# (R, L, B, density): B off and on a 32-lane word, an all-padding row,
# K = 0 (every clause empty)
@pytest.mark.parametrize("case", [(24, 40, 17, 0.1), (30, 64, 32, 0.05),
                                  (9, 20, 70, 0.3), (6, 12, 5, 0.0)],
                         ids=lambda c: "R{}L{}B{}-d{}".format(*c))
def test_ell_clause_words_match_jax(case):
    r, l, b, density = case
    rng = np.random.default_rng(r + l + b)
    inc = rng.random((r, l)) < density
    inc[0] = False                               # an all-padding row
    lits = rng.integers(0, 2, (b, l), dtype=np.int8)
    lits[0] = 1
    lay = ell_from_include(inc)
    got = ell_clause_words(lay.indices, torch.from_numpy(lits))
    want = jell_clause_words(jnp.asarray(np.asarray(lay.indices)),
                             jnp.asarray(lits))
    assert got.dtype == torch.int32 and got.shape == (r, -(-b // 32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    assert (got[0] == -1).all()                  # an empty clause fires


@pytest.mark.parametrize("shape", [(2, 6, 9), (3, 10, 12), (4, 8, 40)],
                         ids=lambda s: "C{}M{}F{}".format(*s))
def test_ell_clause_votes_match_jax_and_oracle(shape):
    c, m, f = shape
    rng = np.random.default_rng(sum(shape))
    ta = np.where(rng.random((c, m, 2 * f)) < 0.15, 129, 128) \
        .astype(np.int32)
    lits = rng.integers(0, 2, (37, 2 * f), dtype=np.int8)
    inc = (ta > 128).reshape(c * m, 2 * f)
    lay = ell_from_include(inc)
    cl, votes = ell_clause_votes(lay.indices, clause_polarity(m),
                                 torch.from_numpy(lits), c=c, m=m)
    jcl, jvotes = jell_clause_votes(jnp.asarray(np.asarray(lay.indices)),
                                    jnp.asarray(np.where(np.arange(m) % 2,
                                                         -1, 1)),
                                    jnp.asarray(lits), c=c, m=m)
    assert cl.dtype == torch.int8 and cl.shape == (37, c, m)
    assert votes.dtype == torch.int32 and votes.shape == (37, c)
    np.testing.assert_array_equal(cl.numpy(), np.asarray(jcl))
    np.testing.assert_array_equal(votes.numpy(), np.asarray(jvotes))
    oracle = get_engine("oracle", TMConfig(c, m, f),
                        state_from_numpy(ta, device="cpu"))
    np.testing.assert_array_equal(votes.numpy(),
                                  oracle.infer(lits).class_sums.numpy())


# -- the sparse_csr backend ------------------------------------------------


def test_sparse_csr_registered_and_takes_a_prebuilt_layout():
    assert "sparse_csr" in available_backends()
    _, cfg, ta, lits, _ = _drifting_tm(seed=4)
    st = state_from_numpy(ta, device="cpu")
    inc = (ta > 128).reshape(cfg.n_classes * cfg.n_clauses, cfg.n_literals)
    lay = ell_from_include(inc, k=16)            # a slack-padded K
    eng = get_engine("sparse_csr", cfg, st, cache=False, ell=lay)
    assert eng.ell is lay
    want = get_engine("oracle", cfg, st).infer(lits)
    got = eng.infer(lits)
    assert torch.equal(got.prediction, want.prediction)
    assert torch.equal(got.class_sums, want.class_sums)
    # a layout is not hashable into the keyed cache: it bypasses it
    assert get_engine("sparse_csr", cfg, st, ell=lay) is not eng
    with pytest.raises(ValueError, match="ell layout"):
        get_engine("sparse_csr", cfg, st, cache=False,
                   ell=ell_from_include(inc[:5]))


# -- training: the sparse backend ------------------------------------------


def test_sparse_backend_registered_with_opts():
    assert "sparse" in available_train_backends()
    cfg = TMConfig(n_classes=2, n_clauses=4, n_features=6)
    eng = get_train_engine("sparse", cfg, cache=False, k_slack=16,
                           rebuild_threshold=0.5, block_b=32, block_m=32)
    opts = train_engine_opts(eng)
    assert opts["k_slack"] == 16 and opts["rebuild_threshold"] == 0.5
    assert eng.layout_stats() is None            # no step yet
    jeng = jget_train_engine("sparse", JConfig(2, 4, 6), cache=False,
                             k_slack=16, rebuild_threshold=0.5, block_b=32,
                             block_m=32)
    from repro.engine import train_engine_opts as jtrain_engine_opts
    assert opts == jtrain_engine_opts(jeng)


def test_sparse_twenty_step_chain_matches_jax_fused_and_reference():
    """A 20-step chain: the engine's incremental layout must track the
    drifting state exactly or votes (and hence deltas) diverge.  Every
    step's state equals JAX ``sparse``'s and the port's ``fused`` and
    ``reference``."""
    jcfg, cfg, ta, lits, y = _drifting_tm(seed=7)
    jsp = jget_train_engine("sparse", jcfg, cache=False, k_slack=0)
    engines = {name: get_train_engine(name, cfg, cache=False, **kw)
               for name, kw in (("sparse", {"k_slack": 0}), ("fused", {}),
                                ("reference", {}))}
    js = JState(ta=jnp.asarray(ta))
    states = {name: TMState(torch.from_numpy(ta)) for name in engines}
    for i in range(20):
        jkey, key = _keys(5, i)
        js = jsp.step(js, jkey, jnp.asarray(lits), jnp.asarray(y))
        want = np.asarray(js.ta)
        for name, eng in engines.items():
            states[name] = eng.step(states[name], key, lits, y)
            np.testing.assert_array_equal(
                states[name].ta.numpy(), want,
                err_msg=f"{name} diverged at step {i}")
    sp = engines["sparse"]
    stats = sp.layout_stats()
    assert stats is not None and stats["rebuilds"] >= 1
    assert stats == jsp.layout_stats()
    assert not np.array_equal(want, ta)
    # synced to the final state (the layout tracks each step's input),
    # the incremental layout equals a from-scratch build
    sp._refresh(states["sparse"])
    inc = (states["sparse"].ta > cfg.n_states).reshape(
        cfg.n_classes * cfg.n_clauses, cfg.n_literals)
    fresh = ell_from_include(inc, k=sp._ell.layout.k_max)
    assert torch.equal(sp._ell.layout.indices, fresh.indices)


def test_sparse_exact_across_kslack_and_thresholds():
    """Refresh policy knobs change when rebuilds happen, never the layout
    contents, so the trained state is invariant to them."""
    _, cfg, ta, lits, y = _drifting_tm(seed=11)
    ref = get_train_engine("reference", cfg, cache=False)
    s_ref = TMState(torch.from_numpy(ta))
    for i in range(6):
        s_ref = ref.step(s_ref, _keys(3, i)[1], lits, y)
    for k_slack, thr in [(0, 0.0), (8, 0.25), (32, 1.0)]:
        sp = get_train_engine("sparse", cfg, cache=False, k_slack=k_slack,
                              rebuild_threshold=thr)
        s_sp = TMState(torch.from_numpy(ta))
        for i in range(6):
            s_sp = sp.step(s_sp, _keys(3, i)[1], lits, y)
        assert torch.equal(s_sp.ta, s_ref.ta), f"k_slack={k_slack} thr={thr}"


# -- engine cache: superseded-state eviction -------------------------------


def test_keyed_cache_evict_state():
    cache = KeyedEngineCache(maxsize=4)
    a = (torch.arange(3.0),)
    b = (torch.arange(4.0),)
    cache.insert(("ka",), a, "engine-a")
    cache.insert(("kb",), b, "engine-b")
    assert cache.evict_state(a) == 1
    assert cache.get(("ka",)) is None
    assert cache.get(("kb",)) == "engine-b"
    info = cache.info()
    assert info["superseded"] == 1 and info["evictions"] == 0
    assert cache.evict_state(a) == 0             # already gone


def test_server_publish_evicts_superseded_engines():
    _, cfg, ta, lits, y = _drifting_tm(seed=17)

    async def go():
        clear_engine_cache()
        srv = TMServer(cfg, state_from_numpy(ta, device="cpu"),
                       ServePolicy(max_batch=16, max_wait_us=0),
                       device="cpu", train_backend="packed")
        async with srv:
            await srv.submit(lits)               # caches v0's engine
            before = engine_cache_info()["superseded"]
            await srv.submit_labeled(lits, y)
            return before, engine_cache_info()["superseded"]

    before, after = _run(go())
    assert after > before


# -- serving: default routing, route flips, pinned routes ------------------


def test_default_routing_serves_tm_mnist_shape_like_jax_and_oracle():
    """A tm-mnist-50-shaped state (C=10, M=50, F=784) at 5% include
    density, served without ``backend=``: both servers route every bucket
    to sparse_csr and every response equals the oracle's and the JAX
    server's, bit for bit."""
    c, m, f = 10, 50, 784
    rng = np.random.default_rng(41)
    ta = np.where(rng.random((c, m, 2 * f)) < 0.05, 129, 128) \
        .astype(np.int32)
    reqs = [rng.integers(0, 2, (int(n), 2 * f), dtype=np.int8)
            for n in (1, 5, 3, 8, 2)]
    kw = dict(max_batch=8, max_wait_us=0)

    async def serve(srv):
        async with srv:
            return [await srv.submit(r) for r in reqs], srv.stats()

    cfg = TMConfig(c, m, f)
    state = state_from_numpy(ta, device="cpu")
    got, stats = _run(serve(TMServer(cfg, state, ServePolicy(**kw),
                                     device="cpu")))
    want, jstats = _run(serve(JServer(JConfig(c, m, f),
                                      JState(ta=jnp.asarray(ta)),
                                      JPolicy(**kw))))
    assert set(stats["routing"].values()) == {"sparse_csr"}
    assert stats["routing"] == jstats["routing"]
    assert stats["errors"] == 0
    assert stats["sparse_layout"] == jstats["sparse_layout"]
    oracle = get_engine("oracle", cfg, state)
    for lits, g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g.prediction, np.asarray(w.prediction))
        np.testing.assert_array_equal(g.class_sums, np.asarray(w.class_sums))
        o = oracle.infer(lits)
        np.testing.assert_array_equal(g.prediction, o.prediction.numpy())
        np.testing.assert_array_equal(g.class_sums, o.class_sums.numpy())


def test_routes_flip_when_density_crosses_heuristic_boundary():
    """Density starts above the 0.10 boundary (routes dense) with include
    TAs one decrement from exclusion, so all-zero-literal feedback drives
    density down: a publish re-resolves the routes to sparse_csr on the
    same update as the JAX server, and predictions stay bit-exact."""
    rng = np.random.default_rng(23)
    c, m, f = 4, 8, 16
    inc = rng.random((c, m, 2 * f)) < 0.2
    ta = np.where(inc, 128 + 1, 1).astype(np.int32)
    x = rng.integers(0, 2, (8, 2 * f)).astype(np.int8)
    zeros = np.zeros((16, 2 * f), np.int8)
    kw = dict(max_batch=16, max_wait_us=0)

    async def drive(srv):
        flips = []
        async with srv:
            assert set(srv.routing.values()) == {"swar_packed"}
            for i in range(50):
                await srv.submit_labeled(zeros, np.full(16, i % c, np.int32))
                flips.append(set(srv.routing.values()))
                if flips[-1] == {"sparse_csr"}:
                    break
            res = await srv.submit(x)
            return flips, res, np.asarray(srv.state.ta), srv.stats()

    cfg = TMConfig(c, m, f)
    flips, res, final, stats = _run(drive(TMServer(
        cfg, state_from_numpy(ta, device="cpu"), ServePolicy(**kw),
        device="cpu", train_backend="sparse")))
    jflips, jres, jfinal, _ = _run(drive(JServer(
        JConfig(c, m, f), JState(ta=jnp.asarray(ta)), JPolicy(**kw),
        train_backend="sparse")))
    assert flips[-1] == {"sparse_csr"}, "routes never re-resolved"
    assert flips == jflips
    np.testing.assert_array_equal(final, jfinal)
    assert float((final > 128).mean()) <= 0.10   # the flip was earned
    np.testing.assert_array_equal(res.prediction, np.asarray(jres.prediction))
    oracle = get_engine("oracle", cfg, state_from_numpy(final, device="cpu"))
    np.testing.assert_array_equal(res.prediction,
                                  oracle.infer(x).prediction.numpy())
    assert stats["routing_updates"] >= 1
    assert stats["sparse_layout"] is not None


def test_explicit_routing_and_backend_stay_pinned():
    """Explicit route tables and ``policy.backend`` never re-resolve."""
    rng = np.random.default_rng(31)
    cfg = TMConfig(n_classes=3, n_clauses=6, n_features=10)
    inc = rng.random((3, 6, 20)) < 0.2
    ta = np.where(inc, 128 + 1, 1).astype(np.int32)
    zeros = np.zeros((8, 20), np.int8)

    async def go(policy, **kw):
        srv = TMServer(cfg, state_from_numpy(ta, device="cpu"), policy,
                       device="cpu", train_backend="packed", **kw)
        async with srv:
            routes0 = dict(srv.routing)
            for i in range(30):
                await srv.submit_labeled(zeros, np.full(8, i % 3, np.int32))
            assert srv.routing == routes0
            assert srv.stats()["routing_updates"] == 0
            assert srv.stats()["sparse_layout"] is None

    quick = ServePolicy(max_batch=8, max_wait_us=0)
    _run(go(quick, routing={b: "oracle" for b in quick.resolved_buckets()}))
    _run(go(ServePolicy(max_batch=8, max_wait_us=0, backend="swar_packed")))


def test_serving_layout_matches_from_scratch_after_publishes():
    """Online-learning soak with the sparse_csr route pinned: after N
    publishes the server's incremental layout equals a from-scratch build
    of the live state, and the prebuilt engine still predicts
    bit-exactly."""
    rng = np.random.default_rng(37)
    cfg = TMConfig(n_classes=4, n_clauses=8, n_features=16)
    inc0 = rng.random((4, 8, 32)) < 0.08
    ta = np.where(inc0, 128 + 1, 128).astype(np.int32)
    srv = TMServer(cfg, state_from_numpy(ta, device="cpu"),
                   ServePolicy(max_batch=16, max_wait_us=0,
                               backend="sparse_csr"),
                   device="cpu", train_backend="sparse")
    x = rng.integers(0, 2, (8, 32)).astype(np.int8)

    async def go():
        async with srv:
            for _ in range(25):
                lits = rng.integers(0, 2, (16, 32)).astype(np.int8)
                await srv.submit_labeled(
                    lits, rng.integers(0, 4, 16).astype(np.int32))
            ell = srv._serve_ell
            assert ell is not None
            inc = (srv.state.ta > cfg.n_states).reshape(32, 32)
            fresh = ell_from_include(inc, k=ell.layout.k_max)
            assert torch.equal(ell.layout.indices, fresh.indices)
            assert torch.equal(ell.layout.nnz, fresh.nnz)
            stats = srv.stats()["sparse_layout"]
            assert stats["rebuilds"] + stats["patches"] >= 1
            assert srv.engine_for(16) is srv._sparse_serving[1]
            res = await srv.submit(x)
            oracle = get_engine("oracle", cfg, srv.state, cache=False)
            np.testing.assert_array_equal(
                res.prediction, oracle.infer(x).prediction.numpy())

    _run(go())
