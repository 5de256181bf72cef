"""Port parity: the ``repro_torch`` TMFleet and the weighted, budgeted
engine cache, mirroring ``tests/test_fleet.py``, the fleet half of
``tests/test_fault_tolerance.py`` and ``tests/test_engine_threads.py``.

The isolation contract: every model's responses through the fleet —
predictions and class sums — equal a solo ``TMServer`` replaying only
that model's requests, across packed and unpacked buckets, mid-stream
publishes, version pins, shed tiers, rollbacks and checkpoint restarts.
Plus the mechanics it rests on (pack-group formation, fused class-sum
columns, segment tie-breaking, weighted eviction under a budget with the
``misses == size + evictions + superseded`` identity, add/drain) and
fault containment.

Cross-package: one seeded trace — two pack groups, a solo model, a
learning member, a rollback and a drain — goes through the JAX
``TMFleet`` and the port's, packed and unpacked; every response, every
published member state and the ``stats()`` key sets must be equal.  The
JAX fleet runs at ``pipeline_depth=2`` only: at depth 1 its scheduler can
lose a wakeup (ROADMAP.md, R1).
"""

import asyncio
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMFleet as JFleet
from repro_torch.convert import state_from_numpy
from repro_torch.core.tm import TMConfig, TMState
from repro_torch.distributed import Mesh, data_mesh
from repro_torch.engine import (ENGINE_CACHE_SIZE, clear_engine_cache,
                                engine_cache_info, evict_engines_for_state,
                                get_engine, set_engine_cache_budget,
                                state_nbytes, weight_engines_for_state)
from repro_torch.engine.base import KeyedEngineCache
from repro_torch.serve import (DeadlineExceeded, ServePolicy, TMFleet,
                               TMServer, fuse_states, pack_key)
from repro_torch.serve.tm_fleet import _group_policy

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

C, M, F = 3, 7, 9         # the JAX fleet suite's shape

# wall-clock bound on every event-loop run: a scheduler that loses a
# wakeup fails its test instead of hanging the whole run; leaving the
# ``async with`` block on the timeout stops the fleet
LIMIT_S = 120


def _run(coro):
    """``asyncio.run(coro)`` under the ``LIMIT_S`` wall-clock limit."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _ta(seed=0, c=C, m=M, f=F, density=0.2):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
        .astype(np.int32)


def _tm(seed=0, c=C, m=M, f=F, density=0.2):
    """The JAX suite's ``_tm``: a seeded numpy draw → (cfg, CPU state)."""
    return (TMConfig(n_classes=c, n_clauses=m, n_features=f),
            state_from_numpy(_ta(seed, c, m, f, density), device="cpu"))


def _oracle(cfg, state, lits):
    return get_engine("oracle", cfg, state).infer(torch.as_tensor(lits))


def _trace(models, n_ops, seed, *, update_frac=0.3, trainable=()):
    """A deterministic interleaved multi-model op trace → list of
    ``(name, "predict", lits)`` / ``(name, "update", lits, labels)``."""
    rng = np.random.default_rng(seed)
    names = list(models)
    ops = []
    for _ in range(n_ops):
        name = names[rng.integers(len(names))]
        cfg = models[name][0]
        n = int(rng.integers(1, 6))
        lits = rng.integers(0, 2, (n, cfg.n_literals), dtype=np.int8)
        if name in trainable and rng.random() < update_frac:
            labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
            ops.append((name, "update", lits, labels))
        else:
            ops.append((name, "predict", lits))
    return ops


def _run_fleet(specs, policy, trace, *, pack=True, mesh=None):
    """Serve ``trace`` sequentially through a CPU fleet (over ``mesh``,
    a simulated CPU mesh, when given) → (per-model op records, final
    stats)."""
    out = {name: [] for name in specs}

    async def go():
        async with TMFleet(specs, policy, pack=pack, device="cpu",
                           mesh=mesh) as fleet:
            for name, op, *payload in trace:
                if op == "predict":
                    res = await fleet.submit(name, payload[0])
                    out[name].append(("predict", res.prediction,
                                      res.class_sums))
                elif op == "update":
                    v = await fleet.submit_labeled(name, *payload)
                    out[name].append(("update", v))
                elif op == "rollback":
                    out[name].append(("rollback",
                                      fleet.rollback(name, payload[0])))
            return fleet.stats()

    return out, _run(go())


def _run_solo(cfg, state, policy, ops, **server_kw):
    """Replay one model's op subsequence on a solo CPU TMServer."""
    out = []

    async def go():
        async with TMServer(cfg, state, policy, device="cpu",
                            **server_kw) as srv:
            for op, *payload in ops:
                if op == "predict":
                    res = await srv.submit(payload[0])
                    out.append(("predict", res.prediction, res.class_sums))
                elif op == "update":
                    out.append(("update", await srv.submit_labeled(*payload)))
                elif op == "rollback":
                    out.append(("rollback", srv.rollback(payload[0])))

    _run(go())
    return out


def _assert_same(fleet_ops, solo_ops, model=""):
    assert len(fleet_ops) == len(solo_ops), model
    for i, (a, b) in enumerate(zip(fleet_ops, solo_ops)):
        assert a[0] == b[0], (model, i)
        if a[0] == "predict":
            np.testing.assert_array_equal(a[1], b[1],
                                          err_msg=f"{model} op {i} pred")
            np.testing.assert_array_equal(a[2], b[2],
                                          err_msg=f"{model} op {i} sums")
        else:
            assert a[1] == b[1], (model, i)   # version parity


def _isolation_check(models, specs, policy, trace, *, pack=True,
                     server_kw=None):
    """The contract: fleet trace vs per-model solo replay, bitwise."""
    fleet_out, stats = _run_fleet(specs, policy, trace, pack=pack)
    for name, (cfg, state) in models.items():
        ops = [(op, *payload) for n, op, *payload in trace if n == name]
        solo = _run_solo(cfg, state, policy, ops,
                         **(server_kw or {}).get(name, {}))
        _assert_same(fleet_out[name], solo, model=name)
    return stats


# -- the isolation property ------------------------------------------


@pytest.mark.parametrize("seed,n_ops,max_batch,max_wait_us,backend", [
    (0, 12, 2, 0, None), (101, 16, 8, 500, "swar_packed"),
    (4242, 8, 8, 0, None)])
def test_isolation_property_packed(seed, n_ops, max_batch, max_wait_us,
                                   backend):
    """Two same-shape (packed) learning models, interleaved predicts and
    updates: each model equals its solo replay, version pins across
    mid-stream publishes included."""
    models = {"a": _tm(seed=1), "b": _tm(seed=2, density=0.35)}
    policy = ServePolicy(max_batch=max_batch, max_wait_us=max_wait_us,
                         backend=backend)
    specs = {"a": {"cfg": models["a"][0], "state": models["a"][1],
                   "train_backend": "fused"},
             "b": {"cfg": models["b"][0], "state": models["b"][1],
                   "train_backend": "reference"}}
    trace = _trace(models, n_ops, seed, trainable=("a", "b"))
    stats = _isolation_check(
        models, specs, policy, trace,
        server_kw={"a": {"train_backend": "fused"},
                   "b": {"train_backend": "reference"}})
    assert stats["n_groups"] == 1 and stats["packed_models"] == 2


@pytest.mark.parametrize("seed,n_ops,pack", [(5, 10, True), (6, 14, False),
                                            (7, 6, True)])
def test_isolation_property_mixed_shapes(seed, n_ops, pack):
    """Three models — two packable, one odd shape — interleaved: the
    contract holds for every model whether its bucket packed or not."""
    models = {"a": _tm(seed=3), "b": _tm(seed=4, c=5),
              "c": _tm(seed=5, m=4, f=6)}
    specs = {k: (cfg, st_) for k, (cfg, st_) in models.items()}
    policy = ServePolicy(max_batch=8, max_wait_us=200)
    trace = _trace(models, n_ops, seed)
    stats = _isolation_check(models, specs, policy, trace, pack=pack)
    if pack:
        assert stats["n_groups"] == 1        # a+b share (M, F, N)
        assert stats["models"]["c"]["packed"] is False
    else:
        assert stats["n_groups"] == 0


def test_isolation_concurrent_predicts():
    """Concurrent cross-model submission storms: any interleaving equals
    the oracle (one state version per model, so order cannot matter)."""
    models = {"a": _tm(seed=6), "b": _tm(seed=7, density=0.4),
              "c": _tm(seed=8, c=4)}
    rng = np.random.default_rng(9)
    reqs = [(name, rng.integers(0, 2, (int(rng.integers(1, 6)),
                                       models[name][0].n_literals),
                                dtype=np.int8))
            for name in rng.choice(list(models), 24)]

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=16),
                           device="cpu") as fleet:
            return await asyncio.gather(
                *[fleet.submit(name, lits) for name, lits in reqs])

    for (name, lits), res in zip(reqs, _run(go())):
        ref = _oracle(*models[name], lits)
        np.testing.assert_array_equal(res.prediction,
                                      ref.prediction.numpy())
        np.testing.assert_array_equal(res.class_sums,
                                      ref.class_sums.numpy())


def test_single_model_fleet_matches_tmserver():
    """A one-entry fleet is a bare TMServer: same results and versions,
    no pack group."""
    cfg, state = _tm(seed=10)
    models = {"only": (cfg, state)}
    policy = ServePolicy(max_batch=4, max_wait_us=100)
    trace = _trace(models, 10, seed=11, trainable=("only",))
    specs = {"only": {"cfg": cfg, "state": state, "train_backend": "fused"}}
    stats = _isolation_check(models, specs, policy, trace,
                             server_kw={"only": {"train_backend": "fused"}})
    assert stats["n_groups"] == 0
    assert stats["models"]["only"]["packed"] is False


# -- packing mechanics -----------------------------------------------


def test_packed_classsum_columns_exact():
    """The packing theorem, no server: fused class-sum columns [lo:hi)
    equal the solo machine's sums for every member and backend."""
    (cfg1, s1), (cfg2, s2) = _tm(seed=12), _tm(seed=13, c=5, density=0.3)
    fused_cfg = TMConfig(n_classes=cfg1.n_classes + cfg2.n_classes,
                         n_clauses=M, n_features=F)
    fused = fuse_states([s1, s2])
    rng = np.random.default_rng(14)
    lits = torch.as_tensor(rng.integers(0, 2, (6, cfg1.n_literals),
                                        dtype=np.int8))
    for backend in ("oracle", "swar_packed", "adder_tree", "mxu_fused",
                    "swar_fused"):
        got = get_engine(backend, fused_cfg, fused).infer(lits).class_sums
        torch.testing.assert_close(
            got[:, :cfg1.n_classes],
            get_engine(backend, cfg1, s1).infer(lits).class_sums,
            rtol=0, atol=0)
        torch.testing.assert_close(
            got[:, cfg1.n_classes:],
            get_engine(backend, cfg2, s2).infer(lits).class_sums,
            rtol=0, atol=0)


def test_unpack_tie_breaking_lowest_index():
    """All-zero-include members: every class sum ties, so each member's
    unpacked prediction is class 0 (the engine tie rule), not the fused
    argmax position."""
    cfg, s1 = _tm(seed=15, density=0.0)
    _, s2 = _tm(seed=16, density=0.0)

    async def go():
        async with TMFleet({"a": (cfg, s1), "b": (cfg, s2)},
                           ServePolicy(max_batch=4), device="cpu") as fleet:
            lits = np.ones((3, cfg.n_literals), np.int8)
            return (await fleet.submit("a", lits),
                    await fleet.submit("b", lits))

    for res in _run(go()):
        assert np.all(res.prediction == 0)
        assert np.all(res.class_sums == res.class_sums[:, :1])  # tied


def test_pack_group_formation_rules():
    """Models group iff they share (n_clauses, n_features, n_states);
    class count and T/s may differ."""
    specs = {"a": _tm(seed=17), "b": _tm(seed=18, c=6),
             "c": _tm(seed=19, m=4), "d": _tm(seed=20, f=5)}
    assert pack_key(specs["a"][0]) == pack_key(specs["b"][0])
    assert pack_key(specs["a"][0]) != pack_key(specs["c"][0])

    async def go():
        async with TMFleet(dict(specs), ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            return fleet.stats()

    stats = _run(go())
    assert stats["n_groups"] == 1
    assert stats["groups"][0]["members"] == ["a", "b"]
    assert stats["groups"][0]["fused_classes"] == 3 + 6
    assert stats["models"]["a"]["segment"] == [0, 3]
    assert stats["models"]["b"]["segment"] == [3, 9]
    assert not stats["models"]["c"]["packed"]
    assert not stats["models"]["d"]["packed"]


def test_per_client_order_preserved_per_model():
    """Sequentially awaiting clients of different models interleave
    freely, but each (model, client) stream completes in order and
    exactly once."""
    models = {"a": _tm(seed=21), "b": _tm(seed=22)}
    completions = []

    async def client(fleet, name, cid, n_reqs, rng):
        cfg = models[name][0]
        for i in range(n_reqs):
            lits = rng.integers(0, 2, (int(rng.integers(1, 4)),
                                       cfg.n_literals), dtype=np.int8)
            await fleet.submit(name, lits, client=cid)
            completions.append((name, cid, i))

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=8,
                                                     max_wait_us=300),
                           device="cpu") as fleet:
            rngs = [np.random.default_rng(30 + i) for i in range(4)]
            await asyncio.gather(
                client(fleet, "a", 0, 6, rngs[0]),
                client(fleet, "a", 1, 6, rngs[1]),
                client(fleet, "b", 0, 6, rngs[2]),
                client(fleet, "b", 1, 6, rngs[3]))

    _run(go())
    assert len(completions) == len(set(completions)) == 24
    for name in ("a", "b"):
        for cid in (0, 1):
            seqs = [i for n, c, i in completions if (n, c) == (name, cid)]
            assert seqs == sorted(seqs)


# -- publishes, version pins, shed tiers ------------------------------


def test_sibling_unaffected_by_update():
    """A's online updates never perturb B's responses (same pack group),
    and A's responses change exactly when its version does."""
    models = {"a": _tm(seed=23), "b": _tm(seed=24, density=0.4)}
    rng = np.random.default_rng(25)
    lits = rng.integers(0, 2, (4, models["a"][0].n_literals), dtype=np.int8)
    labels = rng.integers(0, C, 4).astype(np.int32)

    async def go():
        specs = {"a": {"cfg": models["a"][0], "state": models["a"][1],
                       "train_backend": "fused"},
                 "b": models["b"]}
        async with TMFleet(specs, ServePolicy(max_batch=8),
                           device="cpu") as fleet:
            b_before = await fleet.submit("b", lits)
            a_before = await fleet.submit("a", lits)
            for _ in range(3):
                await fleet.submit_labeled("a", lits, labels)
            b_after = await fleet.submit("b", lits)
            a_after = await fleet.submit("a", lits)
            return b_before, b_after, a_before, a_after, fleet.stats()

    b0, b1, a0, a1, stats = _run(go())
    np.testing.assert_array_equal(b0.class_sums, b1.class_sums)
    assert stats["models"]["a"]["version"] == 3
    assert stats["models"]["b"]["version"] == 0
    # a's state moved (3 reinforced updates on 2F=18 literals)
    assert not np.array_equal(a0.class_sums, a1.class_sums)


def test_shed_tier_packed_isolation():
    """Cascade shed tier with exact sums on both sides: the isolation
    contract holds when every batch routes to the tier (shed_qdepth=0)."""
    models = {"a": _tm(seed=26), "b": _tm(seed=27)}
    policy = ServePolicy(max_batch=8, shed_backend="cascade",
                         shed_qdepth=0, shed_opts={"exact_sums": True})
    trace = _trace(models, 10, seed=28)
    stats = _isolation_check(models, dict(models), policy, trace)
    assert stats["groups"][0]["requests"] > 0


def test_shed_tier_default_opts_packed_predictions_exact():
    """Default cascade opts (exact_sums=False fleet-wide): the group is
    still forced exact, so packed members' predictions and class sums
    equal the oracle."""
    models = {"a": _tm(seed=60), "b": _tm(seed=61, c=4, density=0.35)}
    rng = np.random.default_rng(62)
    lits = rng.integers(0, 2, (5, models["a"][0].n_literals), dtype=np.int8)

    async def go():
        policy = ServePolicy(max_batch=8, shed_backend="cascade",
                             shed_qdepth=0)
        async with TMFleet(dict(models), policy, device="cpu") as fleet:
            return (await fleet.submit("a", lits),
                    await fleet.submit("b", lits))

    for name, res in zip(("a", "b"), _run(go())):
        ref = _oracle(*models[name], lits)
        np.testing.assert_array_equal(res.prediction,
                                      ref.prediction.numpy())
        np.testing.assert_array_equal(res.class_sums,
                                      ref.class_sums.numpy())


def test_group_policy_forces_exact_sums():
    """_group_policy flips a cascade shed tier to exact_sums=True and
    leaves everything else (and non-cascade tiers) alone."""
    p = ServePolicy(shed_backend="cascade", shed_qdepth=2)
    assert p.resolved_shed_opts() == {"exact_sums": False}
    gp = _group_policy(p)
    assert gp.resolved_shed_opts()["exact_sums"] is True
    assert gp.shed_qdepth == 2 and gp.max_batch == p.max_batch
    p2 = ServePolicy(shed_backend="oracle")
    assert _group_policy(p2) is p2
    assert _group_policy(ServePolicy()) is not None


def test_deadline_rejects_counted_per_model():
    """Admission control flows through the fleet: an unmeetable deadline
    raises DeadlineExceeded and lands in that model's reject counter."""
    cfg, state = _tm(seed=29)

    async def go():
        async with TMFleet({"a": (cfg, state), "b": _tm(seed=30)},
                           ServePolicy(max_batch=4), device="cpu") as fleet:
            lits = np.ones((2, cfg.n_literals), np.int8)
            for _ in range(3):       # establish a service-time floor
                await fleet.submit("a", lits)
            with pytest.raises(DeadlineExceeded):
                await fleet.submit("a", lits, deadline_us=1)
            return fleet.stats()

    stats = _run(go())
    assert stats["models"]["a"]["rejects"] == 1
    assert stats["models"]["a"]["errors"] == 0
    assert stats["models"]["b"]["rejects"] == 0


# -- per-model lifecycle through the fleet ----------------------------


def test_checkpoint_restore_bitexact_through_fleet(tmp_path):
    """Kill and restore one fleet member mid-trace: the restored fleet's
    remaining trace equals an uninterrupted solo run, and the pack group
    serves the restored state."""
    models = {"a": _tm(seed=31), "b": _tm(seed=32)}
    cfg_a, s_a = models["a"]
    rng = np.random.default_rng(33)
    batches = [(rng.integers(0, 2, (3, cfg_a.n_literals), dtype=np.int8),
                rng.integers(0, C, 3).astype(np.int32)) for _ in range(6)]
    probe = rng.integers(0, 2, (2, cfg_a.n_literals), dtype=np.int8)
    spec = {"cfg": cfg_a, "state": s_a, "train_backend": "fused",
            "checkpoint_dir": str(tmp_path / "a")}

    def fleet_specs():
        return {"a": dict(spec), "b": models["b"]}

    async def phase1():
        async with TMFleet(fleet_specs(), ServePolicy(max_batch=4),
                           device="cpu") as fl:
            for lits, labels in batches[:3]:
                await fl.submit_labeled("a", lits, labels)
            fl.checkpoint("a")

    async def phase2():
        fl = TMFleet(fleet_specs(), ServePolicy(max_batch=4), device="cpu")
        assert fl.restore("a") == 3
        async with fl:
            for lits, labels in batches[3:]:
                await fl.submit_labeled("a", lits, labels)
            return ((await fl.submit("a", probe)).class_sums,
                    (await fl.submit("b", probe)).class_sums)

    _run(phase1())
    got_a, got_b = _run(phase2())

    async def uninterrupted():
        async with TMServer(cfg_a, s_a, ServePolicy(max_batch=4),
                            device="cpu", train_backend="fused") as srv:
            for lits, labels in batches:
                await srv.submit_labeled(lits, labels)
            return (await srv.submit(probe)).class_sums

    np.testing.assert_array_equal(got_a, _run(uninterrupted()))
    np.testing.assert_array_equal(
        got_b, _oracle(*models["b"], probe).class_sums.numpy())


def test_rollback_per_model_in_trace():
    """Rollback of one packed member mid-trace equals the solo replay
    with the rollback at the same position; the sibling never moves."""
    models = {"a": _tm(seed=34), "b": _tm(seed=35)}
    cfg, _ = models["a"]
    rng = np.random.default_rng(36)
    lits = rng.integers(0, 2, (3, cfg.n_literals), dtype=np.int8)
    labels = rng.integers(0, C, 3).astype(np.int32)
    trace = [("a", "predict", lits), ("b", "predict", lits),
             ("a", "update", lits, labels), ("a", "update", lits, labels),
             ("a", "predict", lits), ("a", "rollback", 0),
             ("a", "predict", lits), ("b", "predict", lits)]
    specs = {"a": {"cfg": cfg, "state": models["a"][1],
                   "train_backend": "fused"},
             "b": models["b"]}
    _isolation_check(models, specs, ServePolicy(max_batch=4), trace,
                     server_kw={"a": {"train_backend": "fused"}})


# -- weighted engine cache under a fleet budget -----------------------


@pytest.fixture
def fresh_cache():
    """Reset the process-wide engine cache and budget around a test."""
    clear_engine_cache()
    set_engine_cache_budget(ENGINE_CACHE_SIZE, 0)
    yield
    clear_engine_cache()
    set_engine_cache_budget(ENGINE_CACHE_SIZE, 0)


def _states(n, seed=0):
    cfg = TMConfig(n_classes=2, n_clauses=4, n_features=3)
    rng = np.random.default_rng(seed)
    return cfg, [state_from_numpy(
        np.where(rng.random((2, 4, 6)) < 0.3, cfg.n_states + 1,
                 cfg.n_states), device="cpu") for _ in range(n)]


def test_weighted_eviction_hot_model_survives():
    """Entry budget 2, weights 5.0 / 0.1 / 1.0: the light entry falls out
    first although it was touched most recently."""
    cache = KeyedEngineCache(maxsize=2)
    cfg, states = _states(3, seed=40)
    for s, w in zip(states, (5.0, 0.1, 1.0)):
        cache.set_state_weight(s, w)
    cache.insert("hot", states[0], "e0")
    cache.insert("cold", states[1], "e1")
    cache.insert("warm", states[2], "e2")     # evicts "cold", not "hot"
    assert cache.get("hot") == "e0"
    assert cache.get("warm") == "e2"
    assert cache.get("cold") is None
    assert cache.info()["evictions"] == 1


def test_weighted_eviction_equal_weights_is_lru():
    """No weights registered → pure LRU."""
    cache = KeyedEngineCache(maxsize=2)
    cfg, states = _states(3, seed=41)
    cache.insert("k0", states[0], "e0")
    cache.insert("k1", states[1], "e1")
    assert cache.get("k0") == "e0"            # refresh k0: k1 is now LRU
    cache.insert("k2", states[2], "e2")
    assert cache.get("k1") is None
    assert cache.get("k0") == "e0" and cache.get("k2") == "e2"


def test_byte_budget_evicts_to_fit():
    """max_bytes below two states' footprint keeps exactly the heavy
    entry; info() reconciles bytes with the survivors."""
    cfg, states = _states(2, seed=42)
    per = state_nbytes(states[0])
    cache = KeyedEngineCache(maxsize=8, max_bytes=int(per * 1.5))
    cache.set_state_weight(states[0], 0.1)
    cache.set_state_weight(states[1], 9.0)
    cache.insert("light", states[0], "e0")
    cache.insert("heavy", states[1], "e1")
    info = cache.info()
    assert info["size"] == 1 and info["bytes"] == per
    assert cache.get("heavy") == "e1"


def test_replacement_accounting_no_drift():
    """Replacing an existing key (the duplicate-build race) counts the
    displaced entry, keeping ``misses == size + evictions +
    superseded``."""
    cfg, states = _states(1, seed=43)
    cache = KeyedEngineCache(maxsize=4)
    cache.insert("k", states[0], "first")
    cache.insert("k", states[0], "second")    # the racing twin
    info = cache.info()
    assert cache.get("k") == "second"
    assert info["misses"] == 2 and info["size"] == 1
    assert info["evictions"] == 1
    assert info["misses"] == (info["size"] + info["evictions"]
                              + info["superseded"])


def test_counter_reconciliation_identity():
    """Mixed insert / capacity-evict / supersede / replace sequence: the
    identity holds at every step, and weights and bytes die with their
    state."""
    cfg, states = _states(6, seed=44)
    cache = KeyedEngineCache(maxsize=3)

    def check():
        info = cache.info()
        assert info["misses"] == (info["size"] + info["evictions"]
                                  + info["superseded"]), info

    for i, s in enumerate(states[:4]):
        cache.insert(f"k{i}", s, f"e{i}")     # 4th insert LRU-evicts
        check()
    cache.evict_state(states[2])              # superseded
    check()
    cache.insert("k3", states[3], "e3b")      # replacement
    check()
    cache.insert("k4", states[4], "e4")
    cache.insert("k5", states[5], "e5")
    check()
    cache.set_state_weight(states[5], 2.0)
    assert cache.info()["weights"] == 1
    del states[5]                             # the weight and entry die
    info = cache.info()
    assert info["weights"] == 0
    assert info["bytes"] == info["size"] * state_nbytes(states[0])
    check()


def test_set_budget_shrink_evicts(fresh_cache):
    """Shrinking the process budget evicts at once, lightest first;
    growing it back never resurrects."""
    cfg, states = _states(4, seed=45)
    for i, s in enumerate(states):
        weight_engines_for_state(s, 10.0 if i == 0 else 0.5)
        get_engine("oracle", cfg, s)
    assert engine_cache_info()["size"] == 4
    info = set_engine_cache_budget(max_entries=2)
    assert info["size"] == 2
    # the heavy state's engine survived the shrink
    hits_before = engine_cache_info()["hits"]
    get_engine("oracle", cfg, states[0])
    assert engine_cache_info()["hits"] == hits_before + 1
    set_engine_cache_budget(max_entries=ENGINE_CACHE_SIZE)
    assert engine_cache_info()["size"] == 2


def test_fleet_budget_and_static_weights(fresh_cache):
    """A fleet built with a cache budget and static weights applies both:
    info() shows the budget, stats() the pinned weights, and weights are
    registered for the served states."""
    models = {"hot": _tm(seed=46), "cold": _tm(seed=47, m=4)}

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=4),
                           device="cpu", cache_entries=6,
                           weights={"hot": 8.0, "cold": 0.25}) as fleet:
            await fleet.submit("hot", np.ones(
                (2, models["hot"][0].n_literals), np.int8))
            await fleet.submit("cold", np.ones(
                (2, models["cold"][0].n_literals), np.int8))
            return fleet.stats()

    stats = _run(go())
    assert stats["engine_cache"]["maxsize"] == 6
    assert stats["models"]["hot"]["weight"] == 8.0
    assert stats["models"]["cold"]["weight"] == 0.25
    assert stats["engine_cache"]["weights"] > 0


def test_popularity_weight_tracks_requests(fresh_cache):
    """Without static weights the measured request share drives the
    weight: the hammered model ends up strictly heavier."""
    models = {"hot": _tm(seed=48), "cold": _tm(seed=49, m=4)}

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=8),
                           device="cpu") as fleet:
            lits = np.ones((1, models["hot"][0].n_literals), np.int8)
            for _ in range(64):
                await fleet.submit("hot", lits)
            await fleet.submit("cold", np.ones(
                (1, models["cold"][0].n_literals), np.int8))
            return fleet.stats()

    stats = _run(go())
    assert (stats["models"]["hot"]["weight"]
            > stats["models"]["cold"]["weight"])
    assert stats["models"]["hot"]["requests"] == 64


def test_byte_budget_hot_model_outlives_cold_sibling(fresh_cache):
    """Under a byte budget that holds one model's engines, the fleet's
    measured weights keep the hot model's engine cached while the cold
    sibling's, touched last, is the one evicted."""
    models = {"hot": _tm(seed=63), "cold": _tm(seed=64, m=4)}
    budget = state_nbytes(models["hot"][1]) + 1

    async def go():
        async with TMFleet(dict(models),
                           ServePolicy(max_batch=8, backend="oracle"),
                           device="cpu", cache_bytes=budget) as fleet:
            lits = np.ones((1, models["hot"][0].n_literals), np.int8)
            for _ in range(64):                # crosses _REWEIGHT_EVERY
                await fleet.submit("hot", lits)
            await fleet.submit("cold", np.ones(
                (1, models["cold"][0].n_literals), np.int8))
            hot_srv = fleet.server_for("hot")
            hits = engine_cache_info()["hits"]
            await fleet.submit("hot", lits)
            return fleet.stats(), hot_srv, engine_cache_info()["hits"] - hits

    stats, hot_srv, new_hits = _run(go())
    assert stats["models"]["hot"]["weight"] > stats["models"]["cold"]["weight"]
    assert stats["engine_cache"]["max_bytes"] == budget
    assert stats["engine_cache"]["bytes"] <= budget
    assert new_hits == 1        # the hot engine was still cached


# -- fleet lifecycle: add / drain / errors ----------------------------


def test_add_model_to_running_fleet():
    """add_model on a live fleet serves at once (solo), and its answers
    equal the oracle."""
    new_cfg, new_state = _tm(seed=51, c=4)

    async def go():
        async with TMFleet({"a": _tm(seed=50)}, ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            await fleet.add_model("late", (new_cfg, new_state))
            res = await fleet.submit(
                "late", np.ones((3, new_cfg.n_literals), np.int8))
            return res, fleet.stats()

    res, stats = _run(go())
    ref = _oracle(new_cfg, new_state, np.ones((3, new_cfg.n_literals),
                                              np.int8))
    np.testing.assert_array_equal(res.class_sums, ref.class_sums.numpy())
    assert stats["n_models"] == 2
    assert stats["models"]["late"]["packed"] is False


def test_drain_solo_model():
    """Draining removes the model (submit → KeyError) while siblings keep
    serving."""
    models = {"a": _tm(seed=52), "b": _tm(seed=53, m=4)}

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            await fleet.drain("b")
            with pytest.raises(KeyError):
                await fleet.submit("b", np.ones(
                    (1, models["b"][0].n_literals), np.int8))
            res = await fleet.submit(
                "a", np.ones((2, models["a"][0].n_literals), np.int8))
            return res, fleet.stats()

    res, stats = _run(go())
    assert stats["n_models"] == 1
    assert res.prediction.shape == (2,)


def test_drain_packed_member_resegments():
    """Draining one pack-group member moves the survivor to columns
    [0, C), and its responses still equal the oracle."""
    models = {"a": _tm(seed=54), "b": _tm(seed=55, c=5, density=0.35)}
    rng = np.random.default_rng(56)
    lits = rng.integers(0, 2, (4, models["b"][0].n_literals), dtype=np.int8)

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=8),
                           device="cpu") as fleet:
            before = await fleet.submit("b", lits)
            await fleet.drain("a")
            after = await fleet.submit("b", lits)
            return before, after, fleet.stats()

    before, after, stats = _run(go())
    ref = _oracle(*models["b"], lits).class_sums.numpy()
    for res in (before, after):
        np.testing.assert_array_equal(res.class_sums, ref)
    assert stats["models"]["b"]["segment"] == [0, 5]
    assert stats["n_models"] == 1


def test_drain_regroups_under_inflight_siblings():
    """Draining one member of a three-member group while sibling requests
    are in flight: the in-flight ones finish on the segment and fused
    state they captured, later ones on the rebuilt two-member group, and
    all equal the oracle."""
    models = {"a": _tm(seed=65), "b": _tm(seed=66, c=4),
              "c": _tm(seed=67, c=2, density=0.3)}
    rng = np.random.default_rng(68)
    reqs = [(n, rng.integers(0, 2, (int(rng.integers(1, 5)), 2 * F),
                             dtype=np.int8)) for n in "bcbcbc"]

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=16,
                                                     max_wait_us=2000),
                           device="cpu") as fleet:
            inflight = [asyncio.ensure_future(fleet.submit(n, lits))
                        for n, lits in reqs]
            await asyncio.sleep(0)
            await fleet.drain("a")
            later = [await fleet.submit(n, lits) for n, lits in reqs]
            return await asyncio.gather(*inflight), later, fleet.stats()

    first, later, stats = _run(go())
    for out in (first, later):
        for (name, lits), res in zip(reqs, out):
            ref = _oracle(*models[name], lits)
            np.testing.assert_array_equal(res.prediction,
                                          ref.prediction.numpy())
            np.testing.assert_array_equal(res.class_sums,
                                          ref.class_sums.numpy())
    assert stats["groups"][0]["members"] == ["b", "c"]
    assert stats["models"]["c"]["segment"] == [4, 6]


def test_unknown_model_and_duplicate_name():
    """Routing errors are crisp: unknown name → KeyError naming the
    served set; duplicate add_model → ValueError; drain of an unknown
    name → KeyError; a 2-D mesh, or a device outside the mesh, is
    refused."""
    cfg, state = _tm(seed=57)

    async def go():
        async with TMFleet({"a": (cfg, state)}, ServePolicy(max_batch=2),
                           device="cpu") as fleet:
            with pytest.raises(KeyError, match="unknown model"):
                await fleet.submit("nope", np.ones((1, cfg.n_literals),
                                                   np.int8))
            with pytest.raises(ValueError, match="duplicate"):
                await fleet.add_model("a", (cfg, state))
            with pytest.raises(KeyError, match="unknown model"):
                await fleet.drain("nope")

    _run(go())
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="1-D"):
        TMFleet({"a": (cfg, state)}, device="cpu",
                mesh=Mesh((cpu,) * 4, ("data", "model"), (2, 2)))
    with pytest.raises(ValueError, match="not in the mesh"):
        TMFleet({"a": (cfg, state)}, device="cuda:1",
                mesh=data_mesh(2, devices=[cpu] * 2))


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "solo"])
def test_fleet_mesh_trace_equals_unmeshed(pack):
    """``TMFleet(mesh=)`` over a simulated 4-shard CPU mesh: the same
    trace (two same-shape learners, ``sharded`` against ``fused``, and a
    model of another shape) answers bitwise as the fleet without a mesh
    — predictions, class sums and versions — and every member and group
    server serves over the mesh."""
    models = {"a": _tm(seed=61), "b": _tm(seed=62),
              "c": _tm(seed=63, c=2, m=6)}
    trace = _trace(models, 24, seed=64, trainable=("a", "b"))
    policy = ServePolicy(max_batch=4, backend="swar_packed")
    mesh = data_mesh(4, devices=[torch.device("cpu")] * 4)

    def specs(train_backend):
        return {name: ({"cfg": cfg, "state": st,
                        "train_backend": train_backend}
                       if name in ("a", "b") else (cfg, st))
                for name, (cfg, st) in models.items()}

    plain, _ = _run_fleet(specs("fused"), policy, trace, pack=pack)
    meshed, stats = _run_fleet(specs("sharded"), policy, trace, pack=pack,
                               mesh=mesh)
    for name in models:
        _assert_same(meshed[name], plain[name], model=name)
    assert any(op[0] == "update" for op in meshed["a"])
    assert len(stats["groups"]) == (1 if pack else 0)


def test_empty_fleet_rejected():
    """A fleet with no models is a construction error."""
    with pytest.raises(ValueError, match="at least one model"):
        TMFleet({}, device="cpu")


def test_stats_structure():
    """The observability contract: fleet-level keys, per-model summary
    keys, group rows and the nested member server stats."""
    models = {"a": _tm(seed=58), "b": _tm(seed=59)}

    async def go():
        async with TMFleet(dict(models), ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            await fleet.submit("a", np.ones((1, models["a"][0].n_literals),
                                            np.int8))
            return fleet.stats()

    stats = _run(go())
    for key in ("n_models", "n_groups", "packed_models", "models",
                "groups", "engine_cache"):
        assert key in stats, key
    a = stats["models"]["a"]
    for key in ("requests", "errors", "rejects", "p50_ms", "p99_ms",
                "packed", "group", "segment", "version", "updates",
                "weight", "state_nbytes", "server"):
        assert key in a, key
    assert a["server"]["state_version"] == a["version"]
    g = stats["groups"][0]
    for key in ("members", "fused_classes", "shape", "requests",
                "mean_batch_rows"):
        assert key in g, key
    for key in ("size", "maxsize", "bytes", "max_bytes", "weights",
                "hits", "misses", "evictions", "superseded"):
        assert key in stats["engine_cache"], key


# -- fault containment (tests/test_fault_tolerance.py's fleet half) ----


def test_fleet_failing_update_contained():
    """A malformed labeled batch for one packed member raises to its
    caller only: the sibling is untouched, the error lands in the failing
    model's stats, and a later good update goes through."""
    (cfg_a, s_a), (cfg_b, s_b) = _tm(seed=1), _tm(seed=2, density=0.4)
    rng = np.random.default_rng(3)
    lits = rng.integers(0, 2, (2, cfg_a.n_literals), dtype=np.int8)
    labels = rng.integers(0, cfg_a.n_classes, 2).astype(np.int32)
    bad_lits = np.ones((2, 6), np.int8)        # wrong literal width

    async def go():
        specs = {"a": {"cfg": cfg_a, "state": s_a, "train_backend": "fused"},
                 "b": (cfg_b, s_b)}
        async with TMFleet(specs, ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            b_before = await fleet.submit("b", lits)
            with pytest.raises(ValueError):
                await fleet.submit_labeled("a", bad_lits, labels)
            b_after = await fleet.submit("b", lits)
            a_res = await fleet.submit("a", lits)
            good_version = await fleet.submit_labeled("a", lits, labels)
            return b_before, b_after, a_res, good_version, fleet.stats()

    b0, b1, a_res, good_version, stats = _run(go())
    np.testing.assert_array_equal(b0.class_sums, b1.class_sums)
    # the failed update neither bumped the version nor moved the state
    np.testing.assert_array_equal(
        a_res.class_sums, _oracle(cfg_a, s_a, lits).class_sums.numpy())
    assert good_version == 1
    assert stats["models"]["a"]["errors"] == 1
    assert stats["models"]["a"]["errors_total"] >= 1
    assert stats["models"]["b"]["errors"] == 0


def test_fleet_corrupt_checkpoint_contained(tmp_path):
    """A corrupt on-disk checkpoint fails that model's restore — the
    fleet still builds, starts and serves every model (the corrupt one
    from its initial state), and the sibling never notices."""
    (cfg_a, s_a), (cfg_b, s_b) = _tm(seed=4), _tm(seed=5, m=4)
    rng = np.random.default_rng(6)
    lits = rng.integers(0, 2, (2, cfg_a.n_literals), dtype=np.int8)
    labels = rng.integers(0, cfg_a.n_classes, 2).astype(np.int32)
    ckpt_dir = tmp_path / "a"

    def specs():
        return {"a": {"cfg": cfg_a, "state": s_a, "train_backend": "fused",
                      "checkpoint_dir": str(ckpt_dir)},
                "b": (cfg_b, s_b)}

    async def write_checkpoint():
        async with TMFleet(specs(), ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            await fleet.submit_labeled("a", lits, labels)
            fleet.checkpoint("a")

    _run(write_checkpoint())
    shard = ckpt_dir / "step_1" / "shard_0.npz"
    assert shard.exists()
    shard.write_bytes(b"not a checkpoint")
    b_lits = rng.integers(0, 2, (2, cfg_b.n_literals), dtype=np.int8)

    async def recover():
        fleet = TMFleet(specs(), ServePolicy(max_batch=4), device="cpu")
        with pytest.raises(Exception):
            fleet.restore("a")
        async with fleet:
            return (await fleet.submit("a", lits),
                    await fleet.submit("b", b_lits), fleet.stats())

    a_res, b_res, stats = _run(recover())
    np.testing.assert_array_equal(
        a_res.class_sums, _oracle(cfg_a, s_a, lits).class_sums.numpy())
    np.testing.assert_array_equal(
        b_res.class_sums, _oracle(cfg_b, s_b, b_lits).class_sums.numpy())
    assert stats["models"]["a"]["version"] == 0    # restore never landed


def test_fleet_engine_build_failure_contained(monkeypatch):
    """An engine-build exception on one model's serving plane rejects
    that model's requests (counted under its errors) while the sibling
    keeps serving; lifting the fault restores service with no restart."""
    (cfg_a, s_a), (cfg_b, s_b) = _tm(seed=7), _tm(seed=8, m=4)
    rng = np.random.default_rng(9)
    lits_a = rng.integers(0, 2, (2, cfg_a.n_literals), dtype=np.int8)
    lits_b = rng.integers(0, 2, (2, cfg_b.n_literals), dtype=np.int8)

    import repro_torch.serve.tm_server as tm_server_mod
    real_get_engine = tm_server_mod.get_engine

    def failing_get_engine(name, cfg, state, **kw):
        if cfg.n_clauses == cfg_a.n_clauses:
            raise RuntimeError("injected engine-build failure")
        return real_get_engine(name, cfg, state, **kw)

    async def go():
        async with TMFleet({"a": (cfg_a, s_a), "b": (cfg_b, s_b)},
                           ServePolicy(max_batch=4), device="cpu") as fleet:
            # inject after start: construction-time publishes are clean
            monkeypatch.setattr(tm_server_mod, "get_engine",
                                failing_get_engine)
            with pytest.raises(RuntimeError, match="injected"):
                await fleet.submit("a", lits_a)
            b_res = await fleet.submit("b", lits_b)
            monkeypatch.setattr(tm_server_mod, "get_engine",
                                real_get_engine)
            a_res = await fleet.submit("a", lits_a)
            return b_res, a_res, fleet.stats()

    b_res, a_res, stats = _run(go())
    np.testing.assert_array_equal(
        b_res.class_sums, _oracle(cfg_b, s_b, lits_b).class_sums.numpy())
    np.testing.assert_array_equal(
        a_res.class_sums, _oracle(cfg_a, s_a, lits_a).class_sums.numpy())
    assert stats["models"]["a"]["errors"] == 1
    assert stats["models"]["b"]["errors"] == 0


def test_fleet_rollback_recovers_bad_update():
    """``rollback(model, 0)`` re-publishes the initial state for that
    model alone: its responses return to the v0 oracle, the sibling's
    never moved, and the member's stats record the rollback."""
    (cfg_a, s_a), (cfg_b, s_b) = _tm(seed=10), _tm(seed=11, density=0.35)
    rng = np.random.default_rng(12)
    lits = rng.integers(0, 2, (3, cfg_a.n_literals), dtype=np.int8)
    labels = rng.integers(0, cfg_a.n_classes, 3).astype(np.int32)

    async def go():
        specs = {"a": {"cfg": cfg_a, "state": s_a, "train_backend": "fused"},
                 "b": (cfg_b, s_b)}
        async with TMFleet(specs, ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            for _ in range(2):
                await fleet.submit_labeled("a", lits, labels)
            new_version = fleet.rollback("a", 0)
            return (new_version, await fleet.submit("a", lits),
                    await fleet.submit("b", lits), fleet.stats())

    new_version, a_res, b_res, stats = _run(go())
    assert new_version == 3                       # monotonic bump
    np.testing.assert_array_equal(
        a_res.class_sums, _oracle(cfg_a, s_a, lits).class_sums.numpy())
    np.testing.assert_array_equal(
        b_res.class_sums, _oracle(cfg_b, s_b, lits).class_sums.numpy())
    assert stats["models"]["a"]["server"]["rollbacks"] == 1
    assert stats["models"]["b"]["version"] == 0


def test_fleet_restore_recovers_after_kill(tmp_path):
    """Kill and restart through the fleet: the checkpointed model resumes
    at its saved version and state, the sibling starts fresh."""
    (cfg_a, s_a), (cfg_b, s_b) = _tm(seed=13), _tm(seed=14, m=4)
    rng = np.random.default_rng(15)
    lits = rng.integers(0, 2, (2, cfg_a.n_literals), dtype=np.int8)
    labels = rng.integers(0, cfg_a.n_classes, 2).astype(np.int32)
    ckpt_dir = tmp_path / "a"

    def specs():
        return {"a": {"cfg": cfg_a, "state": s_a, "train_backend": "fused",
                      "checkpoint_dir": str(ckpt_dir)},
                "b": (cfg_b, s_b)}

    async def run_and_checkpoint():
        async with TMFleet(specs(), ServePolicy(max_batch=4),
                           device="cpu") as fleet:
            for _ in range(2):
                await fleet.submit_labeled("a", lits, labels)
            fleet.checkpoint("a")
            return (await fleet.submit("a", lits)).class_sums

    sums_before_kill = _run(run_and_checkpoint())

    async def restart():
        fleet = TMFleet(specs(), ServePolicy(max_batch=4), device="cpu")
        assert fleet.restore("a") == 2
        async with fleet:
            return (await fleet.submit("a", lits)).class_sums, fleet.stats()

    sums_after_restart, stats = _run(restart())
    np.testing.assert_array_equal(sums_after_restart, sums_before_kill)
    assert stats["models"]["a"]["version"] == 2
    assert stats["models"]["b"]["version"] == 0


# -- engine-cache thread safety (tests/test_engine_threads.py) ---------


def test_engine_cache_concurrent_get_and_clear(fresh_cache):
    """8 workers × 250 iterations over 2 × cache-size states, with
    interleaved clears: no exception, bounded size."""
    cfg, states = _states(2 * ENGINE_CACHE_SIZE)
    backends = ("oracle", "swar_packed")

    def hammer(worker_id: int) -> int:
        rng = random.Random(worker_id)
        for i in range(250):
            state = states[rng.randrange(len(states))]
            engine = get_engine(backends[i % len(backends)], cfg, state)
            assert engine.cfg is cfg
            if i % 41 == worker_id % 41:
                clear_engine_cache()
            if i % 17 == 0:
                engine_cache_info()
        return worker_id

    with ThreadPoolExecutor(max_workers=8) as pool:
        assert sorted(pool.map(hammer, range(8), timeout=LIMIT_S)) == \
            list(range(8))
    info = engine_cache_info()
    assert info["size"] <= info["maxsize"] == ENGINE_CACHE_SIZE


def test_engine_cache_concurrent_infer_correctness(fresh_cache):
    """Engines fetched concurrently still answer correctly: each thread
    checks its state's engine against a precomputed oracle result."""
    cfg, states = _states(6, seed=1)
    rng = np.random.default_rng(2)
    lits = torch.as_tensor(rng.integers(0, 2, (5, cfg.n_literals),
                                        dtype=np.int8))
    expected = [get_engine("oracle", cfg, s).infer(lits).prediction
                for s in states]
    clear_engine_cache()

    def worker(worker_id: int) -> None:
        rng = random.Random(worker_id)
        for i in range(60):
            j = rng.randrange(len(states))
            pred = get_engine("oracle", cfg, states[j]).infer(lits)
            assert torch.equal(pred.prediction, expected[j])
            if i % 23 == 0:
                clear_engine_cache()

    with ThreadPoolExecutor(max_workers=6) as pool:
        list(pool.map(worker, range(6), timeout=LIMIT_S))


def test_weighted_cache_concurrent_publish_accounting(fresh_cache):
    """Concurrent per-model publishes against the weighted, budgeted
    cache: ``misses == size + evictions + superseded`` under every
    interleaving (duplicate builds included: workers share states), with
    a short switch interval so the threads interleave densely."""
    set_engine_cache_budget(max_entries=6, max_bytes=0)
    cfg, states = _states(24, seed=3)
    backends = ("oracle", "swar_packed")

    def publish_hammer(worker_id: int) -> int:
        rng = random.Random(100 + worker_id)
        for i in range(200):
            state = states[rng.randrange(len(states))]
            weight_engines_for_state(state, rng.uniform(0.1, 8.0))
            get_engine(backends[i % len(backends)], cfg, state)
            if i % 13 == worker_id % 13:
                # a publish superseding this worker's previous state
                evict_engines_for_state(states[rng.randrange(len(states))])
            if i % 29 == 0:
                info = engine_cache_info()
                assert info["size"] <= info["maxsize"]
        return worker_id

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            assert sorted(pool.map(publish_hammer, range(8),
                                   timeout=LIMIT_S)) == list(range(8))
    finally:
        sys.setswitchinterval(interval)
    # the states stay alive: no weakref-death eviction is in flight, so
    # the counters must balance exactly
    info = engine_cache_info()
    assert info["misses"] == (info["size"] + info["evictions"]
                              + info["superseded"]), info
    assert info["size"] <= 6
    assert info["weights"] <= len(states) * len(states[0])


# -- cross-package parity: the JAX TMFleet against the port's ----------


def _parity_models():
    """Two pack groups (shape (7, 9) and (4, 9)), a solo shape (7, 6) and
    one learning member → {name: (c, m, f, seed, density)}."""
    return {"a": (3, 7, 9, 70, 0.2), "b": (5, 7, 9, 71, 0.35),
            "c": (3, 4, 9, 72, 0.3), "d": (2, 4, 9, 73, 0.25),
            "e": (3, 7, 6, 74, 0.2)}


def _parity_trace():
    """Predicts on every model, updates of the learner "a", a rollback of
    "a" and a drain of "d" (which dissolves its group) → op list."""
    models = _parity_models()
    rng = np.random.default_rng(75)

    def lits(name, n=None):
        f = models[name][2]
        return rng.integers(0, 2, (n or int(rng.integers(1, 5)), 2 * f),
                            dtype=np.int8)

    def upd():
        return ("a", "update", lits("a", 3),
                rng.integers(0, 3, 3).astype(np.int32))

    ops = [(n, "predict", lits(n)) for n in "abcde"]
    ops += [upd(), ("b", "predict", lits("b")), ("a", "predict", lits("a")),
            upd(), ("a", "predict", lits("a")), ("c", "predict", lits("c")),
            ("a", "rollback", 1), ("a", "predict", lits("a")),
            ("b", "predict", lits("b")), upd(), ("d", "drain"),
            ("c", "predict", lits("c")), ("a", "predict", lits("a")),
            ("e", "predict", lits("e")), upd(),
            ("b", "predict", lits("b")), ("a", "predict", lits("a"))]
    return ops


def _stats_keys(stats):
    """The key structure of a fleet ``stats()``: fleet-level keys, each
    model summary's keys (and its member server's top-level keys), each
    group row's keys and the engine-cache keys."""
    return {
        "fleet": sorted(stats),
        "models": {n: sorted(m) for n, m in stats["models"].items()},
        "server": {n: sorted(m["server"]) for n, m in
                   stats["models"].items()},
        "groups": [sorted(g) for g in stats["groups"]],
        "engine_cache": sorted(stats["engine_cache"]),
    }


def _drive(fleet_cls, specs, policy, trace, *, pack, to_np, **kw):
    """Serve ``trace`` through one package's fleet → (responses,
    published member states, stats)."""
    responses, published = [], []

    async def go():
        async with fleet_cls(specs, policy, pack=pack, **kw) as fleet:
            for name, op, *payload in trace:
                if op == "predict":
                    res = await fleet.submit(name, payload[0])
                    responses.append((name, np.asarray(res.prediction),
                                      np.asarray(res.class_sums)))
                elif op == "drain":
                    await fleet.drain(name)
                    continue
                elif op == "update":
                    v = await fleet.submit_labeled(name, *payload)
                else:
                    v = fleet.rollback(name, payload[0])
                if op != "predict":
                    published.append(
                        (name, v, to_np(fleet.server_for(name).state.ta)))
            return fleet.stats()

    stats = asyncio.run(asyncio.wait_for(go(), LIMIT_S))
    return responses, published, stats


@pytest.mark.parametrize("pack", [True, False])
def test_fleet_parity_vs_jax(pack):
    """One seeded trace through the JAX TMFleet and the port's: every
    response (prediction and class sums) and every published member
    state is bitwise equal, across updates, a rollback and a drain, and
    the stats() key sets are equal."""
    trace = _parity_trace()
    jspecs, pspecs = {}, {}
    for name, (c, m, f, seed, density) in _parity_models().items():
        ta = _ta(seed, c, m, f, density)
        extra = ({"train_backend": "fused", "train_seed": 5}
                 if name == "a" else {})
        jspecs[name] = {"cfg": JConfig(n_classes=c, n_clauses=m,
                                       n_features=f),
                        "state": JState(ta=jnp.asarray(ta)), **extra}
        pspecs[name] = {"cfg": TMConfig(n_classes=c, n_clauses=m,
                                        n_features=f),
                        "state": state_from_numpy(ta, device="cpu"),
                        **extra}
    want = _drive(JFleet, jspecs, JPolicy(max_batch=8, pipeline_depth=2),
                  trace, pack=pack, to_np=np.asarray)
    got = _drive(TMFleet, pspecs, ServePolicy(max_batch=8, pipeline_depth=2),
                 trace, pack=pack, to_np=lambda t: t.numpy(), device="cpu")
    (j_res, j_pub, j_stats), (p_res, p_pub, p_stats) = want, got
    assert len(p_res) == len(j_res) == sum(op[1] == "predict"
                                           for op in trace)
    for i, (a, b) in enumerate(zip(p_res, j_res)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"op {i} pred")
        np.testing.assert_array_equal(a[2], b[2], err_msg=f"op {i} sums")
    assert [(n, v) for n, v, _ in p_pub] == [(n, v) for n, v, _ in j_pub]
    for (n, v, pta), (_, _, jta) in zip(p_pub, j_pub):
        np.testing.assert_array_equal(pta, jta, err_msg=f"{n} v{v}")
    pk, jk = _stats_keys(p_stats), _stats_keys(j_stats)
    # the port's TMServer stats carry "device" beside the JAX key set
    pk["server"] = {n: [k for k in ks if k != "device"]
                    for n, ks in pk["server"].items()}
    assert pk == jk
    assert p_stats["n_groups"] == j_stats["n_groups"] == (1 if pack else 0)
    assert [g["members"] for g in p_stats["groups"]] == \
        [g["members"] for g in j_stats["groups"]]
    for name in p_stats["models"]:
        for k in ("packed", "group", "segment", "version", "updates",
                  "requests", "state_nbytes"):
            assert p_stats["models"][name][k] == j_stats["models"][name][k]


def test_fuse_and_segments_match_jax():
    """fuse_states and the group's segment assignment equal the JAX
    package's for members of different class counts."""
    from repro.serve import fuse_states as jfuse
    tas = [_ta(80, 3), _ta(81, 5), _ta(82, 2)]
    fused = fuse_states([TMState(ta=torch.from_numpy(t)) for t in tas])
    jfused = jfuse([JState(ta=jnp.asarray(t)) for t in tas])
    np.testing.assert_array_equal(fused.ta.numpy(), np.asarray(jfused.ta))
    cfgs = [TMConfig(n_classes=c, n_clauses=M, n_features=F)
            for c in (3, 5, 2)]
    jcfgs = [JConfig(n_classes=c, n_clauses=M, n_features=F)
             for c in (3, 5, 2)]
    from repro.serve import pack_key as jpack_key
    assert [pack_key(c) for c in cfgs] == [jpack_key(c) for c in jcfgs]
