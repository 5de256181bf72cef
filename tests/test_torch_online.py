"""Port parity: the ``repro_torch`` TMServer learning plane against the JAX
TMServer and the offline replay, mirroring ``tests/test_online_learning``:
opt-in and validation, the update chain replaying bit for bit through
every ported train backend, predicts pinned to their arrival version, no
torn state, a failing update failing only itself, the drift probe, and
the launcher's learning flags.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMServer as JServer
from repro_torch.convert import state_from_numpy
from repro_torch.core import prng
from repro_torch.core.tm import TMConfig
from repro_torch.engine import get_engine, get_train_engine
from repro_torch.serve import ServePolicy, TMServer

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

C, M, F = 3, 8, 9

# wall-clock bound on every event-loop run: a scheduler that loses a
# wakeup fails its test instead of hanging the whole run; leaving the
# ``async with`` block on the timeout stops the server
LIMIT_S = 120


def _run(coro):
    """``asyncio.run(coro)`` under the ``LIMIT_S`` wall-clock limit."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _tm(seed=0):
    """A TM at the boundary states, from a numpy seed (both packages)."""
    rng = np.random.default_rng(seed)
    ta = rng.integers(128, 130, (C, M, 2 * F)).astype(np.int32)
    return TMConfig(C, M, F, T=5, s=3.9), ta


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (n, 2 * F), dtype=np.int8),
            rng.integers(0, C, (n,), dtype=np.int32))


def _expected_chain(cfg, ta, batches, *, backend, seed):
    """Offline replay on the CPU: split-advance the key chain and apply
    the engine per labeled batch → [state_0, state_1, ...] as numpy."""
    eng = get_train_engine(backend, cfg)
    chain = prng.key(seed)
    state = state_from_numpy(ta, device="cpu")
    states = [state]
    for lits, labels in batches:
        chain, k = prng.split(chain)
        state = eng.step(state, k, lits, labels)
        states.append(state)
    return states


def test_submit_labeled_requires_opt_in():
    cfg, ta = _tm()
    lits, labels = _stream(4, 1)

    async def go():
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=4, backend="oracle"),
                            device="cpu") as srv:
            with pytest.raises(RuntimeError, match="online learning is off"):
                await srv.submit_labeled(lits, labels)
            with pytest.raises(AttributeError):
                srv.state = srv.state
            assert srv.stats()["updates"] == 0

    _run(go())


def test_submit_labeled_validation():
    cfg, ta = _tm()
    lits, labels = _stream(4, 2)
    with pytest.raises(KeyError, match="unknown TrainEngine backend"):
        TMServer(cfg, state_from_numpy(ta, device="cpu"), device="cpu",
                 train_backend="sgd")
    with pytest.raises(ValueError, match="probe_every_updates"):
        TMServer(cfg, state_from_numpy(ta, device="cpu"), device="cpu",
                 train_backend="reference", probe_every_updates=2)
    with pytest.raises(ValueError, match="probe labels"):
        TMServer(cfg, state_from_numpy(ta, device="cpu"), device="cpu",
                 probe=(lits, labels[:2]))

    async def go():
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=4), device="cpu",
                            train_backend="reference") as srv:
            with pytest.raises(ValueError, match="labels"):
                await srv.submit_labeled(lits, labels[:2])
            with pytest.raises(ValueError, match="out of range"):
                await srv.submit_labeled(lits, labels + 10)
            with pytest.raises(ValueError, match="expected"):
                await srv.submit_labeled(lits[:, :4], labels)
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            device="cpu") as srv:
            with pytest.raises(RuntimeError, match="train_backend"):
                await srv.warmup(train_batches=(4,))

    _run(go())


@pytest.mark.parametrize("backend", ["reference", "packed", "fused"])
def test_update_chain_replays_bit_exactly(backend):
    """Applied updates advance the version by one each and publish the
    states of the offline replay — which equal the JAX TMServer's states
    for the same seed and batches."""
    cfg, ta = _tm(seed=3)
    lits, labels = _stream(48, 4)
    batches = [(lits[i:i + 16], labels[i:i + 16]) for i in (0, 16, 32)]
    expected = _expected_chain(cfg, ta, batches, backend=backend, seed=11)

    async def port():
        versions, states = [], []
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=8), device="cpu",
                            train_backend=backend, train_seed=11) as srv:
            await srv.warmup(train_batches=(16,))
            assert srv.state_version == 0       # warmup leaves state alone
            np.testing.assert_array_equal(srv.state.ta.numpy(), ta)
            for b in batches:
                versions.append(await srv.submit_labeled(*b))
                states.append(srv.state.ta.numpy())
            return versions, states, srv.stats()

    async def reference():
        states = []
        async with JServer(JConfig(C, M, F, T=5, s=3.9),
                           JState(jnp.asarray(ta)), JPolicy(max_batch=8),
                           train_backend=backend, train_seed=11) as srv:
            for b in batches:
                await srv.submit_labeled(*b)
                states.append(np.asarray(srv.state.ta))
        return states

    versions, states, stats = _run(port())
    assert versions == [1, 2, 3]
    assert stats["state_version"] == 3 and stats["updates"] == 3
    assert stats["update_rows"] == 48
    assert stats["pipeline"]["update_inflight"] is False
    jstates = _run(reference())
    for got, want, jax_state in zip(states, expected[1:], jstates):
        np.testing.assert_array_equal(got, want.ta.numpy())
        np.testing.assert_array_equal(got, jax_state)
    assert not np.array_equal(states[-1], ta)


def test_predict_pinned_to_arrival_version():
    cfg, ta = _tm(seed=5)
    lits, labels = _stream(16, 6)
    expected = _expected_chain(cfg, ta, [(lits, labels)],
                               backend="reference", seed=0)

    async def go():
        # the predict's batch stays open while the update queued behind it
        # is pending: the version cut must close the batch
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=64, max_wait_us=50_000,
                                        backend="oracle"),
                            device="cpu", train_backend="reference") as srv:
            await srv.warmup(train_batches=(16,))
            p_before = asyncio.ensure_future(srv.submit(lits[:4]))
            v = await srv.submit_labeled(lits, labels)
            p_after = await srv.submit(lits[:4])
            return await p_before, p_after, v

    res_before, res_after, version = _run(go())
    assert version == 1
    for res, st in ((res_before, expected[0]), (res_after, expected[1])):
        ref = get_engine("oracle", cfg, st).infer(lits[:4])
        np.testing.assert_array_equal(res.prediction, ref.prediction)
        np.testing.assert_array_equal(res.class_sums, ref.class_sums)


@pytest.mark.parametrize("case", [(1, 4, 2, 0, 3, 2), (3, 12, 4, 2000, 17, 2),
                                  (4, 8, 16, 0, 99, 2), (3, 9, 4, 500, 5, 1),
                                  (3, 2, 8, 200, 5, 1), (3, 4, 8, 200, 30225, 1)],
                         ids=lambda c: "u{}p{}b{}w{}s{}d{}".format(*c))
def test_interleaved_predicts_never_see_torn_state(case):
    """Every predict response equals a committed version's full oracle
    result — prediction and class sums together — never a mixture; the
    last three cases run the serial scheduler (``pipeline_depth=1``).
    In the last two, the updates queued behind the predicts outlast
    them: the scheduler must apply each queued update without waiting
    for another arrival (it used to go idle with updates pending, and
    the run hung)."""
    n_updates, n_predicts, max_batch, max_wait_us, seed, depth = case
    cfg, ta = _tm(seed=7)
    lits, labels = _stream(64, seed)
    batches = [(lits[8 * i:8 * i + 8], labels[8 * i:8 * i + 8])
               for i in range(n_updates)]
    expected = _expected_chain(cfg, ta, batches, backend="packed", seed=seed)
    rng = np.random.default_rng(seed + 1)
    queries = [lits[rng.integers(0, 64, rng.integers(1, 4))]
               for _ in range(n_predicts)]

    async def go():
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=max_batch,
                                        max_wait_us=max_wait_us,
                                        backend="oracle",
                                        pipeline_depth=depth),
                            device="cpu", train_backend="packed",
                            train_seed=seed) as srv:
            await srv.warmup(train_batches=(8,))
            tasks = [srv.submit(q) for q in queries] + \
                    [srv.submit_labeled(*b) for b in batches]
            return await asyncio.gather(*tasks)

    results = _run(go())
    assert sorted(results[n_predicts:]) == list(range(1, n_updates + 1))
    refs = [get_engine("oracle", cfg, st) for st in expected]
    for q, res in zip(queries, results[:n_predicts]):
        assert any(
            np.array_equal(res.prediction, r.prediction.numpy())
            and np.array_equal(res.class_sums, r.class_sums.numpy())
            for r in (e.infer(q) for e in refs)), \
            "response matches no committed state version"


def test_failing_update_fails_only_itself():
    """An update error must not kill the scheduler, corrupt the served
    state or version, or consume a key from the replay chain."""
    cfg, ta = _tm(seed=9)
    lits, labels = _stream(8, 10)
    inner = get_train_engine("reference", cfg)

    class FlakyOnce:
        name = "flaky"

        def __init__(self):
            self.cfg = cfg
            self.calls = 0

        def step(self, state, key, x, y):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            return inner.step(state, key, x, y)

    async def go():
        srv = TMServer(cfg, state_from_numpy(ta, device="cpu"),
                       ServePolicy(max_batch=8, backend="oracle"),
                       device="cpu", train_backend="reference",
                       train_seed=42)
        srv._train_engine = FlakyOnce()
        async with srv:
            with pytest.raises(RuntimeError, match="boom"):
                await srv.submit_labeled(lits, labels)
            res = await srv.submit(lits[:3])
            mid = srv.stats()
            v = await srv.submit_labeled(lits, labels)
            after = srv.state
        return res, mid, v, after

    res, mid, v, after = _run(go())
    assert mid["state_version"] == 0 and mid["updates"] == 0
    assert mid["errors"] == 1
    ref = get_engine("oracle", cfg, state_from_numpy(ta, device="cpu")) \
        .infer(lits[:3])
    np.testing.assert_array_equal(res.prediction, ref.prediction)
    assert v == 1
    expected = _expected_chain(cfg, ta, [(lits, labels)],
                               backend="reference", seed=42)
    np.testing.assert_array_equal(after.ta.numpy(), expected[1].ta.numpy())


def test_rollback_keeps_the_key_chain_advancing():
    """Rollback republishes an old state; the next update applies to it
    with the chain's next key, as in the JAX package."""
    cfg, ta = _tm(seed=12)
    lits, labels = _stream(24, 13)
    b = [(lits[:8], labels[:8]), (lits[8:16], labels[8:16]),
         (lits[16:], labels[16:])]

    async def go():
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=8), device="cpu",
                            train_backend="fused", train_seed=5) as srv:
            await srv.submit_labeled(*b[0])
            await srv.submit_labeled(*b[1])
            assert srv.rollback(1) == 3
            assert await srv.submit_labeled(*b[2]) == 4
            return srv.state.ta.numpy(), srv.stats()

    got, stats = _run(go())
    eng = get_train_engine("fused", cfg)
    chain = prng.key(5)
    st = state_from_numpy(ta, device="cpu")
    keys = []
    for _ in range(3):
        chain, k = prng.split(chain)
        keys.append(k)
    v1 = eng.step(st, keys[0], *b[0])
    want = eng.step(v1, keys[2], *b[2])
    np.testing.assert_array_equal(got, want.ta.numpy())
    assert stats["rollbacks"] == 1 and stats["updates"] == 3


def test_drift_probe_scores_held_out_stream():
    cfg, ta = _tm(seed=14)
    lits, labels = _stream(32, 15)
    probe = _stream(11, 16)
    batches = [(lits[i:i + 8], labels[i:i + 8]) for i in range(0, 32, 8)]
    expected = _expected_chain(cfg, ta, batches, backend="packed", seed=3)

    async def go():
        async with TMServer(cfg, state_from_numpy(ta, device="cpu"),
                            ServePolicy(max_batch=8, backend="oracle"),
                            device="cpu", train_backend="packed",
                            train_seed=3, probe=probe,
                            probe_every_updates=2, probe_window=4) as srv:
            await srv.warmup(train_batches=(8,))
            assert srv.stats()["probe"]["accuracy"] is None
            for bt in batches:
                await srv.submit_labeled(*bt)
            for _ in range(50):             # the probe runs after publish
                if srv.stats()["probe"]["evals"] == 2:
                    break
                await asyncio.sleep(0.01)
            return srv.stats()["probe"]

    p = _run(go())
    accs = [float((get_engine("oracle", cfg, expected[v]).infer(probe[0])
                   .prediction.numpy() == probe[1]).mean()) for v in (2, 4)]
    assert p["evals"] == 2 and p["at_version"] == 4
    assert p["accuracy"] == accs[1] and p["best"] == max(accs)
    assert p["drift"] == round(max(accs) - accs[1], 6)
    assert p["delta"] == round(accs[1] - accs[0], 6)
    assert p["window_mean"] == round(float(np.mean(accs)), 6)


def test_launcher_learning_flags_on_cpu(capsys):
    from repro_torch.launch.tm_serve import main
    main(["--device", "cpu", "--backend", "mxu_fused", "--classes", "3",
          "--clauses", "4", "--features", "6", "--clients", "2",
          "--duration", "0.6", "--stats-every", "0.2",
          "--train-backend", "fused", "--label-rate", "40",
          "--label-batch", "8", "--history-size", "4", "--probe-every", "1",
          "--probe-size", "16"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "closed-loop x2" in out
    assert "state_version=" in out and "labeled rows" in out
    assert "drift probe: acc=" in out
