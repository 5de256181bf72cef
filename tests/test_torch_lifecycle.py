"""Port parity: the ``repro_torch`` TMServer state lifecycle, mirroring
``tests/test_lifecycle``: kill/restart replays bit-exactly for every
ported train backend, restore adopts the snapshot's backend and is
validated, the history ring stays bounded while pinned predicts resolve,
rollback works from the ring and from disk, the drift probe, and
``stop()`` takes the final checkpoint and joins the writers.

Plus cross-restore: a snapshot the JAX ``TMServer`` writes resumes in the
port's, and the reverse, each continuing bit for bit as an uninterrupted
JAX run would.
"""

import asyncio
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMServer as JServer
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import _msgpack
from repro_torch.convert import state_from_numpy
from repro_torch.core import prng
from repro_torch.core.tm import TMConfig
from repro_torch.distributed import data_mesh
from repro_torch.engine import get_engine, get_train_engine
from repro_torch.serve import ServePolicy, TMServer

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

C, M, F = 3, 8, 9

# wall-clock bound on every event-loop run: a scheduler that loses a
# wakeup fails its test instead of hanging the whole run
LIMIT_S = 120


def _run(coro):
    """``asyncio.run(coro)`` under the ``LIMIT_S`` wall-clock limit."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _tm(seed=0):
    """A TM at the boundary states from a numpy seed → (cfg, numpy ta)."""
    rng = np.random.default_rng(seed)
    ta = rng.integers(128, 130, (C, M, 2 * F)).astype(np.int32)
    return TMConfig(n_classes=C, n_clauses=M, n_features=F, T=5, s=3.9), ta


def _state(ta):
    return state_from_numpy(ta, device="cpu")


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (n, 2 * F), dtype=np.int8),
            rng.integers(0, C, (n,), dtype=np.int32))


def _batches(n_batches, rows, seed):
    lits, labels = _stream(n_batches * rows, seed)
    return [(lits[i * rows:(i + 1) * rows], labels[i * rows:(i + 1) * rows])
            for i in range(n_batches)]


def _server(cfg, ta, policy, **kw):
    return TMServer(cfg, _state(ta), policy, device="cpu", **kw)


# -- kill/restart bit-exact continuation (the acceptance test) ---------


@pytest.mark.parametrize("backend", ["reference", "packed", "fused",
                                     "sparse"])
def test_kill_restart_replays_bit_exact(backend, tmp_path):
    """Restored-from-checkpoint continuation == uninterrupted run: same
    states, same versions, same predictions, for every train backend."""
    cfg, ta = _tm(seed=3)
    batches = _batches(6, 8, seed=4)
    probe = batches[0][0][:5]
    d = str(tmp_path / "ck")

    async def uninterrupted():
        preds = []
        async with _server(cfg, ta, ServePolicy(max_batch=8,
                                                backend="oracle"),
                           train_backend=backend, train_seed=11) as srv:
            for b in batches:
                await srv.submit_labeled(*b)
                preds.append((await srv.submit(probe)).prediction)
            return srv.state.ta.numpy(), srv.state_version, preds

    async def killed_and_restored():
        preds = []
        async with _server(cfg, ta, ServePolicy(max_batch=8,
                                                backend="oracle"),
                           train_backend=backend, train_seed=11,
                           checkpoint_dir=d,
                           checkpoint_every_updates=3) as srv:
            for b in batches[:3]:
                await srv.submit_labeled(*b)
                preds.append((await srv.submit(probe)).prediction)
        # fresh server, wrong train_seed on purpose: the restored cursor
        # (not the constructor seed) must drive the chain
        srv2 = _server(cfg, ta, ServePolicy(max_batch=8, backend="oracle"),
                       train_backend=backend, train_seed=999,
                       checkpoint_dir=d)
        assert srv2.restore() == 3
        assert srv2.stats()["checkpoint"]["restored_from"] == 3
        async with srv2:
            for b in batches[3:]:
                await srv2.submit_labeled(*b)
                preds.append((await srv2.submit(probe)).prediction)
            return srv2.state.ta.numpy(), srv2.state_version, preds

    ta_a, v_a, preds_a = _run(uninterrupted())
    ta_b, v_b, preds_b = _run(killed_and_restored())
    assert v_a == v_b == 6
    np.testing.assert_array_equal(ta_a, ta_b)
    for a, b in zip(preds_a, preds_b):
        np.testing.assert_array_equal(a, b)


def test_restore_adopts_checkpoint_backend_and_enables_training(tmp_path):
    """A checkpoint taken under one train backend restores onto a server
    built with none: the snapshot's backend and opts win, so the resumed
    run is the same run."""
    cfg, ta = _tm(seed=5)
    batches = _batches(4, 8, seed=6)
    d = str(tmp_path / "ck")

    async def phase1():
        async with _server(cfg, ta, ServePolicy(max_batch=8),
                           train_backend="packed", train_seed=7,
                           checkpoint_dir=d) as srv:
            for b in batches[:2]:
                await srv.submit_labeled(*b)
            # graceful stop checkpoints the final version automatically

    _run(phase1())
    assert ckpt.latest_step(d) == 2
    extra = ckpt.read_manifest_extra(d, 2)
    assert extra["train_backend"] == "packed" and extra["has_cursor"]
    assert extra["cfg"] == dataclasses.asdict(cfg)
    assert extra["train_opts"] == {"boost_tpf": True}
    assert extra["key_impl"] == "threefry2x32"

    async def phase2():
        srv = _server(cfg, ta, ServePolicy(max_batch=8),
                      checkpoint_dir=d)      # no train_backend at all
        assert srv.restore() == 2
        async with srv:
            for b in batches[2:]:
                await srv.submit_labeled(*b)  # training is now enabled
            return srv.state.ta.numpy(), srv.state_version

    ta_b, v_b = _run(phase2())
    assert v_b == 4

    # offline replay of the whole chain says the same thing
    eng = get_train_engine("packed", cfg)
    chain, s = prng.key(7), _state(ta)
    for lits, labels in batches:
        chain, k = prng.split(chain)
        s = eng.step(s, k, lits, labels)
    np.testing.assert_array_equal(ta_b, s.ta.numpy())


def test_restore_validation(tmp_path):
    cfg, ta = _tm()
    d = str(tmp_path / "ck")
    srv = _server(cfg, ta, ServePolicy(max_batch=4))
    with pytest.raises(ValueError, match="no checkpoint directory"):
        srv.checkpoint()
    with pytest.raises(ValueError, match="no checkpoint directory"):
        srv.restore()
    srv.checkpoint(d)
    other_cfg = TMConfig(n_classes=C, n_clauses=M, n_features=F + 1)
    other = TMServer(other_cfg, state_from_numpy(
        np.full((C, M, 2 * F + 2), 128, np.int32), device="cpu"),
        ServePolicy(max_batch=4), device="cpu")
    with pytest.raises(ValueError, match="was written for"):
        other.restore(d)
    # restore(mesh=, shardings=) is ported: the snapshot lands on the
    # simulated mesh's device, or as the tensors shardings= names
    cpu = torch.device("cpu")
    for kw in ({"mesh": data_mesh(2, devices=[cpu] * 2)},
               {"shardings": {"ta": None}}):
        assert srv.restore(d, **kw) == 0
        np.testing.assert_array_equal(srv.state.ta.numpy(), ta)

    async def mid_run():
        async with _server(cfg, ta, ServePolicy(max_batch=4)) as live:
            with pytest.raises(RuntimeError, match="before start"):
                live.restore(d)

    _run(mid_run())
    with pytest.raises(ValueError, match="checkpoint_every_updates"):
        _server(cfg, ta, None, checkpoint_every_updates=2)
    with pytest.raises(ValueError, match="probe_every_updates"):
        _server(cfg, ta, None, probe_every_updates=2)


# -- bounded version history + rollback --------------------------------


def test_history_ring_is_bounded_and_pinned_predicts_resolve():
    """The ring holds at most ``history_size`` pairs while a predict
    pinned to a version long since evicted from it still resolves
    against its arrival state."""
    cfg, ta = _tm(seed=7)
    lits, labels = _stream(64, 8)
    expected0 = get_engine("oracle", cfg, _state(ta)).infer(lits[:4])

    async def go():
        async with _server(cfg, ta,
                           ServePolicy(max_batch=64, max_wait_us=200_000,
                                       backend="oracle"),
                           train_backend="reference", history_size=3) as srv:
            await srv.warmup(train_batches=(8,))
            pinned = asyncio.ensure_future(srv.submit(lits[:4]))
            await asyncio.sleep(0)
            for i in range(8):
                await srv.submit_labeled(lits[8 * i:8 * i + 8],
                                         labels[8 * i:8 * i + 8])
            s = srv.stats()
            assert s["history"]["capacity"] == 3
            assert s["history"]["versions"] == [6, 7, 8]
            assert srv.history_versions == (6, 7, 8)
            return await pinned

    res = _run(go())
    np.testing.assert_array_equal(res.prediction,
                                  expected0.prediction.numpy())
    np.testing.assert_array_equal(res.class_sums,
                                  expected0.class_sums.numpy())


def test_rollback_from_ring_and_disk(tmp_path):
    cfg, ta = _tm(seed=9)
    lits, labels = _stream(80, 10)
    d = str(tmp_path / "ck")

    async def go():
        async with _server(cfg, ta, ServePolicy(max_batch=8,
                                                backend="oracle"),
                           train_backend="reference", history_size=3,
                           checkpoint_dir=d, checkpoint_every_updates=2,
                           checkpoint_keep=10) as srv:
            seen = {0: srv.state.ta.numpy().copy()}
            for i in range(6):
                v = await srv.submit_labeled(lits[8 * i:8 * i + 8],
                                             labels[8 * i:8 * i + 8])
                seen[v] = srv.state.ta.numpy().copy()
            assert srv.history_versions == (4, 5, 6)

            # ring rollback: version 5 is retained in memory
            assert srv.rollback(5) == 7
            np.testing.assert_array_equal(srv.state.ta.numpy(), seen[5])
            res = await srv.submit(lits[:4])
            ref = get_engine("oracle", cfg, _state(seen[5])).infer(lits[:4])
            np.testing.assert_array_equal(res.prediction,
                                          ref.prediction.numpy())

            # disk rollback: version 2 was checkpointed but left the
            # ring — wait for its writer, then roll back to it
            ckpt.wait_for_complete(d, 2, timeout=30)
            assert srv.rollback(2) == 8
            np.testing.assert_array_equal(srv.state.ta.numpy(), seen[2])
            res = await srv.submit(lits[:4])
            ref = get_engine("oracle", cfg, _state(seen[2])).infer(lits[:4])
            np.testing.assert_array_equal(res.class_sums,
                                          ref.class_sums.numpy())

            with pytest.raises(KeyError, match="neither the history ring"):
                srv.rollback(3)       # never checkpointed, left the ring
            assert srv.stats()["rollbacks"] == 2

    _run(go())


# -- drift monitoring --------------------------------------------------


def test_probe_drift_stats():
    """Every N applied updates the probe stream is scored; stats surface
    latest/best accuracy, drift (best − latest) and step deltas."""
    cfg, ta = _tm(seed=11)
    lits, labels = _stream(64, 12)
    probe = (lits[:16], labels[:16])

    async def go():
        async with _server(cfg, ta, ServePolicy(max_batch=8,
                                                backend="oracle"),
                           train_backend="packed", train_seed=13,
                           probe=probe, probe_every_updates=2) as srv:
            assert srv.stats()["probe"] == {
                "evals": 0, "accuracy": None, "best": None, "drift": 0.0,
                "delta": 0.0, "window_mean": 0.0, "at_version": None}
            for i in range(6):
                await srv.submit_labeled(lits[8 * i:8 * i + 8],
                                         labels[8 * i:8 * i + 8])
            # the update future resolves before its probe eval runs; a
            # flushing predict (FIFO behind it) orders the stats read
            await srv.submit(lits[:1])
            return srv.stats()["probe"], srv.state.ta.numpy()

    probe_stats, final = _run(go())
    assert probe_stats["evals"] == 3
    assert probe_stats["at_version"] == 6
    eng = get_engine("oracle", cfg, _state(final))
    acc_final = float((eng.infer(probe[0]).prediction.numpy()
                       == probe[1]).mean())
    assert probe_stats["accuracy"] == pytest.approx(acc_final)
    assert probe_stats["best"] >= probe_stats["accuracy"]
    assert probe_stats["drift"] == pytest.approx(
        probe_stats["best"] - probe_stats["accuracy"])
    assert 0.0 <= probe_stats["window_mean"] <= 1.0


def test_probe_validation():
    cfg, ta = _tm()
    lits, labels = _stream(8, 1)
    with pytest.raises(ValueError, match="probe labels"):
        _server(cfg, ta, None, probe=(lits, labels[:4]))
    with pytest.raises(ValueError, match="expected"):
        _server(cfg, ta, None, probe=(lits[:, :3], labels))


# -- graceful-stop checkpointing ---------------------------------------


def test_stop_takes_final_checkpoint_and_joins_writers(tmp_path):
    cfg, ta = _tm(seed=15)
    lits, labels = _stream(40, 16)
    d = str(tmp_path / "ck")

    async def go():
        async with _server(cfg, ta, ServePolicy(max_batch=8),
                           train_backend="reference",
                           checkpoint_dir=d,
                           checkpoint_every_updates=2) as srv:
            for i in range(5):
                await srv.submit_labeled(lits[8 * i:8 * i + 8],
                                         labels[8 * i:8 * i + 8])
            return srv

    srv = _run(go())
    # v5 wasn't on the every-2 cadence; stop() flushed it anyway, and
    # every writer thread was joined before stop returned
    assert ckpt.latest_step(d) == 5
    assert srv._ckpt_threads == []
    assert srv.stats()["checkpoint"]["pending"] == 0
    assert srv.stats()["checkpoint"]["last_step"] == 5
    extra = ckpt.read_manifest_extra(d, 5)
    assert extra["version"] == 5 and extra["updates"] == 5
    assert ckpt.valid_steps(d) == [2, 4, 5]         # checkpoint_keep=3
    with open(f"{d}/step_5/manifest.msgpack", "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    assert manifest["treedef"] == "PyTreeDef({'cursor': *, 'ta': *})"
    assert manifest["dtypes"] == ["uint32", "int32"]


# -- cross-restore between the two packages ----------------------------


def _jax_run(ta, batches, probe, *, directory=None, restore=False,
             every=0):
    """The JAX TMServer (CPU, ``fused``): optionally restore from
    ``directory`` first, learn ``batches`` with a probe predict after
    each → (published states, probe predictions, versions)."""
    jcfg = JConfig(n_classes=C, n_clauses=M, n_features=F, T=5, s=3.9)
    states, preds, versions = [], [], []

    async def go():
        srv = JServer(jcfg, JState(ta=jnp.asarray(ta)),
                      JPolicy(max_batch=8, backend="oracle"),
                      train_backend="fused", train_seed=21,
                      checkpoint_dir=directory,
                      checkpoint_every_updates=every)
        if restore:
            srv.restore()
        async with srv:
            for b in batches:
                versions.append(await srv.submit_labeled(*b))
                states.append(np.asarray(srv.state.ta))
                preds.append(np.asarray((await srv.submit(probe))
                                        .prediction))

    _run(go())
    return states, preds, versions


def _port_run(cfg, ta, batches, probe, *, directory, restore=False):
    states, preds, versions = [], [], []

    async def go():
        srv = _server(cfg, ta, ServePolicy(max_batch=8, backend="oracle"),
                      train_backend="fused", train_seed=21,
                      checkpoint_dir=directory)
        if restore:
            srv.restore()
        async with srv:
            for b in batches:
                versions.append(await srv.submit_labeled(*b))
                states.append(srv.state.ta.numpy().copy())
                preds.append((await srv.submit(probe)).prediction)

    _run(go())
    return states, preds, versions


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_restore_continues_bit_exact(tmp_path, direction):
    """A server of one package learns 3 batches and stops (its final
    snapshot); a server of the other restores that directory and learns
    3 more.  Every published state and every prediction equals an
    uninterrupted JAX run's, bitwise."""
    cfg, ta = _tm(seed=17)
    batches = _batches(6, 8, seed=18)
    probe = batches[0][0][:5]
    d = str(tmp_path / "ck")
    want = _jax_run(ta, batches, probe)
    if direction == "jax_to_torch":
        first = _jax_run(ta, batches[:3], probe, directory=d)
        assert jckpt.latest_step(d) == 3
        second = _port_run(cfg, ta, batches[3:], probe, directory=d,
                           restore=True)
    else:
        first = _port_run(cfg, ta, batches[:3], probe, directory=d)
        assert ckpt.latest_step(d) == 3
        second = _jax_run(ta, batches[3:], probe, directory=d, restore=True)
    got = [a + b for a, b in zip(first, second)]
    assert got[2] == want[2] == [1, 2, 3, 4, 5, 6]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    extra = jckpt.read_manifest_extra(d, 3)
    assert extra == ckpt.read_manifest_extra(d, 3)
    assert extra["train_backend"] == "fused" and extra["has_cursor"]
