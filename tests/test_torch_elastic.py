"""Port parity: elastic re-shard restore, mirroring
``tests/test_elastic_restore``.  Checkpoints are mesh-agnostic, bit for
bit.

A port server training with the ``sharded`` backend on a mesh of A
shards is killed mid-learning; a fresh server restores the snapshot onto
a mesh of B shards (B = 1 included) and resumes.  For every (A, B) ∈
{1, 4} × {1, 2, 8} the resumed run equals an uninterrupted
single-device ``fused`` run fed the same labeled stream: states,
versions, predictions and the key-chain cursor.  The meshes are
simulated CPU meshes.  Also the clamp of an oversized recorded mesh, and
the two packages restoring each other's sharded snapshots onto another
mesh size.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.engine.train import export_key_cursor as jexport_key_cursor
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMServer as JServer
from repro_torch import checkpoint as ckpt
from repro_torch.convert import state_from_numpy
from repro_torch.core.tm import TMConfig
from repro_torch.distributed import data_mesh, sharding
from repro_torch.engine import clear_train_engine_cache, export_key_cursor
from repro_torch.serve import ServePolicy, TMServer

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

C, M, F = 3, 8, 9
MESH_A = (1, 4)
MESH_B = (1, 2, 8)
N_BATCHES, ROWS, KILL_AFTER = 6, 8, 3
CPU = torch.device("cpu")

# wall-clock bound on every event-loop run: a scheduler that loses a
# wakeup fails its test instead of hanging the whole run
LIMIT_S = 120


def _run(coro):
    """``asyncio.run(coro)`` under the ``LIMIT_S`` wall-clock limit."""
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _mesh(n):
    return data_mesh(n, devices=[CPU] * 8)


def _ta(seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(128, 130, (C, M, 2 * F)).astype(np.int32)


def _cfg():
    return TMConfig(n_classes=C, n_clauses=M, n_features=F, T=5, s=3.9)


def _batches(seed=4):
    rng = np.random.default_rng(seed)
    lits = rng.integers(0, 2, (N_BATCHES * ROWS, 2 * F), dtype=np.int8)
    labels = rng.integers(0, C, (N_BATCHES * ROWS,), dtype=np.int32)
    return [(lits[i * ROWS:(i + 1) * ROWS], labels[i * ROWS:(i + 1) * ROWS])
            for i in range(N_BATCHES)]


def _policy():
    return ServePolicy(max_batch=8, backend="oracle")


def _server(**kw):
    return TMServer(_cfg(), state_from_numpy(_ta(), device="cpu"),
                    _policy(), **kw)


async def _feed(srv, batches, probe):
    """Apply ``batches`` one by one, probing after each → predictions."""
    preds = []
    for b in batches:
        await srv.submit_labeled(*b)
        preds.append(np.asarray((await srv.submit(probe)).prediction))
    return preds


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted ground truth: a single-device ``fused`` server
    fed all six batches → (final ta, version, per-update predictions,
    cursor at the kill point, final cursor)."""
    batches = _batches()
    probe = batches[0][0][:5]

    async def run():
        async with _server(device="cpu", train_backend="fused",
                           train_seed=11) as srv:
            preds = await _feed(srv, batches[:KILL_AFTER], probe)
            cursor_mid = export_key_cursor(srv._train_key)[0]
            preds += await _feed(srv, batches[KILL_AFTER:], probe)
            return (srv.state.ta.numpy(), srv.state_version, preds,
                    cursor_mid, export_key_cursor(srv._train_key)[0])

    return _run(run())


@pytest.fixture(scope="module")
def killed_on_mesh(tmp_path_factory):
    """One checkpoint directory per mesh-A size: a ``sharded`` mesh-A
    server runs the first three batches (a snapshot every third update)
    and is killed → {A: (dir, preds, cursor_at_kill)}."""
    out = {}
    batches = _batches()
    probe = batches[0][0][:5]
    for a in MESH_A:
        d = str(tmp_path_factory.mktemp(f"mesh_a{a}") / "ck")

        async def run():
            async with _server(train_backend="sharded", train_seed=11,
                               mesh=_mesh(a), checkpoint_dir=d,
                               checkpoint_every_updates=KILL_AFTER) as srv:
                assert srv._train_engine.n_devices == a
                preds = await _feed(srv, batches[:KILL_AFTER], probe)
                return preds, export_key_cursor(srv._train_key)[0]

        preds, cursor = _run(run())
        out[a] = (d, preds, cursor)
    return out


def test_pre_kill_runs_match_reference(reference, killed_on_mesh):
    """Before the kill, every mesh-A run already tracks the fused
    reference bitwise — predictions and key-chain cursor — and its
    snapshot records the mesh size."""
    _, _, ref_preds, ref_cursor_mid, _ = reference
    for a, (d, preds, cursor) in killed_on_mesh.items():
        for p_ref, p in zip(ref_preds[:KILL_AFTER], preds):
            np.testing.assert_array_equal(p_ref, p, err_msg=f"A={a}")
        np.testing.assert_array_equal(ref_cursor_mid, cursor,
                                      err_msg=f"A={a}")
        assert ckpt.latest_step(d) == KILL_AFTER
        extra = ckpt.read_manifest_extra(d, KILL_AFTER)
        assert extra["train_backend"] == "sharded"
        assert extra["mesh_devices"] == a
        assert extra["train_opts"]["n_devices"] == a


def _assert_resumed(reference, ta, version, preds, cursor):
    ref_ta, ref_version, ref_preds, _, ref_cursor_end = reference
    assert version == ref_version
    np.testing.assert_array_equal(ta, ref_ta)
    for p_ref, p in zip(ref_preds[KILL_AFTER:], preds):
        np.testing.assert_array_equal(p_ref, p)
    np.testing.assert_array_equal(cursor, ref_cursor_end)


@pytest.mark.parametrize("b", MESH_B)
@pytest.mark.parametrize("a", MESH_A)
def test_elastic_restore_grid(a, b, reference, killed_on_mesh):
    """Kill on mesh A, restore on mesh B, resume: the full run equals the
    uninterrupted reference.  train_seed is wrong on purpose: the
    restored cursor, not the constructor seed, must drive the chain."""
    d, _, _ = killed_on_mesh[a]
    batches = _batches()
    probe = batches[0][0][:5]

    async def resume():
        srv = _server(train_backend="sharded", train_seed=999,
                      mesh=_mesh(a))
        assert srv.restore(d, mesh=_mesh(b)) == KILL_AFTER
        assert srv._train_engine.n_devices == b
        assert srv.stats()["mesh"] == {"devices": b, "axis": "data"}
        async with srv:
            preds = await _feed(srv, batches[KILL_AFTER:], probe)
            return (srv.state.ta.numpy(), srv.state_version, preds,
                    export_key_cursor(srv._train_key)[0])

    _assert_resumed(reference, *_run(resume()))


def test_restore_clamps_oversized_recorded_mesh(reference, killed_on_mesh,
                                                monkeypatch):
    """A snapshot recording more devices than this host has clamps to
    the visible count (no mesh= override) instead of failing: simulated
    by showing the restoring server two devices while it restores the
    4-shard snapshot, then resuming bitwise."""
    d, _, _ = killed_on_mesh[4]
    batches = _batches()
    probe = batches[0][0][:5]
    monkeypatch.setattr(sharding, "visible_devices", lambda: [CPU] * 2)
    try:
        srv = _server(device="cpu", train_backend="sharded")
        assert srv._train_engine.n_devices == 2
        assert srv.restore(d) == KILL_AFTER
        assert srv._train_engine.n_devices == 2
        assert srv.stats()["mesh"] is None

        async def resume():
            async with srv:
                preds = await _feed(srv, batches[KILL_AFTER:], probe)
                return (srv.state.ta.numpy(), srv.state_version, preds,
                        export_key_cursor(srv._train_key)[0])

        _assert_resumed(reference, *_run(resume()))
    finally:
        # the cached engines hold the patched two-device mesh
        clear_train_engine_cache()


# -- across the two packages ------------------------------------------


def _jserver(**kw):
    cfg = _cfg()
    jcfg = JConfig(n_classes=cfg.n_classes, n_clauses=cfg.n_clauses,
                   n_features=cfg.n_features, T=cfg.T, s=cfg.s)
    return JServer(jcfg, JState(ta=jnp.asarray(_ta())),
                   JPolicy(max_batch=8, backend="oracle"), **kw)


def test_jax_sharded_snapshot_resumes_in_port(reference, tmp_path):
    """A JAX ``sharded`` server on its simulated 4-device mesh writes the
    snapshot; the port restores it onto a 2-shard mesh and resumes
    bitwise."""
    assert len(jax.devices()) >= 8, "conftest must simulate 8 devices"
    d = str(tmp_path / "ck")
    batches = _batches()
    probe = batches[0][0][:5]

    async def jax_run():
        async with _jserver(train_backend="sharded", train_seed=11, mesh=4,
                            checkpoint_dir=d,
                            checkpoint_every_updates=KILL_AFTER) as srv:
            await _feed(srv, batches[:KILL_AFTER], probe)
            return np.asarray(jexport_key_cursor(srv._train_key)[0])

    np.testing.assert_array_equal(_run(jax_run()), reference[3])
    assert ckpt.read_manifest_extra(d, KILL_AFTER)["mesh_devices"] == 4

    async def resume():
        srv = _server(device="cpu", train_backend="fused", train_seed=999)
        assert srv.restore(d, mesh=_mesh(2)) == KILL_AFTER
        assert srv._train_engine.n_devices == 2
        async with srv:
            preds = await _feed(srv, batches[KILL_AFTER:], probe)
            return (srv.state.ta.numpy(), srv.state_version, preds,
                    export_key_cursor(srv._train_key)[0])

    _assert_resumed(reference, *_run(resume()))


def test_port_sharded_snapshot_resumes_in_jax(reference, killed_on_mesh):
    """The port's 4-shard snapshot restores into the JAX ``TMServer`` on
    a 2-device mesh and resumes bitwise."""
    d, _, _ = killed_on_mesh[4]
    batches = _batches()
    probe = batches[0][0][:5]

    async def resume():
        srv = _jserver(train_backend="fused", train_seed=999)
        assert srv.restore(d, mesh=2) == KILL_AFTER
        assert srv._train_engine.n_devices == 2
        async with srv:
            preds = await _feed(srv, batches[KILL_AFTER:], probe)
            return (np.asarray(srv.state.ta), srv.state_version, preds,
                    np.asarray(jexport_key_cursor(srv._train_key)[0]))

    _assert_resumed(reference, *_run(resume()))


def test_launcher_mesh_flag_on_cpu(tmp_path, capsys, monkeypatch):
    """``--mesh N`` on the CPU: N simulated shards serve and, with
    ``--train-backend sharded``, train; a relaunch with ``--restore``
    resumes onto another mesh size; a negative size is refused."""
    from repro_torch.launch.tm_serve import main
    real_run = asyncio.run
    monkeypatch.setattr(asyncio, "run",
                        lambda coro: real_run(asyncio.wait_for(coro,
                                                               LIMIT_S)))
    d = str(tmp_path / "ck")
    common = ["--device", "cpu", "--classes", "3", "--clauses", "4",
              "--features", "6", "--clients", "2", "--duration", "0.6",
              "--stats-every", "0.2", "--checkpoint-dir", d]
    main(common + ["--mesh", "4", "--train-backend", "sharded",
                   "--label-rate", "40", "--label-batch", "8",
                   "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "mesh={'devices': 4, 'axis': 'data'}" in out
    assert "state_version=" in out and "labeled rows" in out
    step = ckpt.latest_step(d)
    extra = ckpt.read_manifest_extra(d, step)
    assert step > 0 and extra["mesh_devices"] == 4
    assert extra["train_opts"]["n_devices"] == 4
    main(common + ["--mesh", "2", "--restore"])
    out = capsys.readouterr().out
    assert f"at state version {step}" in out
    assert "mesh={'devices': 2, 'axis': 'data'}" in out
    with pytest.raises(SystemExit, match="--mesh"):
        main(common + ["--mesh", "-1"])
