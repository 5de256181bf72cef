"""Port parity: the ``repro_torch`` TMServer predict plane against the JAX
TMServer, plus the serving contract the JAX suites pin down
(``tests/test_tm_server.py``, ``tests/test_pipeline.py``): exactly once,
in order per client, bit-exact, degenerate batch policies, EDF order and
both halves of admission control.  Also the two guards of the port: it
imports neither JAX nor ``repro``, and asking for cuda without a GPU
raises instead of running on the CPU.
"""

import asyncio
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.serve import ServePolicy as JPolicy
from repro.serve import TMServer as JServer
from repro_torch.convert import state_from_numpy
from repro_torch.core.tm import TMConfig
from repro_torch.engine import get_engine
from repro_torch.serve import (DeadlineExceeded, ServePolicy, TMServer,
                               bucket_for, default_buckets, route_buckets)
from repro_torch.serve.tm_server import _Request

C, M, F = 3, 7, 9
N_CLIENTS = 3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _ta(seed=0, density=0.2):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((C, M, 2 * F)) < density, 129, 128) \
        .astype(np.int32)


def _tm(seed=0, density=0.2):
    return TMConfig(C, M, F), state_from_numpy(_ta(seed, density),
                                               device="cpu")


def _requests(sizes, seed):
    """Round-robin over N_CLIENTS → [(client, seq_within_client, lits)]."""
    rng = np.random.default_rng(seed)
    reqs, seqs = [], [0] * N_CLIENTS
    for i, n in enumerate(sizes):
        client = i % N_CLIENTS
        reqs.append((client, seqs[client],
                     rng.integers(0, 2, (n, 2 * F), dtype=np.int8)))
        seqs[client] += 1
    return reqs


def _serve_all(server_factory, reqs):
    """Submit every request concurrently → (results, completions, stats)."""
    completions = []

    async def go():
        async with server_factory() as server:
            async def one(client, seq, lits):
                res = await server.submit(lits, client=client)
                completions.append((client, seq))
                return res
            results = await asyncio.gather(
                *[one(c, s, lit) for c, s, lit in reqs])
            return results, server.stats()

    results, stats = asyncio.run(go())
    return results, completions, stats


def _check_contract(cfg, state, reqs, results, completions):
    oracle = get_engine("oracle", cfg, state)
    assert len(results) == len(reqs)
    assert len(completions) == len(set(completions)) == len(reqs)
    for client in range(N_CLIENTS):
        seqs = [s for c, s in completions if c == client]
        assert seqs == sorted(seqs), f"client {client} reordered: {seqs}"
    for (_, _, lits), res in zip(reqs, results):
        ref = oracle.infer(lits)
        assert res.prediction.shape == (len(lits),)
        np.testing.assert_array_equal(res.prediction, ref.prediction.numpy())
        np.testing.assert_array_equal(res.class_sums, ref.class_sums.numpy())


@pytest.mark.parametrize("backend", ["oracle", "swar_fused", "mxu_fused"])
def test_trace_matches_jax_server(backend):
    """One mixed-size trace through both servers with the same pinned
    backend: identical per-response predictions and class sums."""
    ta = _ta(seed=21, density=0.15)
    sizes = [1, 3, 2, 5, 1, 1, 4, 2, 7, 1, 3]
    reqs = _requests(sizes, seed=22)
    kw = dict(max_batch=8, max_wait_us=500, backend=backend)
    jcfg = JConfig(n_classes=C, n_clauses=M, n_features=F)
    jres, _, _ = _serve_all(
        lambda: JServer(jcfg, JState(ta=jnp.asarray(ta)), JPolicy(**kw)),
        reqs)
    cfg = TMConfig(C, M, F)
    state = state_from_numpy(ta, device="cpu")
    tres, completions, stats = _serve_all(
        lambda: TMServer(cfg, state, ServePolicy(**kw), device="cpu"), reqs)
    for want, got in zip(jres, tres):
        np.testing.assert_array_equal(got.prediction,
                                      np.asarray(want.prediction))
        np.testing.assert_array_equal(got.class_sums,
                                      np.asarray(want.class_sums))
    _check_contract(cfg, state, reqs, tres, completions)
    assert stats["rows"] == sum(sizes) and stats["errors"] == 0
    assert stats["device"] == "cpu"


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_contract_across_pipeline_depths(seed, depth):
    cfg, state = _tm(seed=5)
    rng = np.random.default_rng(100 + seed)
    sizes = rng.integers(1, 6, 14).tolist()
    reqs = _requests(sizes, seed)
    policy = ServePolicy(max_batch=int(rng.choice([2, 4, 16])),
                         max_wait_us=int(rng.choice([0, 500])),
                         backend="swar_packed", pipeline_depth=depth)
    results, completions, stats = _serve_all(
        lambda: TMServer(cfg, state, policy, device="cpu"), reqs)
    _check_contract(cfg, state, reqs, results, completions)
    assert stats["requests"] == len(reqs)
    assert stats["pipeline"] == {"depth": depth, "inflight": 0,
                                 "inflight_versions": {},
                                 "update_inflight": False}


def test_max_batch_one_degenerates_to_sequential():
    cfg, state = _tm(seed=1)
    reqs = _requests([1, 2, 1, 3, 1, 1, 2], seed=2)
    results, completions, stats = _serve_all(
        lambda: TMServer(cfg, state, ServePolicy(max_batch=1,
                                                 backend="oracle"),
                         device="cpu"), reqs)
    _check_contract(cfg, state, reqs, results, completions)
    assert stats["batches"] >= len(reqs)


def test_single_bucket_and_oversized_requests():
    cfg, state = _tm(seed=3)
    sizes = [1, 3, 8, 2, 10, 1]          # 10 > the only bucket (8)
    reqs = _requests(sizes, seed=4)
    policy = ServePolicy(max_batch=16, max_wait_us=500, buckets=(8,),
                         backend="mxu_fused")
    results, completions, stats = _serve_all(
        lambda: TMServer(cfg, state, policy, device="cpu"), reqs)
    _check_contract(cfg, state, reqs, results, completions)
    assert stats["rows"] == sum(sizes)


def test_bucket_for_and_default_buckets():
    assert bucket_for(3, (1, 4, 16)) == 4
    assert bucket_for(17, (1, 4, 16)) == 32
    assert bucket_for(33, (1, 4, 16)) == 48
    assert default_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
    assert default_buckets(48) == (1, 2, 4, 8, 16, 32, 48)
    assert default_buckets(1) == (1,)


def test_routing_explicit_and_heuristic_fails_loudly():
    """Explicit routes win; the density heuristic still names sparse_csr
    at <=10% density, and — sparse_csr not being ported — the batch fails
    with the registry's error instead of being re-routed."""
    cfg, sparse = _tm(seed=6, density=0.05)
    assert route_buckets(cfg, sparse, (1, 8), backend="mxu_fused") == \
        {1: "mxu_fused", 8: "mxu_fused"}
    assert set(route_buckets(cfg, sparse, (1, 8)).values()) == {"sparse_csr"}
    _, dense = _tm(seed=6, density=0.5)
    assert set(route_buckets(cfg, dense, (1, 8)).values()) == {"swar_packed"}

    async def go():
        async with TMServer(cfg, sparse, ServePolicy(max_batch=4),
                            device="cpu") as srv:
            with pytest.raises(KeyError, match="unknown VoteEngine backend "
                                               "'sparse_csr'"):
                await srv.submit(np.zeros((1, 2 * F), np.int8))
            assert srv.stats()["errors"] == 1

    asyncio.run(go())


def test_failing_batch_fails_only_its_requests():
    cfg, state = _tm(seed=12)
    policy = ServePolicy(max_batch=4, max_wait_us=0, buckets=(1, 4))

    async def go():
        async with TMServer(cfg, state, policy, device="cpu",
                            routing={1: "bogus", 4: "oracle"}) as srv:
            with pytest.raises(KeyError, match="unknown VoteEngine"):
                await srv.submit(np.zeros((1, 2 * F), np.int8))
            res = await srv.submit(np.zeros((4, 2 * F), np.int8))
            assert res.prediction.shape == (4,)
            assert srv.stats()["errors"] == 1

    asyncio.run(go())


def test_submit_validation_and_lifecycle():
    cfg, state = _tm(seed=7)

    async def go():
        server = TMServer(cfg, state, ServePolicy(max_batch=4,
                                                  backend="oracle"),
                          device="cpu")
        with pytest.raises(RuntimeError, match="already started"):
            async with server:
                await server.start()
        with pytest.raises(RuntimeError, match="stopped"):
            await server.submit(np.zeros(2 * F, np.int8))
        await server.stop()
        async with TMServer(cfg, state, ServePolicy(max_batch=4,
                                                    backend="oracle"),
                            device="cpu") as srv:
            with pytest.raises(ValueError, match="expected"):
                await srv.submit(np.zeros((2, 5), np.int8))
            with pytest.raises(ValueError, match="deadline_us"):
                await srv.submit(np.zeros(2 * F, np.int8), deadline_us=0)
            res = await srv.submit(torch.zeros(2 * F, dtype=torch.int8))
            assert res.prediction.shape == (1,)

    asyncio.run(go())


def test_warmup_and_stats_key_set_matches_jax():
    ta = _ta(seed=9)
    cfg = TMConfig(C, M, F)
    jcfg = JConfig(n_classes=C, n_clauses=M, n_features=F)

    async def stats_of(server):
        async with server as srv:
            await srv.warmup()
            await srv.submit(np.zeros((3, 2 * F), np.int8))
            return srv.stats()

    got = asyncio.run(stats_of(TMServer(
        cfg, state_from_numpy(ta, device="cpu"),
        ServePolicy(max_batch=8, backend="oracle"), device="cpu")))
    want = asyncio.run(stats_of(JServer(
        jcfg, JState(ta=jnp.asarray(ta)),
        JPolicy(max_batch=8, backend="oracle"))))
    assert set(want) <= set(got)
    for block in ("history", "pipeline", "deadline", "tiers"):
        assert set(got[block]) == set(want[block]), block
    assert set(got["engine_cache"]) <= set(want["engine_cache"])
    assert got["requests"] == 1 and got["rows"] == 3
    assert got["qdepth"] == 0 and 0 < got["batch_fill"] <= 1
    assert set(got["buckets"]) == set(want["buckets"]) == {"4"}
    for key in ("checkpoint", "probe", "mesh", "sparse_layout"):
        assert got[key] is None
    assert got["updates"] == 0 and got["tiers"]["shed_batches"] == 0


@pytest.mark.parametrize("option", [
    {"train_backend": "fused"}, {"checkpoint_dir": "ckpt"},
    {"probe": (np.zeros((1, 18), np.int8), np.zeros(1))}, {"mesh": 2}])
def test_unported_options_raise(option):
    cfg, state = _tm(seed=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TMServer(cfg, state, device="cpu", **option)


def test_unported_planes_raise_and_typos_are_type_errors():
    cfg, state = _tm(seed=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TMServer(cfg, state, ServePolicy(shed_backend="cascade"),
                 device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        TMServer(cfg, state, device="cpu", polcy=None)
    srv = TMServer(cfg, state, ServePolicy(backend="oracle"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        asyncio.run(srv.submit_labeled(np.zeros((1, 2 * F)), [0]))
    for call in (srv.checkpoint, srv.restore):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call("somewhere")


def test_publish_history_and_rollback():
    cfg, s0 = _tm(seed=13)
    _, s1 = _tm(seed=14)
    seen = []
    srv = TMServer(cfg, s0, ServePolicy(backend="oracle"), device="cpu",
                   history_size=2, on_publish=lambda v, s: seen.append(v))
    assert srv.publish(s1) == 1 and srv.state_version == 1
    assert torch.equal(srv.state.ta, s1.ta)
    assert srv.rollback(0) == 2 and torch.equal(srv.state.ta, s0.ta)
    assert srv.history_versions == (1, 2)
    with pytest.raises(KeyError, match="history ring"):
        srv.rollback(0)                     # fell out of the 2-slot ring
    assert seen == [0, 1, 2]
    s = srv.stats()
    assert s["rollbacks"] == 1 and s["state_version"] == 2


def test_edf_orders_by_priority_then_slack():
    cfg, state = _tm(seed=3)
    srv = TMServer(cfg, state, ServePolicy(backend="oracle"), device="cpu")
    lits = np.zeros((1, 2 * F), np.int8)
    t0 = 1000.0

    def mk(seq, deadline=None, priority=0):
        return _Request(lits, None, None, 0, state, deadline=deadline,
                        priority=priority, seq=seq)

    for r in [mk(1, deadline=t0 + 9), mk(2), mk(3, deadline=t0 + 1),
              mk(4, priority=1), mk(5, deadline=t0 + 5, priority=1), mk(6)]:
        srv._ingest(r)
    order = []
    while (r := srv._pop_head()) is not None:
        order.append(r.seq)
    assert order == [3, 1, 2, 6, 5, 4]


@pytest.mark.parametrize("admission", [True, False])
def test_expired_requests_reaped_at_dispatch(admission):
    cfg, state = _tm(seed=5)
    lits = np.zeros((1, 2 * F), np.int8)
    srv = TMServer(cfg, state, ServePolicy(backend="oracle",
                                           admission_control=admission),
                   device="cpu")
    loop = asyncio.new_event_loop()
    try:
        dead, live = loop.create_future(), loop.create_future()
    finally:
        loop.close()
    now = time.monotonic()
    srv._ingest(_Request(lits, dead, None, 0, state, deadline=now - 1.0,
                         seq=1))
    srv._ingest(_Request(lits, live, None, 0, state, deadline=now + 60.0,
                         seq=2))
    srv._reap_expired()
    assert not live.done()
    if admission:
        assert isinstance(dead.exception(), DeadlineExceeded)
        assert [e[-1].seq for e in srv._pending] == [2]
        assert srv.stats()["deadline"]["expired_drops"] == 1
    else:
        assert not dead.done() and len(srv._pending) == 2
        assert srv.stats()["deadline"]["expired_drops"] == 0
    dead.cancel(), live.cancel()


@pytest.mark.parametrize("admission", [True, False])
def test_admission_control_rejects_provably_late(admission):
    cfg, state = _tm(seed=4)

    async def go():
        policy = ServePolicy(max_batch=4, max_wait_us=0, backend="oracle",
                             admission_control=admission)
        async with TMServer(cfg, state, policy, device="cpu") as srv:
            srv._svc.observe(1, 0.050)    # this bucket "always" takes 50ms
            rejected = False
            try:
                await srv.submit(np.zeros((1, 2 * F), np.int8),
                                 deadline_us=1)
            except DeadlineExceeded:
                rejected = True
            await srv.submit(np.zeros((1, 2 * F), np.int8),
                             deadline_us=60_000_000)
            return rejected, srv.stats()

    rejected, stats = asyncio.run(go())
    dl = stats["deadline"]
    assert rejected == admission
    assert dl["admission_rejects"] == (1 if admission else 0)
    assert dl["requests"] == (1 if admission else 2)
    assert dl["misses"] == (0 if admission else 1)


def test_pipeline_depth_validation():
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServePolicy(pipeline_depth=0)


def test_port_imports_no_jax_and_no_repro():
    """The port and its launcher import neither jax nor any ``repro``
    module — checked in a fresh interpreter, since this test process has
    both loaded already."""
    code = ("import sys, repro_torch, repro_torch.serve, "
            "repro_torch.launch.tm_serve, repro_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_request_without_gpu_raises():
    """device=None means cuda; without a GPU every entry point raises
    rather than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU path cannot be shown")
    from repro_torch.kernels.ops import resolve_device
    ta = _ta(seed=1)
    with pytest.raises(RuntimeError, match="is_available"):
        state_from_numpy(ta)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda:0")
    cfg, state = _tm(seed=1)
    with pytest.raises(RuntimeError, match="is_available"):
        TMServer(cfg, state)
    from repro_torch.launch.tm_serve import main
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--duration", "0.1"])


def test_launcher_predict_only_on_cpu(capsys):
    from repro_torch.launch.tm_serve import main
    main(["--device", "cpu", "--backend", "mxu_fused", "--classes", "3",
          "--clauses", "4", "--features", "6", "--clients", "2",
          "--duration", "0.3", "--stats-every", "0.1",
          "--deadline-us", "1000000", "--priority-mix", "0.5"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "closed-loop x2" in out
    assert "deadline 1000000us" in out and "engine cache" in out
