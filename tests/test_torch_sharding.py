"""Port parity: batch-axis sharded serving, mirroring the ShardedEngine
half of ``tests/test_sharding_dryrun``.

``ShardedEngine`` runs the inner backend on one batch slice per mesh
member, each on its member's device, and concatenates the results; for
every registered backend it answers bitwise as the unsharded engine,
ragged batches included.  The meshes are simulated CPU meshes
(``data_mesh(n, devices=[cpu] * n)``).  The copy of an engine onto
another device is held here on the ``meta`` device (a CPU box has no
second real one); ``tests/test_torch_cuda.py`` runs mixed CPU/GPU meshes
on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import state_from_numpy
from repro_torch.core import prng
from repro_torch.core.tm import TMConfig
from repro_torch.distributed import Mesh, data_mesh, resolve_mesh
from repro_torch.distributed import mesh_device, visible_devices
from repro_torch.engine import (available_backends, clear_engine_cache,
                                engine_cache_info, evict_engines_for_state,
                                get_engine, state_nbytes)
from repro_torch.engine.sharding import ShardedEngine, _replica

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

CPU = torch.device("cpu")
META = torch.device("meta")


def _mesh(n):
    return data_mesh(n, devices=[CPU] * n)


def _random_tm(c, m, f, *, density=0.3, seed=0):
    """The JAX suite's ``_random_tm`` (test_sharding_dryrun): a seeded
    numpy draw → (cfg, CPU state)."""
    cfg = TMConfig(n_classes=c, n_clauses=m, n_features=f)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density,
                  cfg.n_states + 1, cfg.n_states).astype(np.int32)
    return cfg, state_from_numpy(ta, device="cpu")


@pytest.fixture
def fresh_cache():
    clear_engine_cache()
    yield
    clear_engine_cache()


@pytest.mark.parametrize("batch", [16, 13], ids=["divisible", "ragged-pads"])
@pytest.mark.parametrize("backend", available_backends())
def test_sharded_engine_bit_exact_all_backends(backend, batch):
    """ShardedEngine.infer == unsharded infer, bitwise, for every
    registered backend — including ragged batches whose zero-padded rows
    must be sliced off, not served — and for ``aux`` leaves too."""
    cfg, st = _random_tm(4, 10, 12, seed=7)
    lits = np.random.default_rng(8).integers(0, 2, (batch, cfg.n_literals),
                                             dtype=np.int8)
    ref = get_engine(backend, cfg, st).infer(lits)
    sharded = get_engine(backend, cfg, st, shard_batch=_mesh(8))
    assert sharded.n_devices == 8 and isinstance(sharded, ShardedEngine)
    assert sharded.name == f"{backend}+shard_batch"
    for src in (lits, torch.as_tensor(lits)):
        res = sharded.infer(src)
        assert res.prediction.shape[0] == batch
        assert torch.equal(res.prediction, ref.prediction)
        assert torch.equal(res.class_sums, ref.class_sums)
        assert set(res.aux) == set(ref.aux)
        for k in ref.aux:
            assert torch.equal(res.aux[k], ref.aux[k]), k


def test_sharded_engine_refusals():
    """A 2-D mesh and an inner engine with a noise_key are refused (every
    shard would draw the same jitter)."""
    cfg, st = _random_tm(3, 6, 5, seed=1)
    inner = get_engine("oracle", cfg, st)
    with pytest.raises(ValueError, match="1-D"):
        ShardedEngine(inner, mesh=Mesh((CPU,) * 4, ("data", "model"),
                                       (2, 2)))
    noisy = get_engine("time_domain", cfg, st, noise_key=prng.key(3))
    with pytest.raises(ValueError, match="noise_key"):
        ShardedEngine(noisy, devices=[CPU] * 2)
    private = ShardedEngine(inner, devices=[CPU] * 3)
    assert private.mesh.axis_names == ("batch",) and private.n_devices == 3


def test_get_engine_shard_batch_caching(fresh_cache):
    """Mesh-wrapped engines cache by the mesh (a hashable value: an equal
    mesh hits), apart from the unsharded engine and other meshes; each is
    pinned to the state (superseding it evicts them all) and charged one
    state's bytes per distinct device."""
    cfg, st = _random_tm(3, 6, 5, seed=2)
    plain = get_engine("swar_packed", cfg, st)
    a = get_engine("swar_packed", cfg, st, shard_batch=_mesh(4))
    assert get_engine("swar_packed", cfg, st, shard_batch=_mesh(4)) is a
    b = get_engine("swar_packed", cfg, st, shard_batch=_mesh(2))
    assert len({id(plain), id(a), id(b)}) == 3
    assert get_engine("swar_packed", cfg, st) is plain
    assert a.inner is not plain and a.replicas == {CPU: a.inner}
    info = engine_cache_info()
    assert info["size"] == 3 and info["hits"] == 2
    assert info["bytes"] == 3 * state_nbytes(st)
    assert evict_engines_for_state(st) == 3
    if not visible_devices():
        with pytest.raises(RuntimeError, match="devices="):
            get_engine("swar_packed", cfg, st, shard_batch=True)


def test_data_mesh_validation():
    """data_mesh takes the visible GPUs unless given devices=, refuses a
    count past them (naming devices=), allows repeats; resolve_mesh and
    mesh_device are the server's seams."""
    mesh = data_mesh(3, devices=[CPU] * 5)
    assert mesh.size == 3 and mesh.shape == {"data": 3}
    assert mesh.distinct_devices() == (CPU,)
    with pytest.raises(ValueError, match="devices="):
        data_mesh(len(visible_devices()) + 1)
    with pytest.raises(ValueError, match="hold"):
        Mesh((CPU,) * 3, ("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="at least one"):
        Mesh(())
    if not visible_devices():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_mesh()
    assert resolve_mesh(None) is None and resolve_mesh(mesh) is mesh
    with pytest.raises(ValueError, match="1-D"):
        resolve_mesh(Mesh((CPU,) * 4, ("data", "model"), (2, 2)))
    assert mesh_device(mesh) == CPU == mesh_device(mesh, "cpu")
    with pytest.raises(ValueError, match="not in the mesh"):
        mesh_device(mesh, "meta")


@pytest.mark.parametrize("backend", available_backends())
def test_replica_copies_layout_once(backend):
    """The per-device copy of an engine (here onto ``meta``): every
    tensor of its layout on the engine's device moves, the original is
    untouched, nested engines are copied too and plain counters (the
    cascade's ``passes``) stay shared."""
    cfg, st = _random_tm(3, 6, 5, seed=4)
    inner = get_engine(backend, cfg, st, cache=False)
    before = {k: v for k, v in vars(inner).items()
              if isinstance(v, torch.Tensor)}
    rep = _replica(inner, META)
    assert rep is not inner and rep.device == META
    assert inner.device == CPU
    for k, v in before.items():
        assert getattr(inner, k) is v
        assert getattr(rep, k).device == META, k
    if hasattr(inner, "passes"):
        assert rep.passes is inner.passes
        assert rep._full.device == META and inner._full.device == CPU
    if hasattr(inner, "ell"):
        assert rep.ell.indices.device == META
    assert _replica(inner, CPU) is inner
