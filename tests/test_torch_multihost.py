"""Port parity: data-parallel training, mirroring ``tests/test_multihost``.
Mesh size is not a numerics knob.

The port's ``sharded`` TrainEngine runs each shard's K1 + K2 body on its
shard's device from one process, where the JAX engine has a
``shard_map``.  For any device count D, any (cfg, state), any labeled
batch — divisible or ragged — and any key, the post-step state is
bitwise the port's single-device ``fused`` backend's, and the JAX
``ShardedTrainEngine``'s on JAX's simulated mesh of the same D.  The
meshes here are simulated: ``data_mesh(d, devices=[cpu] * 8)``, D shards
of the CPU run one after another (the port's counterpart of the JAX
suite's ``--xla_force_host_platform_device_count=8``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.engine import get_train_engine as jget_train_engine
from repro_torch.core import prng
from repro_torch.core.tm import TMConfig, TMState
from repro_torch.core.tm_train import train_epoch
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import DATA_AXIS, Mesh, data_mesh
from repro_torch.engine import available_train_backends, get_train_engine

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

DS = (1, 2, 4, 8)
CPU = torch.device("cpu")


def _mesh(d):
    """A simulated d-shard mesh of the CPU."""
    return data_mesh(d, devices=[CPU] * 8)


def _random_tm(c, m, f, *, density=0.15, seed=0, batch=17, T=5, s=3.9):
    """The JAX suite's ``_random_tm``: a seeded numpy draw → (cfg, CPU
    state, literals, labels)."""
    cfg = TMConfig(n_classes=c, n_clauses=m, n_features=f, T=T, s=s)
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density,
                  cfg.n_states + 1, cfg.n_states)
    lits = rng.integers(0, 2, (batch, 2 * f), dtype=np.int8)
    lits[0] = 0
    lits[-1] = 1
    y = rng.integers(0, c, (batch,), dtype=np.int32)
    k = min(c, batch)
    y[:k] = np.arange(k)        # address as many distinct classes as fit
    return (cfg, TMState(ta=torch.as_tensor(ta, dtype=torch.int32)),
            lits, y)


def _assert_state_equal(a: TMState, b: TMState):
    assert torch.equal(a.ta, b.ta)


def test_sharded_backend_registered():
    assert "sharded" in available_train_backends()
    eng = get_train_engine("sharded", TMConfig(n_classes=2, n_clauses=4,
                                               n_features=3),
                           mesh=_mesh(4), block_b=16)
    assert eng.lifecycle_opts() == {"boost_tpf": True, "n_devices": 4,
                                    "block_b": 16, "block_m": 128}


def test_data_mesh_shape_and_validation():
    mesh = _mesh(4)
    assert mesh.axis_names == (DATA_AXIS,) == ("data",)
    assert mesh.shape[DATA_AXIS] == mesh.size == 4
    assert mesh.devices == (CPU,) * 4
    assert data_mesh(devices=[CPU] * 3).size == 3
    with pytest.raises(ValueError, match="devices"):
        data_mesh(9, devices=[CPU] * 8)
    assert hash(mesh) == hash(_mesh(4)) and mesh == _mesh(4)
    assert mesh != _mesh(2)


def test_sharded_engine_rejects_2d_mesh():
    mesh2d = Mesh((CPU,) * 4, ("data", "model"), (2, 2))
    assert mesh2d.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="1-D"):
        get_train_engine("sharded", TMConfig(n_classes=2, n_clauses=4,
                                             n_features=3), mesh=mesh2d)


# -- bitwise parity with the single-device fused backend ---------------

# odd M (unequal ± polarity halves), C=2 (forced negative class), wide F
SHAPES = [(2, 6, 9), (3, 10, 12), (5, 7, 33)]


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: f"C{s[0]}M{s[1]}F{s[2]}")
def test_step_parity_vs_fused(shape, d):
    """One sharded step == one fused step, bitwise, for every D."""
    cfg, stt, lits, y = _random_tm(*shape, seed=sum(shape), batch=16)
    key = prng.key(sum(shape) + 1)
    ref = get_train_engine("fused", cfg).step(stt, key, lits, y)
    eng = get_train_engine("sharded", cfg, mesh=_mesh(d))
    assert eng.n_devices == d
    _assert_state_equal(eng.step(stt, key, lits, y), ref)


@pytest.mark.parametrize("d", (2, 8))
@pytest.mark.parametrize("density", [0.0, 1.0],
                         ids=["all_exclude", "all_include"])
def test_parity_density_extremes(density, d):
    """Empty (fires-everywhere) and saturated machines are the clause
    eval boundary cases; the shard seam must not move them."""
    cfg, stt, lits, y = _random_tm(3, 8, 11, density=density, seed=21,
                                   batch=16)
    key = prng.key(2)
    _assert_state_equal(
        get_train_engine("sharded", cfg, mesh=_mesh(d)).step(stt, key,
                                                             lits, y),
        get_train_engine("fused", cfg).step(stt, key, lits, y))


@pytest.mark.parametrize("d", (2, 4))
def test_parity_no_boost(d):
    """boost_tpf=False exercises the (s−1)/s Type I include probability."""
    cfg, stt, lits, y = _random_tm(4, 9, 13, seed=5, batch=16)
    key = prng.key(3)
    ref = get_train_engine("fused", cfg, boost_tpf=False).step(
        stt, key, lits, y)
    eng = get_train_engine("sharded", cfg, boost_tpf=False, mesh=_mesh(d))
    _assert_state_equal(eng.step(stt, key, lits, y), ref)


@pytest.mark.parametrize("d", (2, 4, 8))
@pytest.mark.parametrize("batch", [1, 5, 13, 29])
def test_parity_non_divisible_batches(batch, d):
    """Ragged batches (B % D != 0, including B < D) pad with neutral rows
    that must contribute exactly zero deltas."""
    cfg, stt, lits, y = _random_tm(3, 10, 12, seed=batch, batch=batch)
    key = prng.key(batch + 7)
    _assert_state_equal(
        get_train_engine("sharded", cfg, mesh=_mesh(d)).step(stt, key,
                                                             lits, y),
        get_train_engine("fused", cfg).step(stt, key, lits, y))


@pytest.mark.parametrize("d", DS)
def test_chain_parity_vs_fused(d):
    """A 5-step update chain stays bitwise-locked at every step — a
    single-step parity can mask divergence that only compounds."""
    cfg, stt, lits, y = _random_tm(3, 10, 12, seed=9, batch=16)
    ref_eng = get_train_engine("fused", cfg)
    sh_eng = get_train_engine("sharded", cfg, mesh=_mesh(d))
    ref, got = stt, stt
    key = prng.key(4)
    for _ in range(5):
        key, k = prng.split(key)
        ref = ref_eng.step(ref, k, lits, y)
        got = sh_eng.step(got, k, lits, y)
        _assert_state_equal(got, ref)


def test_explicit_mesh_equals_n_devices(monkeypatch):
    """mesh= (an existing 1-D data mesh) and n_devices= are the same
    engine — TMServer hands its resolved mesh straight through.
    n_devices= takes the visible devices (shown with 8 simulated ones)."""
    monkeypatch.setattr(sharding, "visible_devices", lambda: [CPU] * 8)
    cfg, stt, lits, y = _random_tm(3, 8, 10, seed=13, batch=16)
    key = prng.key(5)
    a = get_train_engine("sharded", cfg, mesh=data_mesh(4))
    b = get_train_engine("sharded", cfg, n_devices=4, cache=False)
    assert a.n_devices == b.n_devices == 4 and a.mesh == b.mesh
    _assert_state_equal(a.step(stt, key, lits, y),
                        b.step(stt, key, lits, y))


def test_train_epoch_parity():
    """``train_epoch(backend="sharded")`` keeps the chain bitwise-locked
    to the fused epoch, ragged tail and all."""
    cfg, stt, _, _ = _random_tm(3, 8, 10, seed=17)
    rng = np.random.default_rng(18)
    x = rng.integers(0, 2, (70, cfg.n_literals), dtype=np.int8)
    y = rng.integers(0, cfg.n_classes, (70,), dtype=np.int32)
    key = prng.key(6)
    ref = train_epoch(cfg, stt, key, x, y, batch_size=16, backend="fused")
    got = train_epoch(cfg, stt, key, x, y, batch_size=16, backend="sharded",
                      mesh=_mesh(8))
    _assert_state_equal(got, ref)


@settings(max_examples=10, deadline=None)
@given(c=st.integers(min_value=2, max_value=6),
       m=st.integers(min_value=2, max_value=14),
       f=st.integers(min_value=1, max_value=24),
       batch=st.integers(min_value=1, max_value=24),
       d=st.sampled_from((2, 4, 8)),
       density=st.sampled_from((0.0, 0.05, 0.3, 1.0)),
       seed=st.integers(min_value=0, max_value=2**16))
def test_sharded_parity_property(c, m, f, batch, d, density, seed):
    """Property: sharded == fused bit-for-bit on arbitrary shapes, batch
    sizes (ragged included), densities, device counts and keys."""
    cfg, stt, lits, y = _random_tm(c, m, f, density=density, seed=seed,
                                   batch=batch)
    key = prng.key(seed)
    ref = get_train_engine("fused", cfg).step(stt, key, lits, y)
    got = get_train_engine("sharded", cfg, mesh=_mesh(d)).step(stt, key,
                                                               lits, y)
    _assert_state_equal(got, ref)


# -- against the JAX ShardedTrainEngine -------------------------------


@pytest.mark.parametrize("d", (1, 4))
def test_sharded_step_vs_jax(d):
    """Port ``sharded`` on a simulated d-shard CPU mesh == the JAX
    ``ShardedTrainEngine`` on JAX's simulated mesh of the same d, for a
    2-step chain on a ragged batch (13 rows; at d=4 the 5 classes pad to
    8).  One shape only: each JAX mesh size compiles its step anew."""
    shape, batch = (5, 7, 33), 13
    assert len(jax.devices()) >= 8, "conftest must simulate 8 devices"
    cfg, stt, lits, y = _random_tm(*shape, seed=sum(shape) + batch,
                                   batch=batch)
    jcfg = JConfig(n_classes=cfg.n_classes, n_clauses=cfg.n_clauses,
                   n_features=cfg.n_features, T=cfg.T, s=cfg.s)
    jeng = jget_train_engine("sharded", jcfg, n_devices=d)
    eng = get_train_engine("sharded", cfg, mesh=_mesh(d))
    assert jeng.n_devices == eng.n_devices == d
    jst = JState(ta=jnp.asarray(stt.ta.numpy()))
    jkey, key = jax.random.key(d + 31), prng.key(d + 31)
    for _ in range(2):
        jkey, jk = jax.random.split(jkey)
        key, k = prng.split(key)
        jst = jeng.step(jst, jk, jnp.asarray(lits), jnp.asarray(y))
        stt = eng.step(stt, k, lits, y)
        np.testing.assert_array_equal(stt.ta.numpy(), np.asarray(jst.ta))
