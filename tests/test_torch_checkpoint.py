"""Port parity: ``repro_torch.checkpoint`` against ``repro.checkpoint``,
mirroring ``tests/test_checkpoint`` case for case (atomicity, retention,
the save/gc race, the TM lifecycle adapters, key cursors), plus what the
port adds: its msgpack subset byte for byte against ``msgpack``, the
JAX treedef strings, snapshots read across the two packages both ways
with identical manifest bytes, and the leaf types the port takes.
"""

import struct
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.engine.train import export_key_cursor as jexport_key_cursor
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import _msgpack
from repro_torch.core import prng
from repro_torch.engine import export_key_cursor, import_key_cursor
from repro_torch.optim import OptState
from repro_torch.train import TrainState

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

C, M, F = 3, 8, 9


def _tree(seed, shape=(3, 4)):
    rng = np.random.default_rng(seed)
    return {"ta": rng.integers(1, 256, shape).astype(np.int32)}


def _ta(seed=0):
    return np.random.default_rng(seed).integers(
        1, 257, (C, M, 2 * F)).astype(np.int32)


def _extra(version=12):
    """An ``extra`` dict of the shape ``TMServer.checkpoint`` writes."""
    return {"version": version, "has_cursor": True,
            "cfg": {"n_classes": C, "n_clauses": M, "n_features": F,
                    "n_states": 128, "T": 5, "s": 3.9},
            "train_backend": "sparse",
            "train_opts": {"boost_tpf": True, "k_slack": 8,
                           "rebuild_threshold": 0.25, "block_b": 64,
                           "block_m": 128},
            "updates": version, "rollbacks": 0, "mesh_devices": None,
            "key_impl": "threefry2x32"}


def _manifest_bytes(directory, step):
    with open(f"{directory}/step_{step}/manifest.msgpack", "rb") as f:
        return f.read()


# -- the cases of tests/test_checkpoint.py ------------------------------


def test_save_restore_round_trip(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree(0)
    ckpt.save(d, 7, tree, extra={"version": 7, "note": "x"})
    assert ckpt.latest_step(d) == 7
    assert ckpt.valid_steps(d) == [7]
    got, extra = ckpt.restore(d, 7, {"ta": 0})
    assert isinstance(got["ta"], np.ndarray)
    np.testing.assert_array_equal(got["ta"], tree["ta"])
    assert extra == {"version": 7, "note": "x"}
    assert ckpt.read_manifest_extra(d, 7) == extra


def test_latest_step_ignores_incomplete(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(str(d), 1, _tree(1))
    # a crashed save: directory without the .complete marker
    (d / "step_9").mkdir()
    assert ckpt.latest_step(str(d)) == 1
    assert ckpt.valid_steps(str(d)) == [1]


def test_gc_keep_retention(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, _tree(s))
    ckpt.gc_keep(d, keep=2)
    assert ckpt.valid_steps(d) == [3, 4]


def test_gc_keep_never_prunes_in_flight_step(tmp_path, monkeypatch):
    """An in-flight re-save of an old step number pins that step against
    retention until its ``.complete`` lands.  The gate names the writer
    thread before ``save_async`` starts it (by the thread name the module
    gives it), so the writer can never reach ``np.savez`` ungated — the
    race that makes the JAX test flaky under xdist."""
    d = str(tmp_path / "ck")
    for s in (5, 7):
        ckpt.save(d, s, _tree(s), extra={"gen": "old"})

    in_shard_write = threading.Event()
    release = threading.Event()
    real_savez = np.savez
    gated = {"ckpt-save-5"}

    def slow_savez(*args, **kwargs):
        if threading.current_thread().name in gated:
            in_shard_write.set()
            assert release.wait(timeout=30)
        return real_savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", slow_savez)
    t = ckpt.save_async(d, 5, _tree(50), extra={"gen": "new"})
    assert t.name in gated
    assert in_shard_write.wait(timeout=30)

    # while step 5's new write is in flight, retention must leave it
    # alone: the stale completed step_5 survives, step_7 is the newest
    ckpt.gc_keep(d, keep=1)
    assert ckpt.valid_steps(d) == [5, 7]
    assert ckpt.read_manifest_extra(d, 5) == {"gen": "old"}

    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    # the re-save landed atomically despite the interleaved gc ...
    assert ckpt.read_manifest_extra(d, 5) == {"gen": "new"}
    got, _ = ckpt.restore(d, 5, {"ta": 0})
    np.testing.assert_array_equal(got["ta"], _tree(50)["ta"])
    # ... and once the writer finished, the step is an ordinary
    # retention candidate again
    ckpt.gc_keep(d, keep=1)
    assert ckpt.valid_steps(d) == [7]


def test_save_async_registers_before_thread_starts(tmp_path, monkeypatch):
    """The in-flight pin exists the moment ``save_async`` returns: a gc
    issued right after may run before the writer is even scheduled."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, _tree(3), extra={"gen": "old"})
    release = threading.Event()
    real_savez = np.savez

    def gated_savez(*args, **kwargs):
        assert release.wait(timeout=30)
        return real_savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", gated_savez)
    t = ckpt.save_async(d, 3, _tree(30), extra={"gen": "new"})
    ckpt.gc_keep(d, keep=0)      # prune everything prunable, right now
    assert ckpt.valid_steps(d) == [3], "in-flight step was pruned"
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert ckpt.read_manifest_extra(d, 3) == {"gen": "new"}


def test_tm_lifecycle_round_trip(tmp_path):
    d = str(tmp_path / "ck")
    ta = _ta(0)
    key = prng.key(42)
    data, impl = export_key_cursor(key)
    tree = ckpt.tm_lifecycle_tree(torch.from_numpy(ta), data)
    ckpt.save(d, 12, tree, extra={"version": 12, "has_cursor": True,
                                  "key_impl": impl})

    step, got, extra = ckpt.restore_tm_lifecycle(d)
    assert step == 12 and extra["version"] == 12
    np.testing.assert_array_equal(got["ta"], ta)
    restored = import_key_cursor(got["cursor"], extra["key_impl"])
    assert torch.equal(restored, key)
    # the restored cursor draws the same splits as the original, and as
    # the JAX key of the same seed
    np.testing.assert_array_equal(prng.key_data(prng.split(restored)),
                                  prng.key_data(prng.split(key)))
    np.testing.assert_array_equal(
        prng.key_data(prng.split(restored)),
        np.asarray(jax.random.key_data(jax.random.split(
            jax.random.key(42)))))


def test_tm_lifecycle_without_cursor(tmp_path):
    d = str(tmp_path / "ck")
    ta = np.ones((2, 4, 6), np.int32)
    ckpt.save(d, 3, ckpt.tm_lifecycle_tree(ta),
              extra={"version": 3, "has_cursor": False})
    step, got, extra = ckpt.restore_tm_lifecycle(d)
    assert step == 3 and "cursor" not in got
    np.testing.assert_array_equal(got["ta"], ta)


def test_restore_tm_lifecycle_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        ckpt.restore_tm_lifecycle(str(tmp_path / "nothing"))


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_key_cursor_round_trip_impls(impl):
    """A JAX cursor imports into the port bit for bit and draws what the
    JAX key draws (threefry); the port has no rbg, which raises and
    names ROADMAP.md."""
    key = jax.random.key(7, impl=impl)
    data, name = jexport_key_cursor(key)
    assert data.dtype == np.uint32
    if impl == "rbg":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            import_key_cursor(data, name)
        return
    back = import_key_cursor(data, name)
    out, out_name = export_key_cursor(back)
    assert out.dtype == np.uint32 and out_name == name
    np.testing.assert_array_equal(out, np.asarray(jax.random.key_data(key)))
    np.testing.assert_array_equal(prng.uniform(back, (4,)).numpy(),
                                  np.asarray(jax.random.uniform(key, (4,))))


# -- the msgpack subset, byte for byte ----------------------------------

# every width boundary of the integer, str, bin, array and map forms
_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
    2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2**31, -2**31 - 1, -2**63, 0.0, -2.5, 3.9, 1e300,
    "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65535,
    "a" * 65536, "PyTreeDef({'cursor': *, 'ta': *})", "é漢字",
    b"", b"x" * 255, b"x" * 256, b"x" * 65535, b"x" * 65536,
    [], list(range(15)), list(range(16)), list(range(65535)),
    list(range(65536)), (1, (2, "three")),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(65536)},
    {"nested": [{"file": "shard_0.npz", "keys": ["leaf_0"]}], "x": None},
]


@pytest.mark.parametrize("value", _VALUES,
                         ids=lambda v: f"{type(v).__name__}"
                                       f"{len(v) if hasattr(v, '__len__') else v}")
def test_packb_unpackb_match_msgpack(value):
    got = _msgpack.packb(value)
    assert got == msgpack.packb(value)
    assert _msgpack.unpackb(got) == msgpack.unpackb(got)


def test_msgpack_reads_float32_and_rejects_the_rest():
    f32 = b"\xca" + struct.pack(">f", 1.5)
    assert _msgpack.unpackb(f32) == msgpack.unpackb(f32) == 1.5
    for bad in (np.int32(3), {1, 2}, object(), np.bool_(True)):
        with pytest.raises(TypeError):
            msgpack.packb(bad)
        with pytest.raises(TypeError):
            _msgpack.packb(bad)
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            _msgpack.packb(big)
    for data in (b"\xd4\x01\x02",            # fixext 1
                 b"\x01\x02",                # extra data
                 b"\xa5ab",                  # truncated str
                 msgpack.packb({1: 2})):     # int map key
        with pytest.raises(ValueError):
            _msgpack.unpackb(data)


@pytest.mark.parametrize("with_cursor", [True, False])
def test_manifests_identical_and_read_both_ways(tmp_path, with_cursor):
    """The same tree and extra make the same ``manifest.msgpack`` bytes in
    both packages, and each package reads the other's snapshot: equal
    leaves (dtypes included) and equal extra."""
    ta = _ta(3)
    words = np.array([0, 42], np.uint32)
    extra = _extra()
    extra["has_cursor"] = with_cursor
    jtree = jckpt.tm_lifecycle_tree(jnp.asarray(ta),
                                    words if with_cursor else None)
    ttree = ckpt.tm_lifecycle_tree(
        torch.from_numpy(ta),
        torch.from_numpy(words.view(np.int32)) if with_cursor else None)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jd, 12, jtree, extra=extra)
    ckpt.save(td, 12, ttree, extra=extra)
    raw = _manifest_bytes(jd, 12)
    assert _manifest_bytes(td, 12) == raw
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw)
    assert _msgpack.packb(msgpack.unpackb(raw)) == raw
    manifest = _msgpack.unpackb(raw)
    assert manifest["dtypes"] == (["uint32", "int32"] if with_cursor
                                  else ["int32"])
    assert manifest["treedef"] == (
        "PyTreeDef({'cursor': *, 'ta': *})" if with_cursor
        else "PyTreeDef({'ta': *})")

    for read, written in ((ckpt.restore_tm_lifecycle, jd),
                          (jckpt.restore_tm_lifecycle, td)):
        step, tree, got_extra = read(written)
        assert step == 12 and got_extra == extra
        assert set(tree) == ({"ta", "cursor"} if with_cursor else {"ta"})
        assert np.asarray(tree["ta"]).dtype == np.int32
        np.testing.assert_array_equal(np.asarray(tree["ta"]), ta)
        if with_cursor:
            assert np.asarray(tree["cursor"]).dtype == np.uint32
            np.testing.assert_array_equal(np.asarray(tree["cursor"]), words)


def test_multi_shard_layout_matches_jax(tmp_path, monkeypatch):
    """Past the shard size limit (1 GiB; lowered here) both packages
    split leaves into the same shard files and manifest."""
    monkeypatch.setattr(jckpt, "_MAX_SHARD_BYTES", 100)
    monkeypatch.setattr(ckpt, "_MAX_SHARD_BYTES", 100)
    rng = np.random.default_rng(5)
    tree = {"a": rng.integers(0, 9, (40,)).astype(np.int32),
            "b": [rng.integers(0, 9, (3,)).astype(np.int64),
                  rng.random((30,)).astype(np.float32)],
            "c": (np.arange(5, dtype=np.uint8),)}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jd, 1, tree)
    ckpt.save(td, 1, tree)
    assert _manifest_bytes(td, 1) == _manifest_bytes(jd, 1)
    assert len(_msgpack.unpackb(_manifest_bytes(td, 1))["shards"]) == 3
    like = {"a": 0, "b": [0, 0], "c": (0,)}
    got, _ = ckpt.restore(jd, 1, like)
    want, _ = jckpt.restore(td, 1, like)
    for x, y, z in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(tree)):
        assert x.dtype == y.dtype == z.dtype
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(np.asarray(y), z)


@pytest.mark.parametrize("tree", [
    {"ta": 0, "cursor": 0}, {"ta": 0}, 0, [0, (0, 0)], (0,),
    {"b": {"z": 0, "y": [0, None]}, "a": (0, 0), "c": None},
    TrainState(params={"w": 0, "a": [0, None]},
               opt=OptState(mu={"w": 0, "a": [0, None]},
                            nu={"w": 0, "a": [0, None]}, count=0), step=0)],
    ids=["lifecycle", "ta", "leaf", "list", "tuple1", "nested",
         "train-state"])
def test_treedef_strings_and_order_match_jax(tree):
    leaves, treedef = ckpt._tree_flatten(
        jax.tree.map(lambda _: np.zeros(()), tree))
    jleaves, jdef = jax.tree.flatten(tree)
    assert treedef == str(jdef)
    assert len(leaves) == len(jleaves)


def test_leaf_types_and_unported_options(tmp_path):
    """Tensor leaves are copied to the host up front by ``save_async``
    (the caller may mutate them at once); a cursor given as the port's
    int32 words is written as uint32 by reinterpreting the bits; a
    bfloat16 leaf goes both ways between the packages (written by the
    port from a tensor, by JAX from a jax array); ``shardings=`` places
    the restored leaves on devices, as the JAX package's does."""
    d = str(tmp_path / "ck")
    ta = torch.from_numpy(_ta(4))
    want = ta.clone()
    key = prng.key(2**31 + 5)                  # a word past int32's range
    t = ckpt.save_async(d, 1, ckpt.tm_lifecycle_tree(ta, key),
                        extra={"has_cursor": True})
    ta.fill_(0)
    t.join(timeout=30)
    assert not t.is_alive()
    _, tree, _ = ckpt.restore_tm_lifecycle(d, 1)
    np.testing.assert_array_equal(tree["ta"], want.numpy())
    assert tree["cursor"].dtype == np.uint32
    np.testing.assert_array_equal(tree["cursor"], [0, 2**31 + 5])
    assert torch.equal(import_key_cursor(tree["cursor"], prng.IMPL), key)
    with pytest.raises(TypeError, match="32-bit words"):
        ckpt.tm_lifecycle_tree(ta, torch.zeros(2, dtype=torch.int64))

    bd = str(tmp_path / "bf16-port")
    ckpt.save(bd, 2, {"w": torch.full((3,), 1.5, dtype=torch.bfloat16)})
    jw, _ = jckpt.restore(bd, 2, {"w": 0})
    assert jw["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jw["w"], np.float32), [1.5] * 3)
    jd = str(tmp_path / "bf16")
    jckpt.save(jd, 1, {"w": jnp.full(3, -2.25, jnp.bfloat16)})
    w, _ = ckpt.restore(jd, 1, {"w": 0})
    assert w["w"].dtype == torch.bfloat16
    assert torch.equal(w["w"], torch.full((3,), -2.25, dtype=torch.bfloat16))
    # shardings= is ported: a tree that does not match raises, as
    # jax.tree.map does; per-leaf devices (None: the CPU) give tensors
    # holding the JAX package's values
    with pytest.raises(ValueError, match="do not match"):
        ckpt.restore(d, 1, {"ta": 0, "cursor": 0}, shardings={})
    _, placed, _ = ckpt.restore_tm_lifecycle(d, shardings={"ta": None})
    _, jplaced, _ = jckpt.restore_tm_lifecycle(d, shardings={"ta": None})
    for k in ("ta", "cursor"):
        assert isinstance(placed[k], torch.Tensor)
        assert placed[k].device == torch.device("cpu")
        np.testing.assert_array_equal(placed[k].numpy(),
                                      np.asarray(jplaced[k]))
    assert placed["cursor"].dtype == torch.uint32
    assert torch.equal(import_key_cursor(placed["cursor"], prng.IMPL), key)
    tree, _ = ckpt.restore(d, 1, {"ta": 0, "cursor": 0},
                           shardings=torch.device("cpu"))
    assert torch.equal(tree["ta"], want)
    with pytest.raises(TypeError, match="checkpoint trees"):
        ckpt.save(d, 3, {"x": "not an array"})


def test_wait_for_complete(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(TimeoutError, match="no valid checkpoint"):
        ckpt.wait_for_complete(d, timeout=0.05, poll=0.01)
    timer = threading.Timer(0.1, ckpt.save, (d, 4, _tree(4)))
    timer.start()
    try:
        assert ckpt.wait_for_complete(d, timeout=30, poll=0.01) == 4
        assert ckpt.wait_for_complete(d, 4, timeout=1) == 4
        with pytest.raises(TimeoutError, match="step_5"):
            ckpt.wait_for_complete(d, 5, timeout=0.05, poll=0.01)
    finally:
        timer.join(timeout=30)


def test_bf16_checkpoint_roundtrip(tmp_path):
    """The JAX package's round-trip case on the port: a float32 and a
    bfloat16 leaf, ``extra`` kept; the bfloat16 leaf is stored as JAX
    stores it (manifest dtype ``bfloat16``, ``uint8`` bytes, the last
    axis doubled) and read back as a bfloat16 tensor."""
    w = torch.randn((3, 3), generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    tree = {"a": torch.arange(5, dtype=torch.float32), "b": {"c": w}}
    ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"})
    assert ckpt.latest_step(str(tmp_path)) == 7
    out, extra = ckpt.restore(str(tmp_path), 7, tree)
    np.testing.assert_array_equal(np.asarray(out["a"]), np.arange(5))
    assert extra["note"] == "x"
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], w)
    man = _msgpack.unpackb(_manifest_bytes(str(tmp_path), 7))
    assert man["dtypes"] == ["float32", "bfloat16"]
    with np.load(tmp_path / "step_7" / "shard_0.npz") as z:
        assert z["leaf_1"].dtype == np.uint8 and z["leaf_1"].shape == (3, 6)
    placed, _ = ckpt.restore(str(tmp_path), 7, tree,
                             shardings=torch.device("cpu"))
    assert placed["b"]["c"].dtype == torch.bfloat16
    assert isinstance(placed["a"], torch.Tensor)


def _train_states(seed):
    """A JAX and a port ``TrainState`` holding the same float32 and
    bfloat16 leaves (a dict, a list and a nested dict of params)."""
    from repro.optim.adamw import OptState as JOptState
    from repro.train.step import TrainState as JTrainState
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
              "h": [rng.normal(0, 1, (2, 5)).astype(np.float32)],
              "b": {"e": rng.normal(0, 1, (6,)).astype(np.float32)}}

    def jtree(f):
        return jax.tree.map(lambda a: jnp.asarray(f(a)).astype(
            jnp.bfloat16 if a.ndim == 1 else jnp.float32), params)

    def ttree(f):
        return jax.tree.map(lambda a: torch.from_numpy(f(a)).to(
            torch.bfloat16 if a.ndim == 1 else torch.float32), params)
    fs = (lambda a: a, lambda a: a * 0.5, lambda a: a * a)
    jst = JTrainState(params=jtree(fs[0]),
                      opt=JOptState(mu=jtree(fs[1]), nu=jtree(fs[2]),
                                    count=jnp.int32(3)),
                      step=jnp.int32(3))
    st = TrainState(params=ttree(fs[0]),
                    opt=OptState(mu=ttree(fs[1]), nu=ttree(fs[2]),
                                 count=torch.tensor(3, dtype=torch.int32)),
                    step=torch.tensor(3, dtype=torch.int32))
    return jst, st


def test_train_state_restores_across_packages(tmp_path):
    """A port-written ``TrainState`` (NamedTuples of dicts, float32 and
    bfloat16 leaves) restores through the JAX ``ckpt.restore`` and a
    JAX-written one through the port's, bitwise; both write the same
    manifest (treedef text ``CustomNode(namedtuple[TrainState], ...)``,
    dtypes)."""
    jst, st = _train_states(2)
    assert ckpt._tree_flatten(st)[1] == str(jax.tree.structure(jst))
    td, jd = str(tmp_path / "torch"), str(tmp_path / "jax")
    ckpt.save(td, 3, st)
    jckpt.save(jd, 3, jst)
    assert _manifest_bytes(td, 3) == _manifest_bytes(jd, 3)
    jgot, _ = jckpt.restore(td, 3, jst)
    got, _ = ckpt.restore(jd, 3, st)
    assert type(jgot).__name__ == "TrainState" and isinstance(got, TrainState)
    assert isinstance(got.opt, OptState)
    for a, b, c in zip(jax.tree.leaves(jgot), ckpt._tree_flatten(got)[0],
                       jax.tree.leaves(jst)):
        want = np.asarray(c)
        assert np.asarray(a).dtype == want.dtype
        b = b if isinstance(b, torch.Tensor) else torch.from_numpy(b)
        if want.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                b.view(torch.int16).numpy(), want.view(np.int16))
            np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), want)
            np.testing.assert_array_equal(np.asarray(a), want)
