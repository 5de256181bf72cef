"""Port parity: ``repro_torch.engine.autotune``, the paper presets
(``repro_torch.configs``) and the launcher's fleet mode, mirroring
``tests/test_engine.py`` (autotune lookup, ``engine_from_model_config``),
the train lookup of ``tests/test_train_engine.py`` (the port's search
space has no train entry, so nothing is consulted there) and
``tests/test_tm_server.py`` (measured routes over the heuristic, a stale
route falling back).

The port reads the JAX package's committed cache on the CPU and must
agree with the JAX ``lookup`` there, once the TPU tiles the port has no
use for are filtered out; a ``|cuda`` entry is never read on the CPU.
Every write goes to ``tmp_path`` through ``REPRO_AUTOTUNE_CACHE``, and
the last test checks that the committed cache is byte-identical after
them.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.tm import TMConfig as JConfig
from repro.core.tm import TMState as JState
from repro.engine import autotune as jautotune
from repro.engine import engine_from_model_config as jengine_from_model_config
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import state_from_numpy
from repro_torch.core.tm import TMConfig
from repro_torch.engine import (autotune, clear_train_engine_cache,
                                engine_from_model_config, get_engine,
                                get_train_engine)
from repro_torch.kernels.train_fused import DEFAULT_BLOCK_B, DEFAULT_BLOCK_M
from repro_torch.serve import ServePolicy, TMServer, route_buckets

# one xdist worker per core runs these files beside the JAX suite:
# torch's default of one intra-op thread per core oversubscribes the CPU
torch.set_num_threads(2)

COMMITTED = autotune._DEFAULT_CACHE
COMMITTED_BYTES = COMMITTED.read_bytes()


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test reads and writes its own cache file unless it points
    ``REPRO_AUTOTUNE_CACHE`` elsewhere itself."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))


def _tm(c, m, f, seed=0, density=0.2):
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
        .astype(np.int32)
    return TMConfig(n_classes=c, n_clauses=m, n_features=f), ta


def _write(tmp_path, data, name="tune.json"):
    path = tmp_path / name
    path.write_text(json.dumps(data))
    return path


def test_autotune_lookup_applied(tmp_path, monkeypatch):
    """get_engine picks tuned opts from the JSON cache; explicit opts
    win; stale opts (the JAX package's TPU tiles) are dropped."""
    cfg, ta = _tm(3, 10, 12, seed=29)
    st = state_from_numpy(ta, device="cpu")
    key = autotune.shape_key("cascade", cfg, "cpu")
    assert key == "cascade|C3|M10|L24|cpu"
    path = _write(tmp_path, {"best": {key: {"stage1_fraction": 0.875,
                                            "block_b": 16}}})
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    assert autotune.lookup("cascade", cfg, "cpu") == {"stage1_fraction":
                                                      0.875}
    eng = get_engine("cascade", cfg, st, cache=False)
    assert eng.stage1_fraction == 0.875
    eng = get_engine("cascade", cfg, st, cache=False, stage1_fraction=0.5)
    assert eng.stage1_fraction == 0.5
    # untuned backend / missing file → no opts, no error
    assert autotune.lookup("oracle", cfg, "cpu") == {}
    assert autotune.lookup("swar_fused", cfg, "cpu") == {}
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "none.json"))
    assert autotune.lookup("cascade", cfg, "cpu") == {}
    lits = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, (8, cfg.n_literals), dtype=np.int8))
    ref = get_engine("oracle", cfg, st).infer(lits)
    assert torch.equal(eng.infer(lits).prediction, ref.prediction)


def test_train_tiles_not_consulted(tmp_path, monkeypatch):
    """The port's search space has no train entry: a ``train:fused``
    entry (the JAX package's TPU tiles) is dropped by ``lookup``, and
    ``get_train_engine`` builds with the constructor defaults unless
    opts are passed explicitly."""
    clear_train_engine_cache()
    cfg = TMConfig(n_classes=3, n_clauses=10, n_features=12)
    key = autotune.shape_key("train:fused", cfg, "cpu")
    path = _write(tmp_path, {"best": {key: {"block_b": 32, "block_m": 32}}})
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    assert "train:fused" not in autotune.SEARCH_SPACE
    assert autotune.lookup("train:fused", cfg, "cpu") == {}
    assert get_train_engine("fused", cfg, cache=False)._blocks == (
        DEFAULT_BLOCK_B, DEFAULT_BLOCK_M)
    eng = get_train_engine("fused", cfg, cache=False, block_b=32)
    assert eng._blocks == (32, DEFAULT_BLOCK_M)


def test_measured_routing_overrides_heuristic():
    """Recorded routes win over the density heuristic per bucket, keyed
    to the state's device kind; a stale route naming an unregistered
    backend falls back to the heuristic, in route_buckets and in a
    TMServer built on the state."""
    cfg, ta = _tm(3, 7, 9, seed=8, density=0.05)
    st = state_from_numpy(ta, device="cpu")
    autotune.record_serve_routing(cfg, {8: "adder_tree",
                                        1: "renamed_backend"}, "cpu")
    routes = route_buckets(cfg, st, (1, 8))
    assert routes == {8: "adder_tree", 1: "sparse_csr"}
    assert route_buckets(cfg, st, (1, 8), backend="oracle") == \
        {1: "oracle", 8: "oracle"}
    srv = TMServer(cfg, st, ServePolicy(max_batch=8, buckets=(1, 8)),
                   device="cpu")
    assert srv.routing == routes


def test_measured_routes_match_jax(tmp_path, monkeypatch):
    """A routing table the JAX package records on the CPU routes the
    port's CPU server the same way, bucket for bucket."""
    cfg, ta = _tm(3, 7, 9, seed=9, density=0.05)
    jcfg = JConfig(n_classes=3, n_clauses=7, n_features=9)
    jautotune.record_serve_routing(jcfg, {1: "swar_packed", 4: "oracle",
                                          8: "gone_backend"})
    from repro.serve import route_buckets as jroute_buckets
    want = jroute_buckets(jcfg, JState(ta=jnp.asarray(ta)), (1, 2, 4, 8))
    got = route_buckets(cfg, state_from_numpy(ta, device="cpu"),
                        (1, 2, 4, 8))
    assert got == want == {1: "swar_packed", 2: "sparse_csr", 4: "oracle",
                           8: "sparse_csr"}


def test_lookup_equals_jax_on_committed_cache(monkeypatch):
    """For every entry of the committed cache, the port's CPU lookup
    equals the JAX package's once the opts outside the port's search
    space (TPU tiles) are filtered; the cascade entry carries over."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(COMMITTED))
    assert jax.default_backend() == "cpu"
    data = json.loads(COMMITTED_BYTES)
    carried = 0
    for key in data["best"]:
        backend, c, m, lit, kind = key.split("|")
        assert kind == "cpu", key
        c, m, f = int(c[1:]), int(m[1:]), int(lit[1:]) // 2
        want = {k: v for k, v in jautotune.lookup(
            backend, JConfig(n_classes=c, n_clauses=m,
                             n_features=f)).items()
                if k in autotune.SEARCH_SPACE.get(backend, {})}
        got = autotune.lookup(backend, TMConfig(n_classes=c, n_clauses=m,
                                                n_features=f), "cpu")
        assert got == want, key
        carried += bool(got)
    assert carried >= 1      # the cascade fraction reaches the port


def test_cuda_entries_never_read_on_cpu(tmp_path, monkeypatch):
    """Entries keyed ``|cuda`` apply to cuda states only: on the CPU the
    engine keeps its default opts and the routes their heuristic."""
    cfg, ta = _tm(3, 7, 9, seed=10, density=0.05)
    st = state_from_numpy(ta, device="cpu")
    path = _write(tmp_path, {
        "best": {autotune.shape_key("cascade", cfg, "cuda"):
                 {"stage1_fraction": 0.875}},
        "serve_best": {autotune.serve_key(cfg, 8, "cuda"): "oracle"}})
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    assert autotune.device_kind() == "cuda"
    assert autotune.device_kind(torch.device("cuda", 1)) == "cuda"
    assert autotune.lookup("cascade", cfg) == {"stage1_fraction": 0.875}
    assert autotune.serve_lookup(cfg, 8, "cuda:0") == "oracle"
    assert autotune.lookup("cascade", cfg, "cpu") == {}
    assert autotune.serve_lookup(cfg, 8, "cpu") is None
    assert get_engine("cascade", cfg, st,
                      cache=False).stage1_fraction == 0.625
    assert route_buckets(cfg, st, (8,)) == {8: "sparse_csr"}


def test_run_sweep_writes_and_is_read_back(tmp_path, capsys):
    """A quick CPU sweep (through the CLI) records a winner from the
    search grid, its measurements, and get_engine then applies it."""
    autotune.main(["--quick", "--device", "cpu", "--repeat", "1"])
    data = json.loads((tmp_path / "tune.json").read_text())
    cfg = TMConfig(n_classes=10, n_clauses=100,
                   n_features=autotune.F_FEATURES)
    key = autotune.shape_key("cascade", cfg, "cpu")
    assert data["best"][key]["stage1_fraction"] in \
        autotune.SEARCH_SPACE["cascade"]["stage1_fraction"]
    assert len(data["measurements"][key]) == 4
    assert data["include_density"] == autotune.INCLUDE_DENSITY
    assert "wrote" in capsys.readouterr().out
    _, ta = _tm(10, 100, autotune.F_FEATURES, seed=1, density=0.05)
    eng = get_engine("cascade", cfg, state_from_numpy(ta, device="cpu"),
                     cache=False)
    assert eng.stage1_fraction == data["best"][key]["stage1_fraction"]


def test_writes_to_committed_cache_refused(monkeypatch):
    """Recording into the JAX package's committed cache raises before
    any data is touched; lookups keep reading it unchanged."""
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert autotune.cache_path() == COMMITTED
    cfg = TMConfig(n_classes=10, n_clauses=100, n_features=196)
    with pytest.raises(RuntimeError, match="REPRO_AUTOTUNE_CACHE"):
        autotune.record_serve_routing(cfg, {8: "oracle"}, "cpu")
    with pytest.raises(RuntimeError, match="REPRO_AUTOTUNE_CACHE"):
        autotune.run_sweep(quick=True, device="cpu")
    assert autotune.serve_lookup(cfg, 8, "cpu") is None
    assert autotune.lookup("cascade", cfg, "cpu") == {"stage1_fraction":
                                                      0.625}


# -- the paper presets ----------------------------------------------


def test_tm_presets_equal_jax_registry():
    """Every port preset equals the JAX registry's config of that name,
    field for field, and the port carries every TM-family preset."""
    from repro.configs import list_configs as jlist_configs
    names = list_configs()
    assert names == sorted(n for n in jlist_configs()
                           if jget_config(n).family == "tm")
    for name in names:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name)), name


def test_engine_from_model_config():
    """engine_from_model_config builds the preset's backend at its shape,
    answering as the JAX package's does on the same state."""
    mcfg = get_config("tm-iris-10")
    cfg = TMConfig(n_classes=3, n_clauses=10, n_features=12, T=5, s=1.5)
    rng = np.random.default_rng(2)
    ta = rng.integers(128, 130, (3, 10, 24)).astype(np.int32)
    eng = engine_from_model_config(mcfg, state_from_numpy(ta, device="cpu"))
    assert eng.name == mcfg.backend and eng.cfg == cfg
    lits = rng.integers(0, 2, (8, 24), dtype=np.int8)
    jeng = jengine_from_model_config(jget_config("tm-iris-10"),
                                     JState(ta=jnp.asarray(ta)))
    want = jeng.infer(jnp.asarray(lits))
    got = eng.infer(torch.as_tensor(lits))
    np.testing.assert_array_equal(got.prediction.numpy(),
                                  np.asarray(want.prediction))
    np.testing.assert_array_equal(got.class_sums.numpy(),
                                  np.asarray(want.class_sums))
    with pytest.raises(NotImplementedError, match="shard_batch"):
        engine_from_model_config(dataclasses.replace(mcfg, shard_batch=True),
                                 state_from_numpy(ta, device="cpu"))


# -- the launcher's fleet mode ---------------------------------------


def test_launcher_fleet_mode_on_cpu(tmp_path, capsys):
    """``--models`` serves a 3-model manifest (two packed tenants, one
    odd-shaped learner) on the CPU and prints the fleet lines."""
    from repro_torch.launch.tm_serve import main
    manifest = tmp_path / "fleet.json"
    manifest.write_text(json.dumps([
        {"name": "a", "seed": 0}, {"name": "b", "seed": 1, "weight": 4.0},
        {"name": "c", "clauses": 6, "train_backend": "fused"}]))
    main(["--models", str(manifest), "--device", "cpu", "--duration", "1",
          "--classes", "3", "--clauses", "8", "--features", "16",
          "--clients", "4", "--backend", "mxu_fused",
          "--cache-entries", "8", "--stats-every", "0.5"])
    out = capsys.readouterr().out
    assert "fleet: 3 models, 1 pack group(s) on cpu" in out
    assert "[a+b: 6 fused classes]" in out
    assert "closed-loop x4 over 3 models" in out
    for name, plane in (("a", "group 0 seg [0, 3]"),
                        ("b", "group 0 seg [3, 6]"), ("c", "solo")):
        line = next(ln for ln in out.splitlines()
                    if ln.strip().startswith(f"{name}:"))
        assert plane in line and "errors=0" in line
    assert "weight=4.000" in out
    assert "engine cache:" in out and "size" in out


@pytest.mark.parametrize("manifest", [
    {"name": "a"},                       # not a list
    [{"seed": 3}],                       # an entry without a name
    [{"name": "a"}, {"name": "a", "seed": 1}],   # a duplicate name
])
def test_launcher_manifest_errors_match_jax(tmp_path, manifest):
    """Malformed manifests exit with the JAX launcher's messages."""
    import argparse
    from repro.launch.tm_serve import _load_manifest as jload
    from repro_torch.launch.tm_serve import _load_manifest
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(manifest))
    args = argparse.Namespace(classes=3, clauses=8, features=16,
                              density=0.05, seed=0, device="cpu")
    with pytest.raises(SystemExit) as want:
        jload(str(path), args)
    with pytest.raises(SystemExit) as got:
        _load_manifest(str(path), args)
    assert str(got.value) == str(want.value)


def test_launcher_manifest_specs_match_jax(tmp_path):
    """A valid manifest yields the JAX launcher's specs: the same
    configs, state draws and pass-through keywords."""
    import argparse
    from repro.launch.tm_serve import _load_manifest as jload
    from repro_torch.launch.tm_serve import _load_manifest
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps([
        {"name": "a", "seed": 0}, {"name": "b", "seed": 1, "weight": 4.0},
        {"name": "c", "clauses": 6, "density": 0.3,
         "train_backend": "fused", "history_size": 4}]))
    args = argparse.Namespace(classes=3, clauses=8, features=16,
                              density=0.05, seed=7, device="cpu")
    want, got = jload(str(path), args), _load_manifest(str(path), args)
    assert list(got) == list(want)
    for name in want:
        w, g = dict(want[name]), dict(got[name])
        assert dataclasses.asdict(g.pop("cfg")) == \
            dataclasses.asdict(w.pop("cfg"))
        np.testing.assert_array_equal(g.pop("state").ta.numpy(),
                                      np.asarray(w.pop("state").ta))
        assert g == w


def test_committed_cache_byte_identical():
    """Runs last in this file: the writes above all went elsewhere."""
    assert COMMITTED.read_bytes() == COMMITTED_BYTES
