"""The benchmark's files: every cell, configuration, traffic mix, entry and
metric is found by name; ``BENCHMARK.json`` keeps to its contract; a new
cell, of the bulk kind or of a new one, is files alone; nothing the
harness loads imports JAX or the JAX package."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, spec
from portbench.devtrace import summarize
from portbench.tests import cellcheck

torch.set_num_threads(2)

ROOT = spec.ROOT
BENCH = ROOT / "portbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _bench() -> dict:
    return spec.load_benchmark(ROOT)


def _cells(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in spec.load_benchmark(root)["workloads"]]


def test_every_cell_is_found_from_files():
    for name in _cells():
        cellcheck.found_from_files(name, ROOT)
    with pytest.raises(KeyError):
        spec.find_cell("no-such.cell")


def test_every_entry_keeps_the_contract():
    """Every entry a traffic file names provides every hook the generic
    checks call, and every cell's traffic keeps to it."""
    entries = {json.loads(p.read_text())["entry"]
               for p in (BENCH / "traffic").glob("*.json")}
    assert entries
    for name in sorted(entries):
        spec.check_entry(name)
    for name in _cells():
        cellcheck.keeps_the_contract(spec.find_cell(name))


def test_benchmark_keeps_to_its_contract():
    _keeps_to_its_contract(ROOT)


def _keeps_to_its_contract(root: Path) -> None:
    bench = spec.load_benchmark(root)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert json.loads((root / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.fullmatch(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:   # each listed cell reports what it moves
            assert "workloads" not in moved or cell in moved["workloads"]
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in (*bench["end_to_end"], *bench["per_layer"]):
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], root)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_config_files_hold_the_ports_presets():
    """Each configuration file states what the entry of each cell that
    runs it gives the program (bulk: the port's preset of its name)."""
    bench = _bench()
    for c in bench["configs"]:
        users = [w["name"] for w in bench["workloads"]
                 if w["config"] == c["name"]]
        assert users, c["name"]
        for name in users:
            cellcheck.config_matches(spec.find_cell(name))


def test_files_under_the_benchmark_use_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+",
                            str(p.relative_to(ROOT))), p


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_harness_sources_import_no_jax_and_the_reference_no_program():
    for p in BENCH.rglob("*.py"):
        assert not _imports(p) & FORBIDDEN, p
    for p in (BENCH / "reference").glob("*.py"):
        assert not _imports(p) & {"repro_torch", *FORBIDDEN}, p


def test_a_run_loads_no_jax_module():
    """What the harness, every entry module a traffic file names, every
    metric reader and the port's paths they drive load, in a fresh
    process, with a short CPU run of every cell: no module whose
    top-level name is a JAX one, compared whole (``repro_torch`` is not
    ``repro``)."""
    cellcheck.loads_no_jax(ROOT, _cells(), also=(
        "repro_torch.engine", "repro_torch.serve", "repro_torch.core.tm"))


def test_no_card_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "tm-mnist-50.bulk", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_new_cell_config_and_metric_are_files_alone(tmp_path):
    """Copy the benchmark's files, then add a configuration, a traffic mix
    and a per-layer metric as new files and new BENCHMARK.json entries:
    the harness finds and runs the new cell and reports the new metric."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    conf = json.loads((BENCH / "configs" / "tm-mnist-50.json").read_text())
    conf.update(preset="tm-iris-10", n_classes=3, n_clauses=10,
                n_features=12, T=5, s=1.5, include_density=0.05)
    (tmp_path / "portbench/configs/tm-small.json").write_text(
        json.dumps(conf))
    (tmp_path / "portbench/traffic/bulk-small.json").write_text(json.dumps(
        {"entry": "bulk", "rows_per_call": 64, "pool_chunks": 2,
         "in_flight": 2, "check_calls": 4, "check_stride": 1,
         "trace_seconds": 0.1}))
    (tmp_path / "portbench/metrics/calls.bulk.py").write_text(
        "def read(run):\n    return run.info.get('calls')\n")
    bench["configs"].append({"name": "tm-small", "source": "a test",
                             "file": "portbench/configs/tm-small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tm-small.bulk-small",
                               "config": "tm-small",
                               "traffic": "bulk-small", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"].append("tm-small.bulk-small")
    bench["per_layer"].append({"name": "calls.bulk", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "rows_per_s",
                               "workloads": ["tm-small.bulk-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("tm-small.bulk-small", tmp_path)
    assert cell.config["n_clauses"] == 10
    for trace in (False, True):
        run = harness.run_cell(cell, 3, 0.2, trace,
                               device=torch.device("cpu"))
        assert run.correct
        got = harness.metrics(run)
        if trace:
            assert got["calls.bulk"]["value"] == run.attempted > 0
        else:
            assert set(got) == {"rows_per_s", "setup_s"}


# An entry of a new kind, with no model: seeded float64 rows times a
# seeded matrix, compared with numpy's product; its control multiplies in
# float32.  Written into a copy of the benchmark by the test below.
TOY_ENTRY = '''"""A toy entry: seeded float64 rows times a seeded matrix.
A row is one row of a call's product, back in host memory."""

import dataclasses
import time

import numpy as np
import torch

from portbench.devtrace import TracedWindow

LIMIT = 1e-9


def _inputs(cell, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n, rows = cell.config["width"], cell.traffic["rows_per_call"]
    x = torch.randn((rows, n), generator=gen, dtype=torch.float64,
                    device=device)
    w = torch.randn((n, n), generator=gen, dtype=torch.float64,
                    device=device)
    return x, w


def _compare(x, w, y):
    want = x.cpu().numpy() @ w.cpu().numpy()
    err = float(np.abs(y.numpy() - want).max() / np.abs(want).max())
    return {"row_error": (err, LIMIT),
            "sample_missing": (int(y.shape[0] == 0), 0)}


def run(run):
    x, w = _inputs(run.cell, run.seed, run.device)
    y = (x @ w).cpu()
    tr = run.cell.traffic
    tw = TracedWindow(run.trace, chips=run.cell.chips)
    t_start = time.perf_counter()
    run.setup_s = t_start - run.t0
    stop = t_start + run.seconds - (tr["trace_seconds"] if run.trace else 0)
    spans = []
    while time.perf_counter() < stop:
        t = time.perf_counter()
        y = (x @ w).cpu()
        spans.append(time.perf_counter() - t)
    run.window_s = time.perf_counter() - t_start
    run.rows = len(spans) * x.shape[0]
    calls = len(spans)
    if run.trace:
        tw.begin()
        stop = time.perf_counter() + tr["trace_seconds"]
        while time.perf_counter() < stop:
            y = (x @ w).cpu()
            calls += 1
        tw.finish()
    run.trace_summary = tw.summary
    run.attempted = calls
    run.spans["call"] = spans
    run.info["calls"] = calls
    run.compared = _compare(x, w, y)


def small_cell(cell, use="run"):
    return dataclasses.replace(
        cell, config={**cell.config, "width": 16},
        traffic={**cell.traffic, "rows_per_call": 32, "trace_seconds": 0.1})


def check_config(config):
    assert config["dtype"] == "float64" and config["width"] > 0


def check_run(run, traced):
    assert run.info["calls"] == run.attempted >= len(run.spans["call"])


def control(cell, seed, device):
    x, w = _inputs(cell, seed, device)
    return _compare(x, w, (x.float() @ w.float()).double().cpu())
'''
TM_KEYS = {"preset", "n_classes", "n_clauses", "n_features", "n_states",
           "T", "s", "backend", "pdl", "include_density"}


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_toy_cell(root: Path, missing: str | None, stem: str = "toy"
                  ) -> str:
    """Add a cell of a new kind to the benchmark at ``root`` as new files
    and new ``BENCHMARK.json`` entries alone, its entry ``<stem>`` without
    the hook ``missing`` where given; return the cell's name."""
    bench = spec.load_benchmark(root)
    config, traffic = f"{stem}-256", f"{stem}-calls"
    name, metric = f"{config}.{traffic}", f"calls.{stem}"
    source = TOY_ENTRY + (f"\n\ndel {missing}\n" if missing else "")
    (root / f"portbench/entries/{stem}.py").write_text(source)
    (root / f"portbench/configs/{config}.json").write_text(json.dumps(
        {"width": 256, "dtype": "float64", "reduced": []}))
    (root / f"portbench/traffic/{traffic}.json").write_text(json.dumps(
        {"entry": stem, "rows_per_call": 64, "trace_seconds": 0.5}))
    (root / f"portbench/metrics/{metric}.py").write_text(
        "def read(run):\n    return run.info.get('calls')\n")
    bench["configs"].append({"name": config, "source": "a test",
                             "file": f"portbench/configs/{config}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"].append(name)
    bench["per_layer"].append({"name": metric, "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "rows_per_s",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return name


@pytest.mark.parametrize("missing", [None, *spec.ENTRY_HOOKS])
def test_a_cell_of_a_new_kind_is_files_alone(tmp_path, missing):
    """Copy the benchmark's files, then add a cell whose configuration
    holds no TM key and whose traffic names a new entry, as new files and
    new BENCHMARK.json entries: the cell goes through every check an
    accepted cell goes through, and no file that was there changes but
    BENCHMARK.json.  An entry that lacks a hook fails the contract,
    which names the entry and the hook."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    name = _add_toy_cell(tmp_path, missing)
    if missing:
        with pytest.raises(TypeError,
                           match=f"entry 'toy'.* lacks the hooks {missing} "):
            cellcheck.keeps_the_contract(spec.find_cell(name, tmp_path))
        return
    cell = cellcheck.found_from_files(name, tmp_path)
    assert not TM_KEYS & set(cell.config)
    assert cell.name in _cells(tmp_path)
    _keeps_to_its_contract(tmp_path)
    cellcheck.keeps_the_contract(cell)
    cellcheck.config_matches(cell)
    r = cellcheck.sound_run(cell, 2**31 + 7)
    assert r.cell.config["width"] == 16      # the entry shrank it
    traced = cellcheck.traced_run(cell, 2**31 + 7)
    assert harness.metrics(traced)["calls.toy"]["value"] == traced.attempted
    got = cellcheck.control_fails(cell, 11)
    assert got["row_error"][0] > 10 * got["row_error"][1]
    cellcheck.loads_no_jax(tmp_path, [name])
    after = _digests(tmp_path)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}


def _small_copy(tmp_path: Path) -> Path:
    """The benchmark's files under ``tmp_path``, its bulk traffic at a
    size a test can hold."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    traffic = tmp_path / "portbench/traffic/bulk.json"
    traffic.write_text(json.dumps({
        **json.loads(traffic.read_text()), "rows_per_call": 64,
        "pool_chunks": 2, "check_calls": 4, "check_stride": 1}))
    return tmp_path


@pytest.mark.parametrize("loads_repro", [False, True])
def test_a_reader_that_loads_the_jax_package_means_no_result(tmp_path,
                                                             loads_repro):
    """The check for JAX modules comes after every metric reader has loaded
    and read: a reader that imports a module named ``repro`` (a stub here)
    leaves the run with no result, and without the import the same run
    prints its line."""
    root = _small_copy(tmp_path / "bench")
    stub = tmp_path / "stub" / "repro"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    if loads_repro:
        (root / "portbench/metrics/setup_s.py").write_text(
            "import repro\n\n\ndef read(run):\n    return run.setup_s\n")
    code = (
        "import sys, torch\n"
        "sys.path[0:0] = [%r, %r, %r]\n"
        "from portbench import harness, spec\n"
        "find, run_cell = spec.find_cell, harness.run_cell\n"
        "spec.find_cell = lambda name: find(name, spec.Path(%r))\n"
        "harness.run_cell = lambda cell, seed, s, trace, device, t0: "
        "run_cell(cell, seed, s, trace, device=torch.device('cpu'), t0=t0)\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "torch.cuda.get_device_name = lambda i=0: 'cpu'\n"
        "sys.exit(harness.main(['--workload', 'tm-mnist-50.bulk', "
        "'--seed', '5', '--seconds', '0.2', '--trace', '0']))\n"
        % (str(ROOT), str(ROOT / "src"), str(tmp_path / "stub"), str(root)))
    env = {**os.environ, "TRITON_CACHE_DIR": str(tmp_path / "triton"),
           "TORCH_EXTENSIONS_DIR": str(tmp_path / "ext")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path, env=env)
    if loads_repro:
        assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
        assert "'repro'" in out.stderr, out.stderr
    else:
        assert out.returncode == 0, out.stderr
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and "setup_s" in line["metrics"]


@pytest.mark.parametrize("n_chunks", [1, 2, 8])
def test_the_sample_compares_every_chunk_over_the_whole_run(n_chunks):
    from portbench.entries.bulk import sample_plan
    samples = sample_plan(2**31 + 5, n_chunks, check_calls=16, stride=4)
    calls = 4000
    for i in range(calls):
        s, j = samples[i % n_chunks], i // n_chunks
        if s.wants(j):
            s.keep(j, i)
    kept = [i for s in samples for i in s.kept.values()]
    assert {i % n_chunks for i in kept} == set(range(n_chunks))
    assert len(kept) <= 16 + n_chunks and max(kept) > calls // 2


def test_reservoir_spreads_its_sample_over_the_whole_run():
    r = harness.Reservoir(capacity=4, stride=2, offset=1)
    for i in range(100):
        if r.wants(i):
            r.keep(i, i)
    kept = sorted(r.kept)
    assert 2 <= len(kept) <= 4 and kept[0] == 1 and kept[-1] > 50
    assert all((k - 1) % r.stride == 0 for k in kept)


@dataclasses.dataclass
class _Range:
    start: float
    end: float


@dataclasses.dataclass
class _Event:
    name: str
    start: float
    end: float
    device_type: object
    device_index: int = 0
    thread: int = 1
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return _Range(self.start, self.end)


def test_trace_summary_reads_busy_time_and_labels_idle_gaps():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        _Event("ProfilerStep#1", 0, 100, cpu),
        _Event("ProfilerStep#1", 0, 100, cuda, is_user_annotation=True),
        _Event("portbench.call", 55, 90, cpu),
        _Event("aten::where", 62, 68, cpu),
        _Event("kernel_a", 20, 50, cuda),
        _Event("kernel_a", 40, 60, cuda),     # overlaps: counted once busy
        _Event("Memcpy DtoH", 70, 80, cuda),
        _Event("kernel_b", 95, 120, cuda),    # clipped at the window's end
    ]
    t = summarize(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((40 + 10 + 5) * 1e-6)
    assert t.device_counts == {"kernel_a": 2, "Memcpy DtoH": 1,
                               "kernel_b": 1}
    assert t.device_ops["kernel_a"] == pytest.approx(50e-6)
    assert t.idle_by_host == pytest.approx(
        {"no host operation": 20e-6, "portbench.call > aten::where": 10e-6,
         "portbench.call": 15e-6})
