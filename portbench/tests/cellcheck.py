"""The checks every benchmark cell goes through on the CPU, each a function
of a cell (or a cell's name) and the root of the benchmark that holds it.
They reach what is particular to a cell only through the hooks of its
traffic entry (:data:`portbench.spec.ENTRY_HOOKS`), so a cell of a new
kind, added as new files and ``BENCHMARK.json`` entries, goes through
them unchanged: found from files, the entry's contract, its
configuration, a sound run, a traced run, the control failing, and a run
that loads no JAX module."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from portbench import control, harness, spec

CPU = torch.device("cpu")
SECONDS = 0.25


def entry(cell: spec.Cell):
    return spec.entry_module(cell.traffic["entry"], cell.root)


def found_from_files(name: str, root: Path) -> spec.Cell:
    """The cell ``name`` of the benchmark at ``root``, its configuration,
    traffic, entry and metric readers found by name."""
    cell = spec.find_cell(name, root)
    work = {w["name"]: w for w in spec.load_benchmark(root)["workloads"]}
    assert cell.config_name == work[name]["config"]
    assert entry(cell).run
    for m in (*cell.end_to_end, *cell.per_layer):
        assert callable(spec.metric_reader(m["name"], root))
    return cell


def keeps_the_contract(cell: spec.Cell) -> None:
    """The cell's entry provides every hook (``TypeError`` naming the entry
    and the hook otherwise) and its traffic names how long a traced run
    records."""
    spec.check_entry(cell.traffic["entry"], cell.root)
    assert cell.traffic["trace_seconds"] > 0


def config_matches(cell: spec.Cell) -> None:
    entry(cell).check_config(cell.config)


def sound_run(cell: spec.Cell, seed: int) -> harness.Run:
    """A whole untraced run of the cell at its entry's small size: correct,
    with every end-to-end metric it reports above 0 and the numbers
    compared last in its line."""
    r = harness.run_cell(entry(cell).small_cell(cell, "run"), seed, SECONDS,
                         False, device=CPU)
    assert r.correct and r.attempted > 0 and r.failed == 0, r.compared
    assert "sample_missing" in r.compared
    assert r.setup_s > 0 and r.window_s >= SECONDS
    entry(cell).check_run(r, False)
    got = harness.metrics(r)
    assert set(got) == {m["name"] for m in r.cell.end_to_end}
    assert all(v["value"] > 0 for v in got.values())
    line = harness.result_line(r, {"platform": "cpu"})
    assert list(line)[-1] == "compared"
    return r


def traced_run(cell: spec.Cell, seed: int) -> harness.Run:
    """A whole traced run: correct, its rate read over the untraced part
    before the profiler starts, every per-layer metric reported but the
    rooflines, which stay silent with no device operation traced."""
    small = entry(cell).small_cell(cell, "run")
    r = harness.run_cell(small, seed, SECONDS, True, device=CPU)
    assert r.correct and r.trace_summary is not None, r.compared
    # the rate is read over the untraced part, before the profiler starts
    assert SECONDS - small.traffic["trace_seconds"] <= r.window_s < SECONDS
    entry(cell).check_run(r, True)
    got = harness.metrics(r)
    # on the CPU no device operation is traced: the rooflines stay silent
    rooflines = {m["name"] for m in r.cell.per_layer
                 if m["name"].endswith("_roofline")}
    assert not rooflines & set(got)
    assert set(got) == {m["name"] for m in r.cell.per_layer} - rooflines
    line = harness.result_line(r, {"platform": "cpu"})
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    return r


def control_fails(cell: spec.Cell, seed: int) -> dict:
    """The control at the entry's small size comes out as not correct, on
    a sample that is not empty."""
    got = control.control(entry(cell).small_cell(cell, "control"), seed, CPU)
    assert any(v > lim for v, lim in got.values()), got
    assert not got["sample_missing"][0]
    return got


def loads_no_jax(root: Path, cells=(), also=()) -> None:
    """In a fresh process over the benchmark at ``root``: the harness, every
    entry module a traffic file names, every metric reader, the modules
    ``also`` names, and a short run of each of ``cells`` at its small size
    with its metrics read load no module whose top-level name is a JAX
    one, compared whole (``repro_torch`` is not ``repro``)."""
    code = (
        "import importlib, json, sys\n"
        "sys.path[0:0] = [%r, %r]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import portbench.harness, portbench.control, portbench.devtrace\n"
        "from portbench import harness, spec\n"
        "for p in sorted((spec.ROOT / 'portbench' / 'traffic')"
        ".glob('*.json')):\n"
        "    spec.check_entry(json.loads(p.read_text())['entry'])\n"
        "bench = spec.load_benchmark()\n"
        "for m in bench['per_layer'] + bench['end_to_end']:\n"
        "    spec.metric_reader(m['name'])\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "for name in %r:\n"
        "    cell = spec.find_cell(name)\n"
        "    small = spec.entry_module(cell.traffic['entry'])"
        ".small_cell(cell, 'run')\n"
        "    for trace in (False, True):\n"
        "        run = harness.run_cell(small, 5, 0.15, trace, "
        "device=torch.device('cpu'))\n"
        "        harness.metrics(run)\n"
        "print(harness.forbidden_modules())\n"
        % (str(root), str(spec.ROOT / "src"), tuple(also), tuple(cells)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
