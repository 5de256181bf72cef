"""What a benchmark cell is, read from files alone.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics.  Everything else is
found by name under ``portbench/``:

- a configuration: ``configs/<config>.json``, the file ``BENCHMARK.json``
  gives for it;
- a traffic mix: ``traffic/<traffic>.json``, parameters read by the
  module its ``entry`` names (``entries/<entry>.py``), and
  ``trace_seconds``, the last part of the window a ``--trace 1`` run
  records;
- an entry: ``entries/<entry>.py``, which runs the traffic and provides
  every hook of :data:`ENTRY_HOOKS`;
- a metric: ``metrics/<metric name>.py``, whose ``read(run)`` returns the
  number or ``None`` where the run has nothing to read.

So a new cell, configuration, traffic mix, entry or metric is new files
and a new entry in ``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")

# What every entry module provides (portbench/README.md says what each
# does): the benchmark's run calls ``run``; the CPU tests
# (``portbench/tests/cellcheck.py``) and ``control.py`` call the others.
ENTRY_HOOKS = ("run", "small_cell", "check_config", "check_run", "control")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple       # metric entries this cell reports untraced
    per_layer: tuple        # metric entries this cell reports traced
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def check_name(name: str) -> str:
    """A name as ``BENCHMARK.json`` may use it, or ``ValueError``: it
    becomes part of a file's path."""
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def find_cell(name: str, root: Path = ROOT, bench: dict | None = None
              ) -> Cell:
    """The cell ``name`` of the benchmark at ``root`` (of ``bench`` in place
    of its ``BENCHMARK.json``, where given), or ``KeyError``."""
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"cells: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic_name = check_name(w["traffic"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{traffic_name}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=traffic_name, traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
        root=root)


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """``read(run)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{check_name(name)}.py"
    return _load(path, "portbench_metric_" + name.replace(".", "_")
                 .replace("-", "_")).read


def entry_module(name: str, root: Path = ROOT):
    """The module ``portbench/entries/<name>.py`` of the benchmark at
    ``root`` that runs a traffic entry, loaded once a process."""
    return _entry(check_name(name), Path(root).resolve())


@functools.cache
def _entry(name: str, root: Path):
    return _load(root / "portbench" / "entries" / f"{name}.py",
                 f"portbench_entry_{name}")


def check_entry(name: str, root: Path = ROOT):
    """The entry module ``name`` at ``root``, or ``TypeError`` naming the
    entry and each hook of :data:`ENTRY_HOOKS` it lacks."""
    mod = entry_module(name, root)
    missing = [h for h in ENTRY_HOOKS if not callable(getattr(mod, h, None))]
    if missing:
        raise TypeError(f"entry {name!r} (portbench/entries/{name}.py) lacks "
                        f"the hooks {', '.join(missing)} (portbench/README.md"
                        ", 'Adding a cell')")
    return mod
