"""Autotuner for the tunable VoteEngine backends (port of
``repro.engine.autotune``).

Sweeps each tunable backend's candidate grid per TM shape, times
``infer`` end to end on the chosen device and persists the winners to a
JSON cache: ``benchmarks/autotune_cache.json``, the JAX package's file,
unless ``REPRO_AUTOTUNE_CACHE`` names another.  ``get_engine``
consults :func:`lookup` on every build, so once a shape has been tuned
on a device kind every engine built for it there takes the
measured-best opts; explicitly passed opts always win.
``route_buckets`` reads the measured bucket → backend routes
(:func:`serve_lookup`) the same way.

Entries are keyed ``backend|C…|M…|L…|device_kind``.  The device kind is
the torch device type: ``cpu`` reads the entries the JAX package wrote on
the CPU, and ``cuda`` is a key of its own (a JAX run on a GPU keys
``gpu``, and its entries are Pallas tiles for another kernel).

:data:`SEARCH_SPACE` holds only what the port's engines take: the
``cascade``'s ``stage1_fraction``.  The JAX package's
``block_b``/``block_cm``/``block_m`` are TPU tiles with no counterpart
here, so :func:`lookup` drops them like any stale opt; with no train
entry, ``get_train_engine`` consults nothing.

The committed cache is the JAX package's; writes to it raise, so a sweep
needs ``REPRO_AUTOTUNE_CACHE`` pointed elsewhere:

    REPRO_AUTOTUNE_CACHE=/tmp/tune.json \\
        PYTHONPATH=src python -m repro_torch.engine.autotune --quick
    REPRO_AUTOTUNE_CACHE=/tmp/tune.json \\
        PYTHONPATH=src python -m repro_torch.engine.autotune --device cpu
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["SEARCH_SPACE", "cache_path", "device_kind", "shape_key",
           "lookup", "serve_key", "serve_lookup", "record_serve_routing",
           "autotune_backend", "run_sweep"]

# candidate opts per tunable backend; every combination is measured.
# Early-exit cascade: exits need a stage-1 margin >= the remainder size,
# so fractions below ~0.5 never pay off and the grid starts there.  The
# winner depends on the state's margins, so the sweep's random-state
# result is a default, not a guarantee.
SEARCH_SPACE: dict[str, dict[str, tuple]] = {
    "cascade": {"stage1_fraction": (0.5, 0.625, 0.75, 0.875)},
}

# the sweep's shapes and state density (the JAX package's
# benchmarks/engine_bench.py grid, which the port may not import)
F_FEATURES = 196
INCLUDE_DENSITY = 0.05
FULL_GRID = {"C": (4, 10, 16), "M": (64, 100, 256), "B": (32, 256)}
QUICK_GRID = {"C": (10,), "M": (100,), "B": (64,)}

_DEFAULT_CACHE = (Path(__file__).resolve().parents[3] / "benchmarks"
                  / "autotune_cache.json")
_loaded: dict = {}      # path → (mtime, parsed json)


def cache_path() -> Path:
    """The JSON cache file (``REPRO_AUTOTUNE_CACHE`` overrides default)."""
    return Path(os.environ.get("REPRO_AUTOTUNE_CACHE", _DEFAULT_CACHE))


def device_kind(device=None) -> str:
    """The device kind measurements are valid for: the torch device type
    (``cpu``, ``cuda``); ``None`` means cuda, the port's default."""
    return "cuda" if device is None else torch.device(device).type


def shape_key(backend: str, cfg, device=None) -> str:
    """Cache key for tuned opts: ``backend|C…|M…|L…|device_kind``."""
    return (f"{backend}|C{cfg.n_classes}|M{cfg.n_clauses}"
            f"|L{cfg.n_literals}|{device_kind(device)}")


def _load_cache() -> dict:
    path = cache_path()
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return {}
    cached = _loaded.get(str(path))
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        data = {}
    _loaded[str(path)] = (mtime, data)
    return data


def _writable_path() -> Path:
    """:func:`cache_path`, which a writer may change; the committed file
    is the JAX package's and is never written from here.  Writers call
    this before touching the loaded data (the parse is shared)."""
    path = cache_path()
    if path.resolve() == _DEFAULT_CACHE:
        raise RuntimeError(
            f"{path} is the JAX package's committed autotune cache; set "
            f"REPRO_AUTOTUNE_CACHE to another file to record measurements")
    return path


def _write_cache(path: Path, data: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    _loaded.pop(str(path), None)


def lookup(backend: str, cfg, device=None) -> dict:
    """Tuned constructor opts for (backend, cfg) on ``device``'s kind, or
    ``{}``; opts outside :data:`SEARCH_SPACE` are dropped."""
    if backend not in SEARCH_SPACE:
        return {}
    best = _load_cache().get("best", {}).get(
        shape_key(backend, cfg, device), {})
    return {k: v for k, v in best.items() if k in SEARCH_SPACE[backend]}


def serve_key(cfg, bucket: int, device=None) -> str:
    """Cache key for a measured bucket → backend serving route."""
    return (f"serve|C{cfg.n_classes}|M{cfg.n_clauses}"
            f"|L{cfg.n_literals}|B{bucket}|{device_kind(device)}")


def serve_lookup(cfg, bucket: int, device=None) -> str | None:
    """Measured-best backend for this TM shape at this bucket size on
    ``device``'s kind, or ``None`` when none was recorded."""
    return _load_cache().get("serve_best", {}).get(
        serve_key(cfg, bucket, device))


def record_serve_routing(cfg, routes: dict[int, str], device=None) -> None:
    """Persist measured bucket → backend routes into the cache, keyed as
    :func:`serve_lookup` reads them."""
    path = _writable_path()
    data = _load_cache()
    table = data.setdefault("serve_best", {})
    for bucket, backend in routes.items():
        table[serve_key(cfg, bucket, device)] = backend
    _write_cache(path, data)


def _time_us(fn, *args, repeat: int = 5) -> float:
    """Mean wall time (µs) of ``fn(*args)`` after one warm call, each
    call ending in a device synchronisation on cuda."""
    def call():
        res = fn(*args)
        if res.class_sums.device.type == "cuda":
            torch.cuda.synchronize(res.class_sums.device)

    call()
    t0 = time.perf_counter()
    for _ in range(repeat):
        call()
    return (time.perf_counter() - t0) / repeat * 1e6


def autotune_backend(backend: str, cfg, state, batches, *,
                     repeat: int = 5) -> tuple[dict, list[dict]]:
    """Sweep ``SEARCH_SPACE[backend]`` for one (cfg, state) on the
    state's device.  ``batches``: (B, L) literal tensors to measure over
    → (best opts, every measurement row)."""
    from .base import _VOTE_REGISTRY
    from . import backends  # noqa: F401  (registration side effect)
    names, grids = zip(*SEARCH_SPACE[backend].items())
    rows, best, best_us = [], {}, float("inf")
    for combo in itertools.product(*grids):
        params = dict(zip(names, combo))
        try:
            engine = _VOTE_REGISTRY.build(backend, cfg, state, **params)
            total = sum(_time_us(engine.infer, lits, repeat=repeat)
                        for lits in batches)
        except Exception as exc:      # an opt this shape cannot take
            rows.append({"backend": backend, **params, "error": str(exc)})
            continue
        rows.append({"backend": backend, **params,
                     "total_us": round(total, 1)})
        if total < best_us:
            best_us, best = total, params
    return best, rows


def run_sweep(*, quick: bool = False, backends: list[str] | None = None,
              repeat: int = 5, device=None) -> dict:
    """Tune every (tunable backend × grid shape) on ``device`` (``None``
    → cuda); return the cache dict, also written to :func:`cache_path`
    (which must not be the committed file)."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.tm import TMConfig
    from repro_torch.kernels.ops import resolve_device

    path = _writable_path()
    dev = resolve_device(device)
    grid = QUICK_GRID if quick else FULL_GRID
    names = [b for b in (backends or sorted(SEARCH_SPACE))
             if b in SEARCH_SPACE]
    rng = np.random.default_rng(0)
    data = _load_cache()
    data.setdefault("best", {})
    data["include_density"] = INCLUDE_DENSITY
    # keyed like "best", so a rerun replaces a shape's rows; the device
    # kind is in the key, so cpu and cuda entries coexist
    measurements = data.setdefault("measurements", {})
    for c in grid["C"]:
        for m in grid["M"]:
            cfg = TMConfig(n_classes=c, n_clauses=m, n_features=F_FEATURES)
            ta = np.where(rng.random((c, m, cfg.n_literals))
                          < INCLUDE_DENSITY, cfg.n_states + 1, cfg.n_states)
            st = state_from_numpy(ta, device=dev)
            batches = [torch.as_tensor(
                rng.integers(0, 2, (b, cfg.n_literals), dtype=np.int8),
                device=dev) for b in grid["B"]]
            for backend in names:
                best, rows = autotune_backend(backend, cfg, st, batches,
                                              repeat=repeat)
                key = shape_key(backend, cfg, dev)
                data["best"][key] = best
                measurements[key] = rows
                print(f"{key}: best={best}")
    _write_cache(path, data)
    print(f"wrote {path}")
    return data


def main(argv: list[str] | None = None) -> None:
    """CLI entry point: run the sweep (see the module docstring)."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="one grid shape per backend")
    ap.add_argument("--backends", nargs="*", default=None,
                    help=f"subset of {sorted(SEARCH_SPACE)}")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    run_sweep(quick=args.quick, backends=args.backends, repeat=args.repeat,
              device=args.device)


if __name__ == "__main__":
    main()
