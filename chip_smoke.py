#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA GPU: builds its CUDA kernels from this checkout, holds each
against its plain PyTorch version, and serves tm-mnist-50 through
``TMServer`` on both kernel-backed backends.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports nothing of JAX or of the JAX
package.  Phases, each on its own lines:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel build (one ``nvcc`` per source, all started together) and
   what ``ptxas`` reports per kernel;
3. kernels K1 (``swar_fused_votes``) and K3 (``clause_votes``) against
   their plain versions on the card, bitwise, at tm-mnist-50 widths
   (C=10, M=50, F=784) for B in {1, 37, 64, 4096} and at edge states
   (all-include, no-include, tied class sums); each kernel's median
   device time (CUDA events, launches queued behind a GPU spin so host
   overhead stays out), its plain version's time and its bound;
4. the main path: ``TMServer`` on cuda at tm-mnist-50 width, state at 5%
   include density from a seeded numpy generator through
   ``state_from_numpy``, once with ``backend="mxu_fused"`` (K3) and once
   with ``"swar_fused"`` (K1).  Eight concurrent clients send requests of
   1-16 rows, every third with a deadline; after the traffic every
   response must equal the port's ``oracle`` backend on the CPU, and the
   path's kernel counter (zeroed just before the traffic) must equal the
   number of batches served;
5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# tm-mnist-50 (src/repro/configs/tm_paper.py:16): C, M, F, T, s
C, M, F, T, S = 10, 50, 784, 5, 7.0
DENSITY = 0.05
SEED = 0
KERNEL_BATCHES = (1, 37, 64, 4096)
SERVE_BATCH = 64                  # largest serving bucket: the JSON shape
N_CLIENTS, PER_CLIENT = 8, 40
# H100 SXM published peaks (NVIDIA H100 datasheet, 700 W): HBM bytes/s,
# dense int8 tensor-core ops/s, float32 FLOP/s outside the tensor cores
HBM_BPS, INT8_OPS, FP32_FLOPS = 3.35e12, 1979e12, 67e12
# 32-bit integer results/s on the CUDA cores, scaled from the float32 peak
# by the per-SM throughputs for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instructions: 128 float32 FMA = 256 FLOP,
# 64 integer add / bitwise AND, 16 __popc per clock per SM)
INT32_OPS, POPC_OPS = FP32_FLOPS * 64 / 256, FP32_FLOPS * 16 / 256


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def device_ms(torch, fn, reps: int) -> float:
    """Median per-call device time (ms): ``reps`` calls queued behind a
    GPU spin, timed between two CUDA events, five rounds."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rounds = []
    for _ in range(5):
        torch.cuda._sleep(20_000_000)          # ~10 ms: the queue fills
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / reps)
    return statistics.median(rounds)


def bound(kernel: str, b: int) -> tuple[float, str]:
    """Least time (ms) the card could take for the kernel's work at batch
    ``b``: each input read once, the output written once, vs its
    operations at the peak rate of their type.  No data-dependent work:
    neither kernel exits early.  K1's popcounts and its integer adds /
    ANDs issue to different units, so its operation time is the larger
    of the two, not their sum."""
    lit, cm = 2 * F, C * M
    if kernel == "clause_votes":
        nbytes = b * lit + cm * lit + cm * C + 4 * b * C
        t_ops = (2 * b * cm * lit + 2 * b * cm * C) / INT8_OPS
    else:
        wl = -(-lit // 32)
        nbytes = 4 * b * wl + 4 * cm * wl + cm * C + 4 * b * C
        words = b * cm * wl                 # one AND, popc, add each
        t_ops = max(words / POPC_OPS,
                    (2 * words + 2 * b * cm * C) / INT32_OPS)
    t_bytes = nbytes / HBM_BPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def make_ta(rng, density: float) -> np.ndarray:
    return np.where(rng.random((C, M, 2 * F)) < density, 129, 128) \
        .astype(np.int32)


def check_kernels(torch, rt) -> dict:
    """Phase 3: bitwise kernel-vs-plain checks and timings → per-kernel
    {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"} at
    SERVE_BATCH."""
    pack_bits, make_vote_matrix = rt["pack_bits"], rt["make_vote_matrix"]
    rng = np.random.default_rng(SEED + 10)
    vm = make_vote_matrix(C, M, "cuda")
    tied = make_ta(rng, DENSITY)
    tied[1] = tied[2] = tied[0]
    states = {"density=0.05": make_ta(rng, DENSITY),
              "all-include": np.full((C, M, 2 * F), 129, np.int32),
              "no-include": np.full((C, M, 2 * F), 128, np.int32),
              "tied-sums": tied}
    err = {"clause_votes": 0, "swar_fused_votes": 0}
    for label, ta in states.items():
        inc = torch.as_tensor((ta > 128).astype(np.int8).reshape(C * M, -1),
                              device="cuda")
        inc_words = pack_bits(inc)
        for b in (KERNEL_BATCHES if label == "density=0.05" else (64,)):
            lits = rng.integers(0, 2, (b, 2 * F), dtype=np.int8)
            lits[0] = 1                    # all-include fires on this row
            lit = torch.as_tensor(lits, device="cuda")
            not_words = pack_bits(1 - lit)
            pairs = {
                "clause_votes": (rt["clause_votes"](lit, inc, vm),
                                 rt["clause_votes_plain"](lit, inc, vm)),
                "swar_fused_votes": (
                    rt["swar_fused_votes"](not_words, inc_words, vm),
                    rt["swar_fused_votes_plain"](not_words, inc_words, vm)),
            }
            torch.cuda.synchronize()
            line = []
            for name, (got, want) in pairs.items():
                if got.shape != (b, C) or got.dtype != torch.int32:
                    raise AssertionError(f"{name} returned {got.shape} "
                                         f"{got.dtype}")
                e = int((got.to(torch.int64) - want.to(torch.int64))
                        .abs().max())
                err[name] = max(err[name], e)
                if e != 0:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {label} B={b}: max "
                                         f"abs err {e}")
                line.append(f"{name} bitwise=True")
            print(f"check {label:13s} B={b:5d}: " + "  ".join(line),
                  flush=True)
    out = {}
    inc = torch.as_tensor((states["density=0.05"] > 128).astype(np.int8)
                          .reshape(C * M, -1), device="cuda")
    inc_words = pack_bits(inc)
    for b in (1, SERVE_BATCH, 4096):
        lit = torch.as_tensor(rng.integers(0, 2, (b, 2 * F), dtype=np.int8),
                              device="cuda")
        not_words = pack_bits(1 - lit)
        calls = {
            "clause_votes": (
                lambda: rt["clause_votes"](lit, inc, vm),
                lambda: rt["clause_votes_plain"](lit, inc, vm)),
            "swar_fused_votes": (
                lambda: rt["swar_fused_votes"](not_words, inc_words, vm),
                lambda: rt["swar_fused_votes_plain"](not_words, inc_words,
                                                     vm)),
        }
        for name, (kern, plain) in calls.items():
            ms = device_ms(torch, kern, reps=50)
            plain_ms = device_ms(torch, plain, reps=5)
            bound_ms, bound_by = bound(name, b)
            print(f"time  {name:16s} B={b:5d}: kernel {ms:.6f} ms  plain "
                  f"{plain_ms:.6f} ms  bound {bound_ms:.6f} ms "
                  f"({bound_by})", flush=True)
            if b == SERVE_BATCH:
                out[name] = {"max_abs_err": err[name], "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    return out


async def serve(torch, rt, backend: str, ta: np.ndarray) -> dict:
    """Phase 4: one TMServer run on cuda; every response checked against
    the CPU oracle → the run's stats and kernel launch counts."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.tm import TMConfig
    from repro_torch.engine import get_engine
    from repro_torch.serve import ServePolicy, TMServer

    cfg = TMConfig(n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    oracle = get_engine("oracle", cfg, state_from_numpy(ta, device="cpu"))
    server = TMServer(cfg, state_from_numpy(ta),
                      ServePolicy(max_batch=SERVE_BATCH, max_wait_us=500,
                                  backend=backend))
    answered = []

    async def client(cid: int) -> None:
        rng = np.random.default_rng(SEED + 100 + cid)
        for i in range(PER_CLIENT):
            lits = rng.integers(0, 2, (int(rng.integers(1, 17)), 2 * F),
                                dtype=np.int8)
            kw = {"deadline_us": 2_000_000} if i % 3 == 0 else {}
            res = await server.submit(lits, client=cid, **kw)
            answered.append((cid, i, lits, res))

    async with server:
        t0 = time.perf_counter()
        await server.warmup()
        warm = time.perf_counter() - t0
        rt["clause_votes"].launches = 0
        rt["swar_fused_votes"].launches = 0
        t0 = time.perf_counter()
        await asyncio.gather(*[client(c) for c in range(N_CLIENTS)])
        wall = time.perf_counter() - t0
        launches = {"clause_votes": rt["clause_votes"].launches,
                    "swar_fused_votes": rt["swar_fused_votes"].launches}
        stats = server.stats()
    # checked after the traffic, so the CPU oracle's work on the event
    # loop stays out of the measured latencies
    for cid, i, lits, res in answered:
        want = oracle.infer(lits)
        if not (np.array_equal(res.prediction, want.prediction.numpy())
                and np.array_equal(res.class_sums, want.class_sums.numpy())):
            raise AssertionError(f"{backend}: response differs from the "
                                 f"CPU oracle (client {cid}, request {i})")
    checked = len(answered)
    print(f"serve {backend:10s}: {checked} responses == CPU oracle in "
          f"{wall:.3f}s ({checked / wall:.0f} req/s, warmup {warm:.3f}s)  "
          f"batches={stats['batches']}  rows={stats['rows']}  "
          f"fill={stats['batch_fill']:.3f}  p50={stats['p50_ms']}ms  "
          f"p99={stats['p99_ms']}ms  deadline_misses="
          f"{stats['deadline']['misses']}/{stats['deadline']['requests']}  "
          f"launches={launches}", flush=True)
    print(f"serve {backend:10s} buckets: {json.dumps(stats['buckets'])}",
          flush=True)
    if checked != N_CLIENTS * PER_CLIENT or stats["errors"]:
        raise AssertionError(f"{backend}: {checked} checked, "
                             f"{stats['errors']} errors")
    return {"stats": stats, "launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.popcount import pack_bits
    from repro_torch.kernels import ops
    from repro_torch.kernels.clause_eval import (clause_votes,
                                                 clause_votes_plain,
                                                 make_vote_matrix)
    from repro_torch.kernels.swar_fused import (swar_fused_votes,
                                                swar_fused_votes_plain)
    rt = {"pack_bits": pack_bits, "make_vote_matrix": make_vote_matrix,
          "clause_votes": clause_votes,
          "clause_votes_plain": clause_votes_plain,
          "swar_fused_votes": swar_fused_votes,
          "swar_fused_votes_plain": swar_fused_votes_plain}

    card = smi("name,power.limit")
    print(card, flush=True)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  python "
          f"{sys.version.split()[0]}  devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    libs = ops.build_kernels()
    print(f"build: {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        notes = [ln.strip() for ln in (log.read_text().splitlines()
                                       if log.exists() else [])
                 if "registers" in ln or "spill" in ln]
        print(f"ptxas {name}: {' | '.join(notes) or '(cached build)'}",
              flush=True)

    kernels = check_kernels(torch, rt)
    print(f"clocks/power after timing: "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}", flush=True)

    ta = make_ta(np.random.default_rng(SEED), DENSITY)
    runs = {backend: asyncio.run(serve(torch, rt, backend, ta))
            for backend in ("mxu_fused", "swar_fused")}
    path_of = {"clause_votes": "mxu_fused", "swar_fused_votes": "swar_fused"}
    for name, backend in path_of.items():
        n = runs[backend]["launches"][name]
        if n <= 0 or n != runs[backend]["stats"]["batches"]:
            raise AssertionError(f"{backend} served "
                                 f"{runs[backend]['stats']['batches']} "
                                 f"batches but launched {name} {n} times")

    meta = {
        "swar_fused_votes": ("src/repro_torch/csrc/swar_fused.cu",
                             "src/repro/kernels/swar_fused.py:62",
                             "swar_fused_votes_pallas"),
        "clause_votes": ("src/repro_torch/csrc/clause_votes.cu",
                         "src/repro/kernels/clause_eval.py:64",
                         "clause_votes_pallas"),
    }
    rows = []
    for name, (source, replaces, pallas) in meta.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "pallas": pallas,
                     "launches": runs[path_of[name]]["launches"][name],
                     "max_abs_err": k["max_abs_err"], "bitwise": True,
                     "ms": k["ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": None, "batch": SERVE_BATCH})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
