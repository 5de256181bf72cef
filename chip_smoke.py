#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA GPU: builds its CUDA kernels from this checkout, holds each
against its plain PyTorch version, serves tm-mnist-50 through
``TMServer`` on both kernel-backed backends and on the paper's
``time_domain`` race, serves while it learns online through the
``fused`` train engine, drives the time-domain popcount and PDL race
kernels on the served state, and trains and runs the paper's BNN.

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
   then kernel K2 (``train_deltas_keyed``) the same way on the inputs a
   ``fused`` train step gives it (feedback masks and row keys from the
   threefry contract) for B in {1, 32, 37, 64, 512}, at the all-include
   and no-include states, with ``boost_tpf=False`` and with every mask
   off, timed at B in {32, 64};
   then the paper-surface kernels: K4 (``popcount_words``) at (1, 1),
   (37, 129) and (4096, 512) words with all-ones and all-zero rows, and
   K6 (``binary_matmul``) at (1, 784)x(784, 128), (37, 129)x(129, 65)
   and 1024^3, both bitwise; K5 (``pdl_race``) at (1, 10, 50),
   (37, 10, 50) and (1024, 10, 100), bitwise on integer-valued delays
   and within the stated tolerance on float delays, plus a tied-minimum
   row and C=1; timed at the ``benchmarks/kernel_bench.py`` shapes (K4
   4096x512, K5 B=1024 C=10 M=100, K6 1024^3; K6 also beside
   ``torch._int_mm``, cuBLASLt's int8 GEMM);
4. the main path: ``TMServer`` on cuda at tm-mnist-50 width, state at 5%
   include density from a seeded numpy generator through
   ``state_from_numpy``, once with ``backend="mxu_fused"`` (K3) and once
   with ``"swar_fused"`` (K1).  Eight concurrent clients send requests
   of 1-16 rows, every third with a deadline; after the traffic every
   response must equal the port's ``oracle`` backend on the CPU, and the
   path's kernel counter (zeroed just before the traffic) must equal the
   number of batches served;
5. serve and learn: ``TMServer`` on cuda with ``backend="mxu_fused"``,
   ``train_backend="fused"`` and ``train_seed=0``; the eight predict
   clients run while a feeder submits 16 teacher-labeled batches of 32
   rows one after another.  After the traffic the 16 batches replay on
   the CPU through the ``reference`` engine from the same key chain and
   every published state must equal its replay bitwise, every predict
   response must equal the CPU oracle under the state of the version it
   was pinned to, and the counters (zeroed just before the traffic) must
   show K2 = K1 = updates and K3 = predict batches;
6. the paper's time-domain race behind ``TMServer``: phase 4's traffic
   with ``backend="time_domain"`` (the ideal PDL race, plain tensor
   code) on the state phase 5 learned (the random state of phase 4 fires
   no clause, so every row would tie); every response must equal the
   CPU oracle and every ``latency_ps`` and ``metastable`` the port's CPU
   ``time_domain`` engine, on at least two distinct latencies;
7. the time-domain popcount on the learned state: the clause bits of
   1024 rows become PDL select bits; the ideal ``time_domain`` engine on
   cuda must equal the CPU engine bitwise (prediction, class sums,
   ``latency_ps``, ``metastable``); ``popcount.popcount_words`` (K4)
   counts each chain's low-net elements, which must equal the engine's
   class sums plus the opposing clauses, and ``pdl_race.pdl_race`` (K5)
   races the chains on a ``make_device(key(5), sigma_elem=2)`` device
   against ``core.time_domain.race`` on the same delays; counters zeroed
   before, read after;
8. the BNN: ``launch.bnn_popcount.run(device="cuda")`` trains the
   784-128-10 BNN and runs its int8 inference through K6, checked
   against an int32 matmul; K6's counter zeroed before, read after;
9. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
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
# online learning: labeled batches of the JAX launcher's --label-batch
# default; K2 is checked at these batches and timed at the first two
LABEL_BATCH, N_UPDATES = 32, 16
TRAIN_BATCHES = (32, 64, 1, 37, 512)
# integer operations per Type I word in K2: threefry2x32's 20 rounds
# (add, funnel-shift rotate, xor), 12 key injections and the output xor
# (csrc/threefry.cuh), then the shift and two threshold compares
K2_OPS_PER_WORD = 76
# H100 SXM published peaks (NVIDIA H100 datasheet, 700 W): HBM bytes/s,
# dense int8 tensor-core ops/s, float32 FLOP/s outside the tensor cores
HBM_BPS, INT8_OPS, FP32_FLOPS = 3.35e12, 1979e12, 67e12
# 32-bit integer results/s on the CUDA cores, scaled from the float32 peak
# by the per-SM throughputs for compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instructions: 128 float32 FMA = 256 FLOP,
# 64 integer add / bitwise AND, 16 __popc per clock per SM)
INT32_OPS, POPC_OPS = FP32_FLOPS * 64 / 256, FP32_FLOPS * 16 / 256
# float32 adds outside the tensor cores (an FMA counts as 2 FLOP)
FP32_ADDS = FP32_FLOPS / 2
# the paper-surface kernels' checked and timed shapes
# (benchmarks/kernel_bench.py: K4 4096x512, K5 B=1024 C=10 M=100, K6 1024^3)
K4_SHAPES = ((1, 1), (37, 129), (4096, 512))
K6_SHAPES = ((1, 784, 128), (37, 129, 65), (1024, 1024, 1024))
K5_SHAPES = ((1, 10, 50), (37, 10, 50), (1024, 10, 100))
T_RES = 10.0                      # PDLConfig().t_res, ps
K5_ROWS = 1024                    # served-state rows raced through K5


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
    # the time_domain responses' per-row aux, from the CPU engine
    td_cpu = (get_engine("time_domain", cfg,
                         state_from_numpy(ta, device="cpu"))
              if backend == "time_domain" else None)
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
        if td_cpu is not None:
            aux = td_cpu.infer(lits).aux
            for k in ("latency_ps", "metastable"):
                if not np.array_equal(res.aux[k], aux[k].numpy()):
                    raise AssertionError(
                        f"{backend}: aux {k} differs from the CPU "
                        f"time_domain engine (client {cid}, request {i})")
    checked = len(answered)
    print(f"serve {backend:10s}: {checked} responses == CPU oracle in "
          f"{wall:.3f}s ({checked / wall:.0f} req/s, warmup {warm:.3f}s)  "
          f"batches={stats['batches']}  rows={stats['rows']}  "
          f"fill={stats['batch_fill']:.3f}  p50={stats['p50_ms']}ms  "
          f"p99={stats['p99_ms']}ms  deadline_misses="
          f"{stats['deadline']['misses']}/{stats['deadline']['requests']}  "
          f"launches={launches}", flush=True)
    if td_cpu is not None:
        lat = np.concatenate([r.aux["latency_ps"] for *_, r in answered])
        meta = np.concatenate([r.aux["metastable"] for *_, r in answered])
        n_lat = np.unique(lat).size
        print(f"serve {backend:10s} aux: latency_ps == CPU time_domain "
              f"engine for {lat.size} rows ({n_lat} distinct; min "
              f"{lat.min():.1f}  median {np.median(lat):.1f}  max "
              f"{lat.max():.1f} ps)  metastable rate {meta.mean():.3f}",
              flush=True)
        if n_lat < 2:
            raise AssertionError(f"{backend}: every served row has one "
                                 f"latency; the state fires no clause")
    print(f"serve {backend:10s} buckets: {json.dumps(stats['buckets'])}",
          flush=True)
    if checked != N_CLIENTS * PER_CLIENT or stats["errors"]:
        raise AssertionError(f"{backend}: {checked} checked, "
                             f"{stats['errors']} errors")
    return {"stats": stats, "launches": launches}


def k2_inputs(torch, rt, cfg, ta: np.ndarray, b: int, seed: int,
              masks_on: bool = True) -> tuple:
    """K2's arguments as a ``fused`` train step builds them on the card:
    the class sums (plain K1), the feedback masks and per-row keys from
    the threefry contract (key on the CPU), the polarity routing."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 2, (b, 2 * F), dtype=np.int8),
                        device="cuda")
    y = torch.as_tensor(rng.integers(0, C, (b,)), device="cuda")
    inc8 = torch.as_tensor((ta > 128).astype(np.int8), device="cuda")
    votes = rt["swar_fused_votes_plain"](
        rt["pack_bits"](1 - x), rt["pack_bits"](inc8.reshape(C * M, -1)),
        rt["make_vote_matrix"](C, M, "cuda"))
    y_neg, fb_t, fb_n, k1s, k2s = rt["feedback_masks"](
        cfg, rt["prng"].key(seed), votes, y)
    pos = (rt["clause_polarity"](M, "cuda") > 0)[None, :]
    masks = [mk & masks_on for mk in
             rt["feedback_polarity_masks"](fb_t, fb_n, pos)]
    return (x, k1s, k2s, inc8, *masks, y, y_neg)


def k2_bound(args) -> tuple[float, str]:
    """Least time (ms) for K2's work on these inputs: each input read
    once and the (C, M, L) int32 output written once, vs the threefry
    words this run's masks select (m1_t / m1_n rows × L) at the integer
    rate.  Type II and the selection are not counted, so the bound
    stays a lower one."""
    x, k1s, k2s, inc8, m1_t, m2_t, m1_n, m2_n, y, y_neg = args
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * inc8.numel()
    words = int(m1_t.sum() + m1_n.sum()) * 2 * F
    t_ops = words * K2_OPS_PER_WORD / INT32_OPS
    t_bytes = nbytes / HBM_BPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_train_deltas(torch, rt) -> dict:
    """Phase 3b: kernel K2 bitwise against its plain version on the
    inputs of real fused steps, then timed → {"max_abs_err", "ms",
    "plain_ms", "bound_ms", "bound_by"} at LABEL_BATCH."""
    cfg = rt["TMConfig"](n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    rng = np.random.default_rng(SEED + 20)
    dense = make_ta(rng, DENSITY)
    cases = [(f"density={DENSITY}", dense, b, True, True)
             for b in TRAIN_BATCHES]
    cases += [("all-include", np.full((C, M, 2 * F), 129, np.int32),
               LABEL_BATCH, True, True),
              ("no-include", np.full((C, M, 2 * F), 128, np.int32),
               LABEL_BATCH, True, True),
              ("boost_tpf=False", dense, LABEL_BATCH, False, True),
              ("masks off", dense, LABEL_BATCH, True, False)]
    err, timed = 0, {}
    for i, (label, ta, b, boost, on) in enumerate(cases):
        args = k2_inputs(torch, rt, cfg, ta, b, SEED + 30 + i, on)
        kw = {"n_classes": C, "p_inc": 1.0 if boost else (S - 1) / S,
              "p_dec": 1 / S}
        got = rt["train_deltas_keyed"](*args, **kw)
        want = rt["train_deltas_keyed_plain"](*args, **kw)
        torch.cuda.synchronize()
        if got.shape != (C, M, 2 * F) or got.dtype != torch.int32:
            raise AssertionError(f"train_deltas_keyed returned {got.shape} "
                                 f"{got.dtype}")
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        err = max(err, e)
        if e != 0:
            raise AssertionError(f"train_deltas_keyed disagrees with its "
                                 f"plain version at {label} B={b}: max abs "
                                 f"err {e}")
        if bool(got.any()) != on:
            raise AssertionError(f"train_deltas_keyed at {label} B={b}: "
                                 f"nonzero={bool(got.any())}")
        words = int(args[4].sum() + args[6].sum()) * 2 * F
        print(f"check train_deltas {label:15s} B={b:4d}: bitwise=True  "
              f"type-I words={words}  |upd|={int(got.abs().sum())}",
              flush=True)
        if label.startswith("density") and b in TRAIN_BATCHES[:2]:
            ms = device_ms(torch, lambda: rt["train_deltas_keyed"](
                *args, **kw), reps=50)
            plain_ms = device_ms(torch, lambda: rt[
                "train_deltas_keyed_plain"](*args, **kw), reps=3)
            bound_ms, bound_by = k2_bound(args)
            print(f"time  train_deltas     B={b:5d}: kernel {ms:.6f} ms  "
                  f"plain {plain_ms:.6f} ms  bound {bound_ms:.6f} ms "
                  f"({bound_by}, {words} words)", flush=True)
            timed[b] = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
    out = timed[LABEL_BATCH]
    out["max_abs_err"] = err
    return out


async def serve_and_learn(torch, rt, ta: np.ndarray) -> dict:
    """Phase 5: predicts and labeled updates through one TMServer on
    cuda; every published state checked against the CPU reference replay
    and every response against the CPU oracle at its pinned version →
    stats, launch counts and update latencies."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.engine import get_engine, get_train_engine
    from repro_torch.serve import ServePolicy, TMServer

    prng = rt["prng"]
    cfg = rt["TMConfig"](n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    rng = np.random.default_rng(SEED + 3)
    feed = rng.integers(0, 2, (N_UPDATES, LABEL_BATCH, 2 * F), dtype=np.int8)
    teacher = get_engine("oracle", cfg, state_from_numpy(
        make_ta(np.random.default_rng(SEED + 2), DENSITY)))
    labels = [teacher.infer(lits).prediction.cpu().numpy() for lits in feed]
    published = {}
    server = TMServer(cfg, state_from_numpy(ta),
                      ServePolicy(max_batch=SERVE_BATCH, max_wait_us=500,
                                  backend="mxu_fused"),
                      train_backend="fused", train_seed=SEED,
                      history_size=N_UPDATES + 1,
                      on_publish=lambda v, st: published.setdefault(v, st))
    answered, update_s = [], []

    async def client(cid: int) -> None:
        crng = np.random.default_rng(SEED + 200 + cid)
        for i in range(PER_CLIENT):
            lits = crng.integers(0, 2, (int(crng.integers(1, 17)), 2 * F),
                                 dtype=np.int8)
            # submit pins the version current when it enqueues, with no
            # await in between while the queue has room
            version = server.state_version
            res = await server.submit(lits, client=cid)
            answered.append((version, cid, i, lits, res))

    async def feeder() -> list:
        versions = []
        for lits, y in zip(feed, labels):
            t0 = time.perf_counter()
            versions.append(await server.submit_labeled(lits, y))
            update_s.append(time.perf_counter() - t0)
        return versions

    async with server:
        t0 = time.perf_counter()
        await server.warmup(train_batches=(LABEL_BATCH,))
        warm = time.perf_counter() - t0
        for name in ("clause_votes", "swar_fused_votes",
                     "train_deltas_keyed"):
            rt[name].launches = 0
        t0 = time.perf_counter()
        versions, *_ = await asyncio.gather(
            feeder(), *[client(c) for c in range(N_CLIENTS)])
        wall = time.perf_counter() - t0
        launches = {name: rt[name].launches for name in
                    ("clause_votes", "swar_fused_votes",
                     "train_deltas_keyed")}
        stats = server.stats()
    if versions != list(range(1, N_UPDATES + 1)):
        raise AssertionError(f"learn: update versions {versions}")
    # checked after the traffic: the CPU replay and oracle stay off the
    # event loop the server shares
    t0 = time.perf_counter()
    ref = get_train_engine("reference", cfg)
    chain, state = prng.key(SEED), state_from_numpy(ta, device="cpu")
    replay = [state]
    for lits, y in zip(feed, labels):
        chain, k = prng.split(chain)
        state = ref.step(state, k, lits, y)
        replay.append(state)
    for v, want in enumerate(replay):
        if not torch.equal(published[v].ta.cpu(), want.ta):
            raise AssertionError(f"learn: published version {v} differs "
                                 f"from the CPU reference replay")
    replay_s = time.perf_counter() - t0
    oracles = {}
    for version, cid, i, lits, res in answered:
        if version not in oracles:
            oracles[version] = get_engine("oracle", cfg, replay[version])
        want = oracles[version].infer(lits)
        if not (np.array_equal(res.prediction, want.prediction.numpy())
                and np.array_equal(res.class_sums, want.class_sums.numpy())):
            raise AssertionError(f"learn: response differs from the CPU "
                                 f"oracle at version {version} (client "
                                 f"{cid}, request {i})")
    changed = int((replay[-1].ta != replay[0].ta).sum())
    lat = sorted(update_s)
    print(f"learn fused+mxu_fused: {N_UPDATES} updates x {LABEL_BATCH} rows "
          f"== CPU reference replay (replay {replay_s:.1f}s, {changed} TA "
          f"states changed); {len(answered)} responses == CPU oracle at "
          f"their versions ({len(oracles)} versions seen) in {wall:.3f}s "
          f"(warmup {warm:.3f}s)  batches={stats['batches']}  "
          f"fill={stats['batch_fill']:.3f}  p50={stats['p50_ms']}ms  "
          f"p99={stats['p99_ms']}ms  launches={launches}", flush=True)
    print(f"learn update latency ms (host clock around submit_labeled): "
          f"p50={statistics.median(lat) * 1e3:.3f}  "
          f"max={lat[-1] * 1e3:.3f}  all="
          f"{[round(t * 1e3, 3) for t in update_s]}", flush=True)
    if stats["errors"] or stats["updates"] != N_UPDATES or \
            len(answered) != N_CLIENTS * PER_CLIENT:
        raise AssertionError(f"learn: {stats['errors']} errors, "
                             f"{stats['updates']} updates, "
                             f"{len(answered)} responses")
    want_launches = {"train_deltas_keyed": N_UPDATES,
                     "swar_fused_votes": N_UPDATES,
                     "clause_votes": stats["batches"]}
    if launches != want_launches:
        raise AssertionError(f"learn: launches {launches}, expected "
                             f"{want_launches}")
    # where one update's time goes with no predict traffic: the fused step
    # on the card (host clock, ending in a stream sync) and, within it,
    # the key draws on the CPU
    fused, step_s, draw_s = get_train_engine("fused", cfg), [], []
    for i in range(10):
        k = prng.split(prng.key(i))[1]
        t0 = time.perf_counter()
        fused.step(published[N_UPDATES], k, feed[i], labels[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rt["feedback_draws"](cfg, k, LABEL_BATCH)
        draw_s.append(time.perf_counter() - t0)
    print(f"learn step alone ms (host clock, 10 steps): fused step "
          f"p50={statistics.median(step_s) * 1e3:.3f}  of which key draws "
          f"on the CPU p50={statistics.median(draw_s) * 1e3:.3f}",
          flush=True)
    return {"stats": stats, "launches": launches,
            "state": published[N_UPDATES]}


def timed_row(torch, name, kern, plain, nbytes, t_ops, label,
              library=None) -> dict:
    """Median device times of a kernel, its plain version and (where one
    PyTorch call computes the same function) that call, beside the bound
    — the larger of ``nbytes`` at the HBM rate and ``t_ops`` seconds of
    operations at their peak."""
    ms = device_ms(torch, kern, reps=50)
    plain_ms = device_ms(torch, plain, reps=5)
    library_ms = device_ms(torch, library, reps=50) if library else None
    t_bytes = nbytes / HBM_BPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    lib = "" if library_ms is None else f"  library {library_ms:.6f} ms"
    print(f"time  {name:16s} {label}: kernel {ms:.6f} ms  plain "
          f"{plain_ms:.6f} ms{lib}  bound {bound_ms:.6f} ms ({bound_by})",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def exact_err(torch, name, got, want, label) -> None:
    """Raise unless two integer tensors are equal in shape, type and
    every value."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} at {label}: {tuple(got.shape)} "
                             f"{got.dtype} vs plain {tuple(want.shape)} "
                             f"{want.dtype}")
    if not torch.equal(got, want):
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{label}: max abs err {e}")


def check_popcount(torch, rt) -> dict:
    """Phase 3c: K4 bitwise against its plain version, then timed."""
    rng = np.random.default_rng(SEED + 40)
    for r, w in K4_SHAPES:
        words = rng.integers(0, 2**32, (r, w), dtype=np.uint32)
        if r > 2:
            words[1] = 0xFFFFFFFF        # all-ones row: 32 * W
            words[2] = 0                 # all-zero row
        t = torch.as_tensor(words.view(np.int32), device="cuda")
        got = rt["popcount_words"](t)
        want = rt["popcount_words_plain"](t)
        torch.cuda.synchronize()
        exact_err(torch, "popcount_words", got, want, f"({r}, {w})")
        if r > 2 and (int(got[1]) != 32 * w or int(got[2]) != 0):
            raise AssertionError(f"popcount_words edge rows: {got[1:3]}")
        print(f"check popcount_words   ({r:4d}, {w:3d}) words: bitwise=True",
              flush=True)
    r, w = K4_SHAPES[-1]
    row = timed_row(torch, "popcount_words", lambda: rt["popcount_words"](t),
                    lambda: rt["popcount_words_plain"](t),
                    4 * r * w + 4 * r,
                    max(r * w / POPC_OPS, r * w / INT32_OPS), f"{r}x{w}")
    row["max_abs_err"] = 0
    return row


def check_binary_matmul(torch, rt) -> dict:
    """Phase 3c: K6 bitwise against its plain version, then timed beside
    ``torch._int_mm`` (cuBLASLt's int8 GEMM, the same function here)."""
    rng = np.random.default_rng(SEED + 50)
    for m, k, n in K6_SHAPES:
        x = torch.as_tensor(rng.choice([-1, 1], (m, k)).astype(np.int8),
                            device="cuda")
        w = torch.as_tensor(rng.choice([-1, 1], (k, n)).astype(np.int8),
                            device="cuda")
        got = rt["binary_matmul"](x, w)
        want = rt["binary_matmul_plain"](x, w)
        torch.cuda.synchronize()
        exact_err(torch, "binary_matmul", got, want, f"({m}, {k})x({k}, {n})")
        print(f"check binary_matmul    ({m:4d}, {k:4d})x({k:4d}, {n:4d}): "
              f"bitwise=True", flush=True)
    lib = torch._int_mm(x, w)
    torch.cuda.synchronize()
    if not torch.equal(lib, got):
        raise AssertionError("torch._int_mm disagrees with binary_matmul")
    row = timed_row(torch, "binary_matmul", lambda: rt["binary_matmul"](x, w),
                    lambda: rt["binary_matmul_plain"](x, w),
                    m * k + k * n + 4 * m * n, 2 * m * n * k / INT8_OPS,
                    f"{m}x{k}x{n}", library=lambda: torch._int_mm(x, w))
    row["max_abs_err"] = 0
    return row


def k5_inputs(torch, rng, b, c, m, *, integer: bool):
    sel = rng.integers(0, 2, (b, c, m), dtype=np.int8)
    if integer:
        ed = rng.integers(300, 700, (c, m, 2)).astype(np.float32)
        skew = rng.integers(-3, 4, (c,)).astype(np.float32)
    else:
        ed = rng.normal([[[384.5, 617.6]]], 5.0, (c, m, 2)).astype(np.float32)
        skew = rng.normal(0, 1, (c,)).astype(np.float32)
    return tuple(torch.as_tensor(a, device="cuda") for a in (sel, ed, skew))


def clear_rows(delays: np.ndarray, t_res: float) -> np.ndarray:
    """Rows whose race no float rounding can decide: every pair of
    arrivals more than 1e-3 ps apart, and the top gap more than 1e-3 ps
    from ``t_res``."""
    gaps = np.diff(np.sort(delays.astype(np.float64), -1), axis=-1)
    if gaps.shape[-1] == 0:
        return np.ones(delays.shape[0], bool)
    return (gaps.min(-1) > 1e-3) & (np.abs(gaps[:, 0] - t_res) > 1e-3)


def check_pdl_race(torch, rt) -> dict:
    """Phase 3c: K5 against its plain version — bitwise on integer-valued
    delays (exact in any summation order), and on float delays latency
    within rtol 1e-6 with winner and flag exact on the rows no rounding
    can decide — plus a tied minimum and C = 1; then timed."""
    rng = np.random.default_rng(SEED + 60)
    k5, plain = rt["pdl_race"], rt["pdl_race_plain"]
    lat_err = 0.0
    cases = [(shape, True) for shape in K5_SHAPES] + \
        [(shape, False) for shape in K5_SHAPES] + [((37, 1, 50), True)]
    for (b, c, m), integer in cases:
        args = k5_inputs(torch, rng, b, c, m, integer=integer)
        got = k5(*args, T_RES)
        want = plain(*args, T_RES)
        torch.cuda.synchronize()
        label = f"({b}, {c}, {m}) {'integer' if integer else 'float'}"
        if [t.dtype for t in got] != [torch.int32, torch.float32, torch.bool]:
            raise AssertionError(f"pdl_race dtypes {[t.dtype for t in got]}")
        if integer:
            for g, w_ in zip(got, want):
                if not torch.equal(g, w_):
                    raise AssertionError(f"pdl_race disagrees with its plain "
                                         f"version at {label}")
            if c == 1 and not (bool(got[2].all()) and int(got[0].max()) == 0):
                raise AssertionError("pdl_race C=1: expected gap 0, winner 0")
            note = "bitwise=True"
        else:
            err = float((got[1] - want[1]).abs().max())
            rel = float(((got[1] - want[1]).abs() / want[1].abs()).max())
            lat_err = max(lat_err, err)
            if rel > 1e-6:
                raise AssertionError(f"pdl_race latency at {label}: rel err "
                                     f"{rel}")
            sel, ed, skew = (a.cpu().numpy() for a in args)
            d = np.where(sel == 1, ed[None, :, :, 0], ed[None, :, :, 1]) \
                .astype(np.float64).sum(-1) + skew
            clear = clear_rows(d, T_RES)
            for i in (0, 2):
                if not np.array_equal(got[i].cpu().numpy()[clear],
                                      want[i].cpu().numpy()[clear]):
                    raise AssertionError(f"pdl_race output {i} at {label} "
                                         f"differs on a clear row")
            note = (f"latency max abs err {err:.3g} ps (rel {rel:.3g}, "
                    f"tol 1e-6); winner, metastable exact on "
                    f"{int(clear.sum())}/{b} clear rows")
        print(f"check pdl_race         {label}: {note}", flush=True)
    # classes 0 and 1 tie at 4 ps, class 2 at 400 ps: the kernel's gap runs
    # to the next distinct arrival (396 ps), so the row is not metastable
    sel = torch.ones((1, 3, 1), dtype=torch.int8, device="cuda")
    ed = torch.tensor([[[4.0, 4.0]], [[4.0, 4.0]], [[400.0, 400.0]]],
                      device="cuda")
    skew = torch.zeros(3, device="cuda")
    got = k5(sel, ed, skew, T_RES)
    want = plain(sel, ed, skew, T_RES)
    if not all(torch.equal(g, w_) for g, w_ in zip(got, want)) or \
            int(got[0][0]) != 0 or bool(got[2][0]):
        raise AssertionError(f"pdl_race tied minimum: {got}")
    print("check pdl_race         tied minimum: winner 0, not metastable "
          "== plain", flush=True)
    b, c, m = K5_SHAPES[-1]
    args = k5_inputs(torch, rng, b, c, m, integer=False)
    row = timed_row(torch, "pdl_race", lambda: k5(*args, T_RES),
                    lambda: plain(*args, T_RES),
                    b * c * m + 8 * c * m + 4 * c + 9 * b,
                    b * c * m / FP32_ADDS, f"B={b} C={c} M={m}")
    row["max_abs_err"] = lat_err
    return row


def time_domain_popcount(torch, rt, state) -> dict:
    """Phase 6: the clause bits of K5_ROWS rows under ``state`` (the last
    state the learn phase published, on cuda) as PDL select bits.  K4
    counts each chain's low-net elements (the Hamming weight the PDL
    turns into time), K5 races the chains on a physical device; counters
    zeroed before, read after → launches and rates."""
    from repro_torch.core import time_domain as td
    from repro_torch.core.popcount import pack_bits
    from repro_torch.core.tm import clause_outputs, clause_polarity
    from repro_torch.engine import get_engine

    cfg = rt["TMConfig"](n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    rng = np.random.default_rng(SEED + 70)
    lits = torch.as_tensor(rng.integers(0, 2, (K5_ROWS, 2 * F),
                                        dtype=np.int8), device="cuda")
    pol = clause_polarity(M, "cuda")
    clauses = clause_outputs(cfg, state, lits)              # (B, C, M)
    low_sel = td.low_select(clauses, pol).to(torch.int8).contiguous()
    pdl = td.PDLConfig(sigma_elem=2.0)
    dev = td.make_device(pdl, C, M, rt["prng"].key(5, device="cuda"))
    elem = torch.stack([pdl.d_low + dev.elem_offset[..., 0],
                        pdl.d_high + dev.elem_offset[..., 1]], -1) \
        .to(torch.float32).contiguous()
    words = pack_bits(low_sel.reshape(K5_ROWS * C, M))     # (B*C, ceil(M/32))
    ideal = get_engine("time_domain", cfg, state).infer(lits)
    cpu = get_engine("time_domain", cfg,
                     type(state)(state.ta.cpu())).infer(lits.cpu())
    for k, got, want in (
            ("prediction", ideal.prediction, cpu.prediction),
            ("class_sums", ideal.class_sums, cpu.class_sums),
            ("latency_ps", ideal.aux["latency_ps"], cpu.aux["latency_ps"]),
            ("metastable", ideal.aux["metastable"], cpu.aux["metastable"])):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"time_domain engine on cuda: {k} differs "
                                 f"from the CPU engine on the learned state")
    delays = td.pdl_delays(pdl, dev, clauses, pol)
    reference = td.race(pdl, delays)
    torch.cuda.synchronize()

    rt["popcount_words"].launches = 0
    rt["pdl_race"].launches = 0
    low_count = rt["popcount_words"](words).reshape(K5_ROWS, C)
    win, lat, meta = rt["pdl_race"](low_sel, elem, dev.skew, pdl.t_res)
    torch.cuda.synchronize()
    launches = {"popcount_words": rt["popcount_words"].launches,
                "pdl_race": rt["pdl_race"].launches}

    if not torch.equal(low_count, ideal.class_sums + M // 2):
        raise AssertionError("popcount_words low-net counts differ from the "
                             "time_domain engine's class sums + n_neg")
    if not torch.equal(low_count, low_sel.sum(-1, dtype=torch.int32)):
        raise AssertionError("popcount_words low-net counts differ from "
                             "the select bits' sum")
    rel = float(((lat - reference.latency).abs()
                 / reference.latency.abs()).max())
    if rel > 1e-6:
        raise AssertionError(f"pdl_race latency vs race: rel err {rel}")
    clear = clear_rows(delays.cpu().numpy(), 0.0)
    if not np.array_equal(win.cpu().numpy()[clear],
                          reference.winner.cpu().numpy()[clear]):
        raise AssertionError("pdl_race winner differs from race on a row "
                             "without near-ties")
    agree = float((win == ideal.prediction).float().mean())
    fire = float(clauses.float().mean())
    n_sums = int(ideal.class_sums.unique().numel())
    n_lat = int(ideal.aux["latency_ps"].unique().numel())
    print(f"time-domain popcount: {K5_ROWS} rows x {C} chains of {M} "
          f"elements under the learned state ({fire:.3f} of clauses fire, "
          f"{n_sums} distinct class sums, {n_lat} distinct latencies); "
          f"ideal engine on cuda == CPU engine (prediction, class sums, "
          f"latency_ps, metastable); K4 low-net counts == ideal "
          f"engine class sums + {M // 2}; K5 winner == race on "
          f"{int(clear.sum())}/{K5_ROWS} rows without near-ties, latency "
          f"rel err {rel:.3g} (tol 1e-6); metastable rate K5 (top gap < "
          f"t_res) {float(meta.float().mean()):.3f}, race (any arbiter) "
          f"{float(reference.metastable.float().mean()):.3f}; device "
          f"winner == ideal argmax on {agree:.3f} of rows  "
          f"launches={launches}", flush=True)
    for name, n in launches.items():
        if n != 1:
            raise AssertionError(f"time-domain popcount launched {name} "
                                 f"{n} times")
    return {"launches": launches}


def bnn_phase(torch, rt) -> dict:
    """Phase 7: the BNN entry point on cuda; K6's counter zeroed before,
    read after."""
    from repro_torch.launch.bnn_popcount import run
    rt["binary_matmul"].launches = 0
    t0 = time.perf_counter()
    out = run(device="cuda")
    torch.cuda.synchronize()
    launches = {"binary_matmul": rt["binary_matmul"].launches}
    print(f"bnn: {time.perf_counter() - t0:.2f}s  losses={out['losses']}  "
          f"test_acc={out['test_acc']}  time-domain agreement "
          f"{out['agreement']:.3f} accuracy {out['td_acc']:.3f}  "
          f"launches={launches}", flush=True)
    if launches["binary_matmul"] != 1 or out["h_shape"] != (120, 128):
        raise AssertionError(f"bnn: h {out['h_shape']}, launches "
                             f"{launches}")
    return {"launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import prng
    from repro_torch.core.popcount import pack_bits
    from repro_torch.core.tm import TMConfig, clause_polarity
    from repro_torch.core.tm_train import feedback_draws, feedback_masks
    from repro_torch.kernels import ops
    from repro_torch.kernels.clause_eval import (clause_votes,
                                                 clause_votes_plain,
                                                 make_vote_matrix)
    from repro_torch.kernels.swar_fused import (swar_fused_votes,
                                                swar_fused_votes_plain)
    from repro_torch.kernels.train_fused import (feedback_polarity_masks,
                                                 train_deltas_keyed,
                                                 train_deltas_keyed_plain)
    from repro_torch.kernels.binary_matmul import (binary_matmul,
                                                   binary_matmul_plain)
    from repro_torch.kernels.pdl_race import pdl_race, pdl_race_plain
    from repro_torch.kernels.popcount import (popcount_words,
                                              popcount_words_plain)
    rt = {"pack_bits": pack_bits, "make_vote_matrix": make_vote_matrix,
          "clause_votes": clause_votes,
          "clause_votes_plain": clause_votes_plain,
          "swar_fused_votes": swar_fused_votes,
          "swar_fused_votes_plain": swar_fused_votes_plain,
          "train_deltas_keyed": train_deltas_keyed,
          "train_deltas_keyed_plain": train_deltas_keyed_plain,
          "prng": prng, "TMConfig": TMConfig,
          "clause_polarity": clause_polarity,
          "feedback_draws": feedback_draws,
          "feedback_masks": feedback_masks,
          "feedback_polarity_masks": feedback_polarity_masks,
          "popcount_words": popcount_words,
          "popcount_words_plain": popcount_words_plain,
          "pdl_race": pdl_race, "pdl_race_plain": pdl_race_plain,
          "binary_matmul": binary_matmul,
          "binary_matmul_plain": binary_matmul_plain}

    t_start = time.perf_counter()
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
    kernels["train_deltas_keyed"] = check_train_deltas(torch, rt)
    kernels["popcount_words"] = check_popcount(torch, rt)
    kernels["binary_matmul"] = check_binary_matmul(torch, rt)
    kernels["pdl_race"] = check_pdl_race(torch, rt)
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
    learn = asyncio.run(serve_and_learn(torch, rt, ta))
    asyncio.run(serve(torch, rt, "time_domain",
                      learn["state"].ta.cpu().numpy()))
    slice_run = time_domain_popcount(torch, rt, learn["state"])
    bnn = bnn_phase(torch, rt)

    meta = {
        "swar_fused_votes": ("src/repro_torch/csrc/swar_fused.cu",
                             "src/repro/kernels/swar_fused.py:62",
                             "swar_fused_votes_pallas"),
        "clause_votes": ("src/repro_torch/csrc/clause_votes.cu",
                         "src/repro/kernels/clause_eval.py:64",
                         "clause_votes_pallas"),
        "train_deltas_keyed": ("src/repro_torch/csrc/train_deltas.cu",
                               "src/repro/kernels/train_fused.py:171",
                               "train_deltas_pallas"),
        "popcount_words": ("src/repro_torch/csrc/popcount_words.cu",
                           "src/repro/kernels/popcount.py:46",
                           "popcount_words_pallas"),
        "pdl_race": ("src/repro_torch/csrc/pdl_race.cu",
                     "src/repro/kernels/pdl_race.py:51", "pdl_race_pallas"),
        "binary_matmul": ("src/repro_torch/csrc/binary_matmul.cu",
                          "src/repro/kernels/binary_matmul.py:38",
                          "binary_matmul_pallas"),
    }
    launches = {name: runs[backend]["launches"][name]
                for name, backend in path_of.items()}
    launches["train_deltas_keyed"] = learn["launches"]["train_deltas_keyed"]
    launches.update(slice_run["launches"])
    launches.update(bnn["launches"])
    shape_of = {"swar_fused_votes": f"B={SERVE_BATCH}",
                "clause_votes": f"B={SERVE_BATCH}",
                "train_deltas_keyed": f"B={LABEL_BATCH}",
                "popcount_words": "{}x{}".format(*K4_SHAPES[-1]),
                "pdl_race": "B={} C={} M={}".format(*K5_SHAPES[-1]),
                "binary_matmul": "{}x{}x{}".format(*K6_SHAPES[-1])}
    rows = []
    for name, (source, replaces, pallas) in meta.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "pallas": pallas,
                     "launches": launches[name],
                     "max_abs_err": k["max_abs_err"],
                     "bitwise": name != "pdl_race",
                     "ms": k["ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k.get("library_ms"),
                     "shape": shape_of[name]})
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
