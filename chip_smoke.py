#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA GPU: builds its CUDA kernels from this checkout, holds each
against its plain PyTorch version, serves tm-mnist-50 through
``TMServer`` on both kernel-backed backends, and serves while it learns
online through the ``fused`` train engine.

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
4. the main path: ``TMServer`` on cuda at tm-mnist-50 width, state at 5%
   include density from a seeded numpy generator through
   ``state_from_numpy``, once with ``backend="mxu_fused"`` (K3) and once
   with ``"swar_fused"`` (K1).  Eight concurrent clients send requests of
   1-16 rows, every third with a deadline; after the traffic every
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
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
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
    return {"stats": stats, "launches": launches}


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
          "feedback_polarity_masks": feedback_polarity_masks}

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
    }
    launches = {name: runs[backend]["launches"][name]
                for name, backend in path_of.items()}
    launches["train_deltas_keyed"] = learn["launches"]["train_deltas_keyed"]
    rows = []
    for name, (source, replaces, pallas) in meta.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "pallas": pallas,
                     "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "bitwise": True,
                     "ms": k["ms"], "plain_ms": k["plain_ms"],
                     "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": None,
                     "batch": LABEL_BATCH if name == "train_deltas_keyed"
                     else SERVE_BATCH})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
