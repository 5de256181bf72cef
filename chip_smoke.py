#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA GPU: builds its CUDA kernels from this checkout, holds each
against its plain PyTorch version, serves tm-mnist-50 through
``TMServer`` on both kernel-backed backends and on the paper's
``time_domain`` race, serves while it learns online through the
``fused`` train engine and, with default routing, through ``sparse_csr``
and the ``sparse`` train engine, drives the time-domain popcount and PDL
race kernels on the served state, trains and runs the paper's BNN, kills,
restores and rolls back a learning server through checkpoints, serves
through the early-exit cascade as the overload shed tier, and serves a
multi-tenant ``TMFleet`` of 69 models packed into fused planes and, as
the control, each model solo.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports nothing of JAX or of the JAX
package.  Phases, each on its own lines:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel build (one ``nvcc`` per source, all started together) and
   what ``ptxas`` reports per kernel; then ``cuobjdump -sass`` of K3's and
   K6's libraries, which must hold integer tensor-core MMA instructions
   (``IMMA``) and no ``IDP`` (``__dp4a``);
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
   off, timed at B in {32, 64, 512}; then the device kernels one K1 call
   (B=64) and one K2 call (B=32, the fused step's int64 labels) run, from
   ``torch.profiler``'s trace of the card (each must be one kernel and no
   memset where the profiler sees the card);
   then K1 at 3,000 classes (B = 1 and 64, timed at 64) and K2 at
   6,200 classes (B = 33), past the class counts whose whole class axis
   fits a block's shared memory (the class-tiled and per-item paths),
   bitwise; then (3f) K3 and K1 at the fleet's fused shape (640 classes
   of M=50, F=784) for B in {1, 64} on a 0.2% and a 5% include state,
   bitwise, timed at B=64 on each state beside their plain versions
   and bounds (the bounds count only the vote-matrix rows of clauses
   that fire on the timed batch: none on the 5% state);
   then the paper-surface kernels: K4 (``popcount_words``) at (1, 1),
   (37, 129) and (4096, 512) words with all-ones and all-zero rows, and
   K6 (``binary_matmul``) at (1, 784)x(784, 128), (37, 129)x(129, 65),
   the BNN's (120, 784)x(784, 128) and 1024^3, both bitwise; K5
   (``pdl_race``) at (1, 10, 50), (37, 10, 50) and (1024, 10, 100),
   bitwise on integer-valued delays and within the stated tolerance on
   float delays, at its design edges (``K5_EDGES``) bitwise, plus a
   tied-minimum row, 64 rows of ties and C=1; timed at the
   ``benchmarks/kernel_bench.py`` shapes (K4
   4096x512, K5 B=1024 C=10 M=100, K6 1024^3) and K6 also at the BNN's
   120x784x128, both K6 shapes beside ``torch._int_mm``, cuBLASLt's int8
   GEMM;
4. the main path: ``TMServer`` on cuda at tm-mnist-50 width, state at 5%
   include density from a seeded numpy generator through
   ``state_from_numpy``, once with ``backend="mxu_fused"`` (K3), once
   with ``"swar_fused"`` (K1) and once with no ``backend=``, where the
   density heuristic routes every bucket to ``sparse_csr`` (no kernel).  Eight concurrent clients send requests
   of 1-16 rows, every third with a deadline; after the traffic every
   response must equal the port's ``oracle`` backend on the CPU, and the
   path's kernel counter (zeroed just before the traffic) must equal the
   number of batches served (0 for ``sparse_csr``);
5. serve and learn: ``TMServer`` on cuda with ``backend="mxu_fused"``,
   ``train_backend="fused"`` and ``train_seed=0``; the eight predict
   clients run while a feeder submits 16 teacher-labeled batches of 32
   rows one after another.  After the traffic the 16 batches replay on
   the CPU through the ``reference`` engine from the same key chain and
   every published state must equal its replay bitwise, every predict
   response must equal the CPU oracle under the state of the version it
   was pinned to, and the counters (zeroed just before the traffic) must
   show K2 = K1 = updates and K3 = predict batches;
5b. serve and learn on default routing: the same traffic through a
   ``TMServer`` built without ``backend=``, with ``train_backend=
   "sparse"``: the 5% state routes every bucket to ``sparse_csr`` (the
   ELL gather, plain tensor code) and deltas go through K2 alone.  The
   same replay and oracle checks; the counters must show K2 = updates
   and K1 = K3 = 0; ``stats()["sparse_layout"]`` and the per-bucket
   service times are printed;
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
9. the state lifecycle: a cuda ``TMServer`` (``mxu_fused``, ``fused``
   training, ``train_seed=0``, checkpoints every 4 versions in a
   temporary directory, 2 kept, a history ring of 2) takes 8 of phase
   5's labeled batches under the predict clients and stops; a fresh
   cuda server ``restore()``s (with another ``train_seed``: the saved
   cursor must drive the chain) and takes the other 8, then rolls back
   to version 12, which only the disk holds, and serves it.  Every
   published version must equal the CPU ``reference`` replay of the 16
   batches on one key chain, every response the CPU oracle at its
   pinned version, the newest manifest must read back through the port's
   msgpack reader with ``dtypes == ["uint32", "int32"]`` and the JAX
   ``treedef``, and the counters (zeroed just before each server's
   traffic) must show K2 = K1 = updates and K3 = predict batches; the
   host-clock times of a blocking ``checkpoint()`` and of the
   ``restore()`` are printed;
10. the shed tier: a cuda ``TMServer`` with ``backend="mxu_fused"``,
   ``shed_backend="cascade"``, ``shed_qdepth=0`` and
   ``shed_opts={"full_backend": "mxu_fused"}`` serves phase 4's traffic
   on the learned state (predictions, and escalated rows' sums, == CPU
   oracle), then the indicator machine of ``tests/test_cascade.py`` at
   full width with its one-hot rows (no row may escalate), then phase
   4's traffic through ``routing={b: "cascade"}`` with exact sums (== the
   oracle's class sums), and the indicator machine's rows that way too
   (its settled rows take the exact-sums completion pass).  In each run K1 = stage-1 + completion passes
   and K3 = escalated sub-batches (0 when routed: the default escalation
   backend ``swar_packed`` has no kernel); ``stats()["tiers"]`` and
   request p50/p99 are printed;
11. the multi-tenant fleet: a cuda ``TMFleet`` with
   ``ServePolicy(max_batch=64, max_wait_us=500, backend="mxu_fused")``
   over 64 tm-mnist-50 members (one pack group of 640 classes), 4
   tm-mnist-100 members (a group of 40) and a tm-iris-50 model (solo),
   each on its own seeded state (0.2% includes for the tm-mnist
   members, 5% for tm-iris-50: densities at which random rows fire
   clauses); two tm-mnist-50 members learn
   (``train_backend="fused"``, their own ``train_seed``), 8
   teacher-labeled batches of 32 rows each, while 16 closed-loop clients
   send 1-16-row requests whose model is drawn Zipf-skewed (exponent
   1.1), every third with a deadline.  Every response must equal the CPU
   oracle of its model under the member version its request pinned,
   every published member version the CPU ``reference`` replay of its
   key chain; in each model family at least half the response rows must
   carry nonzero class sums and the predictions must differ; and the
   counters (zeroed just before the traffic) must show K3 = the batches
   the group planes and the solo model served and K2 = K1 = updates.  The same traffic then runs with ``pack=False``
   and 80 engine-cache entries (the control arm: under-filled launches,
   not cache thrash at the default 16); both arms print K3 launches per
   1,000 requests, rows per batch, batch fill, request p50/p99 and the
   device worker's busy time (host clock around each of its calls);
12. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# default; K2 is checked at these batches and timed at K2_TIMED
LABEL_BATCH, N_UPDATES = 32, 16
TRAIN_BATCHES = (32, 64, 1, 37, 512)
K2_TIMED = (32, 64, 512)
# integer operations per Type I word in K2: threefry2x32's 20 rounds
# (add, funnel-shift rotate, xor), 12 key injections and the output xor
# (csrc/threefry.cuh), then the shift and two threshold compares.  The 20
# rotations, 21 XORs and the shift issue only to the integer ALU pipe (64
# per clock per SM: INT32_OPS); the adds and compares can go to the FMA
# pipe too (IMAD), so an SM issues at most 2 x 64 of them per clock
K2_OPS_PER_WORD, K2_ALU_OPS_PER_WORD = 76, 42
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
# K6: the last two are timed; the BNN's one launch (launch/bnn_popcount.py:
# 120 rows of 784 inputs into 128 hidden units) is the main path's shape
K6_SHAPES = ((1, 784, 128), (37, 129, 65), (120, 784, 128),
             (1024, 1024, 1024))
K6_MAIN = (120, 784, 128)
K5_SHAPES = ((1, 10, 50), (37, 10, 50), (1024, 10, 100))
# K5's design edges: B = 1 at the timed width, M off 4 and 16 (rows start
# unaligned), 40 classes (lanes walk several), C * M past shared memory
# (tables and rows read from global memory), more rows than the grid's
# warps
K5_EDGES = ((1, 10, 100), (33, 10, 7), (16, 40, 9), (3, 100, 200),
            (5000, 4, 6))
# past the class counts whose whole class axis fits a block's shared
# memory: K1 at 3,000 classes (M = 1, two class tiles of the serving
# tile), K2 at 6,200 classes (M = 2; include bits staged per item)
K1_MANY_C, K2_MANY_C = 3000, 6200
T_RES = 10.0                      # PDLConfig().t_res, ps
K5_ROWS = 1024                    # served-state rows raced through K5
# phase 11, the multi-tenant fleet: 64 tm-mnist-50 members pack into one
# plane of 640 classes (FLEET_C, the shape phase 3f checks and times K1
# and K3 at), 4 tm-mnist-100 members (src/repro/configs/tm_paper.py:17:
# M=100, s=10.0) into one of 40, and one tm-iris-50 model (:15: C=3,
# M=50, F=12, T=7, s=6.5) serves solo.  The first FLEET_LEARNERS
# tm-mnist-50 members learn, FLEET_UPDATES labeled batches each.  16
# closed-loop clients draw each request's model Zipf-skewed (exponent
# FLEET_ZIPF over a seeded ranking): a few hot models, most trickling
FLEET_M50, FLEET_M100 = 64, 4
# the tm-mnist members' include density: a clause then holds about three
# literals and a random row fires about a fifth of the clauses, so class
# sums are far from zero and differ between classes (at 5% none fires)
FLEET_DENSITY = 0.002
FLEET_C = FLEET_M50 * C
FLEET_LEARNERS, FLEET_UPDATES = 2, 8
FLEET_CLIENTS, FLEET_PER_CLIENT = 16, 40
FLEET_ZIPF = 1.1
# the control arm's engine-cache entries: every solo model's engine fits,
# so it measures under-filled launches and not cache thrash at the
# default budget of 16
FLEET_SOLO_CACHE = 80


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def device_ms(fn, reps: int) -> float:
    """Median per-call device time (ms) of ``fn``, by the port's timer
    (``repro_torch.kernels.ops.device_ms``: ``reps`` calls queued behind a
    GPU spin, between two CUDA events, five rounds)."""
    from repro_torch.kernels.ops import device_ms as timed
    return timed(fn, reps)


def bound(kernel: str, b: int, fired: int,
          c: int = C) -> tuple[float, str]:
    """Least time (ms) the card could take for the kernel's work at batch
    ``b`` and ``c`` classes of M clauses: each input read once — of the
    (C·M, C) int8 vote matrix only the ``fired`` rows of clauses that fire
    on some row of this batch, the rest being needed by no vote — and the
    output written once, vs its operations at the peak rate of their
    type.  Neither kernel exits early.  K3: the int8 violation product on
    the tensor cores; K1: a clause fires iff every word of inc &
    not-literal is zero, so one three-input logic op (acc | a & b) per
    (row, clause, word) computes it.  The adds that fold fired clauses
    into votes are not counted, so the bound stays a lower one."""
    lit, cm = 2 * F, c * M
    if kernel == "clause_votes":
        nbytes = b * lit + cm * lit + fired * c + 4 * b * c
        t_ops = 2 * b * cm * lit / INT8_OPS
    else:
        wl = -(-lit // 32)
        nbytes = 4 * b * wl + 4 * cm * wl + fired * c + 4 * b * c
        t_ops = b * cm * wl / INT32_OPS
    t_bytes = nbytes / HBM_BPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fired_clauses(torch, lit, inc) -> int:
    """How many clauses (rows of ``inc``, and of the vote matrix) fire on
    some row of the {0,1} literals ``lit``: none of their included
    literals is 0.  The float32 products of 0/1 values and their sums
    (at most 2F) are exact."""
    viol = (1 - lit).float() @ inc.float().T
    return int((viol == 0).any(0).sum())


def make_ta(rng, density: float, c: int = C, m: int = M,
            f: int = F) -> np.ndarray:
    return np.where(rng.random((c, m, 2 * f)) < density, 129, 128) \
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
        fired = fired_clauses(torch, lit, inc)
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
            ms = device_ms(kern, reps=50)
            plain_ms = device_ms(plain, reps=5)
            bound_ms, bound_by = bound(name, b, fired)
            print(f"time  {name:16s} B={b:5d}: kernel {ms:.6f} ms  plain "
                  f"{plain_ms:.6f} ms  bound {bound_ms:.6f} ms "
                  f"({bound_by}; {fired} of {C * M} vote rows read)",
                  flush=True)
            if b == SERVE_BATCH:
                out[name] = {"max_abs_err": err[name], "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by}
    return out


def random_rows(rng) -> np.ndarray:
    """Phase 4's requests: 1-16 random literal rows."""
    return rng.integers(0, 2, (int(rng.integers(1, 17)), 2 * F),
                        dtype=np.int8)


def cascade_passes(server) -> dict:
    """Summed ``passes`` of the cascade engines serving ``server``'s
    buckets (routed or shed tier): stage-1 and completion passes (one K1
    call each) and escalated sub-batches."""
    engines = {}
    for b in server.buckets:
        tier = [server.shed_engine_for(b)] \
            if server.policy.shed_backend else []
        for eng in [server.engine_for(b)] + tier:
            if hasattr(eng, "passes"):
                engines[id(eng)] = eng
    total = dict.fromkeys(("stage1", "completion", "escalation"), 0)
    for eng in engines.values():
        for k in total:
            total[k] += eng.passes[k]
    return total


async def serve(torch, rt, backend, ta: np.ndarray, *, label=None,
                policy_kw=None, routing=None, make_lits=random_rows,
                exact_sums=True) -> dict:
    """Phases 4 and 10: one TMServer run on cuda (``backend=None``:
    default routing; ``policy_kw`` / ``routing`` add the shed tier or
    routed cascades); every response checked against the CPU oracle —
    predictions, and class sums where the path computes them exactly
    (``exact_sums``; else on escalated rows only) → the run's stats,
    kernel launch counts, cascade passes and routes."""
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
                                  backend=backend, **(policy_kw or {})),
                      routing=routing)
    answered = []
    routes = set(server.routing.values())
    label = label or backend or \
        "default(" + "/".join(sorted(routes)) + ")"

    async def client(cid: int) -> None:
        rng = np.random.default_rng(SEED + 100 + cid)
        for i in range(PER_CLIENT):
            lits = make_lits(rng)
            kw = {"deadline_us": 2_000_000} if i % 3 == 0 else {}
            res = await server.submit(lits, client=cid, **kw)
            answered.append((cid, i, lits, res))

    async with server:
        t0 = time.perf_counter()
        await server.warmup()
        warm = time.perf_counter() - t0
        rt["clause_votes"].launches = 0
        rt["swar_fused_votes"].launches = 0
        passes0 = cascade_passes(server)
        t0 = time.perf_counter()
        await asyncio.gather(*[client(c) for c in range(N_CLIENTS)])
        wall = time.perf_counter() - t0
        launches = {"clause_votes": rt["clause_votes"].launches,
                    "swar_fused_votes": rt["swar_fused_votes"].launches}
        passes = {k: n - passes0[k]
                  for k, n in cascade_passes(server).items()}
        stats = server.stats()
    # checked after the traffic, so the CPU oracle's work on the event
    # loop stays out of the measured latencies
    for cid, i, lits, res in answered:
        want = oracle.infer(lits)
        sums = want.class_sums.numpy()
        if not exact_sums:
            esc = res.aux["escalated"]
            res_sums, sums = res.class_sums[esc], sums[esc]
        else:
            res_sums = res.class_sums
        if not (np.array_equal(res.prediction, want.prediction.numpy())
                and np.array_equal(res_sums, sums)):
            raise AssertionError(f"{label}: response differs from the "
                                 f"CPU oracle (client {cid}, request {i})")
        if td_cpu is not None:
            aux = td_cpu.infer(lits).aux
            for k in ("latency_ps", "metastable"):
                if not np.array_equal(res.aux[k], aux[k].numpy()):
                    raise AssertionError(
                        f"{label}: aux {k} differs from the CPU "
                        f"time_domain engine (client {cid}, request {i})")
    checked = len(answered)
    print(f"serve {label:10s}: {checked} responses == CPU oracle in "
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
        print(f"serve {label:10s} aux: latency_ps == CPU time_domain "
              f"engine for {lat.size} rows ({n_lat} distinct; min "
              f"{lat.min():.1f}  median {np.median(lat):.1f}  max "
              f"{lat.max():.1f} ps)  metastable rate {meta.mean():.3f}",
              flush=True)
        if n_lat < 2:
            raise AssertionError(f"{label}: every served row has one "
                                 f"latency; the state fires no clause")
    print(f"serve {label:10s} buckets: {json.dumps(stats['buckets'])}",
          flush=True)
    if checked != N_CLIENTS * PER_CLIENT or stats["errors"]:
        raise AssertionError(f"{label}: {checked} checked, "
                             f"{stats['errors']} errors")
    return {"stats": stats, "launches": launches, "routes": routes,
            "passes": passes}


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
    words this run's masks select (m1_t / m1_n rows × L): their ALU-only
    operations at the ALU rate, or all their operations at twice it,
    whichever is longer.  Type II and the selection are not counted, so
    the bound stays a lower one."""
    x, k1s, k2s, inc8, m1_t, m2_t, m1_n, m2_n, y, y_neg = args
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * inc8.numel()
    words = int(m1_t.sum() + m1_n.sum()) * 2 * F
    t_ops = words * max(K2_ALU_OPS_PER_WORD,
                        K2_OPS_PER_WORD / 2) / INT32_OPS
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
        if label.startswith("density") and b in K2_TIMED:
            ms = device_ms(lambda: rt["train_deltas_keyed"](
                *args, **kw), reps=50)
            plain_ms = device_ms(lambda: rt[
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


def device_kernels(torch, fn) -> list:
    """The device activities (kernels, memsets, copies) one call of ``fn``
    puts on the card, by name, from ``torch.profiler``'s trace; empty
    where the profiler traces no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def check_class_tiles(torch, rt) -> None:
    """Phase 3e: K1 and K2 past the class counts whose whole class axis
    fits a block's shared memory, bitwise against their plain versions at
    tm-mnist-50's literal width: K1 at K1_MANY_C classes for B in (1, 64)
    and timed at B = 64, K2 at K2_MANY_C classes and B = 33, timed."""
    rng = np.random.default_rng(SEED + 90)
    c = K1_MANY_C
    inc = torch.as_tensor((rng.random((c, 2 * F)) < 0.002)
                          .astype(np.int8), device="cuda")
    vm = torch.as_tensor(rng.integers(-3, 4, (c, c)).astype(np.int8),
                         device="cuda")
    inc_words = rt["pack_bits"](inc)
    for b in (1, SERVE_BATCH):
        lit = torch.as_tensor(rng.integers(0, 2, (b, 2 * F), dtype=np.int8),
                              device="cuda")
        not_words = rt["pack_bits"](1 - lit)
        got = rt["swar_fused_votes"](not_words, inc_words, vm)
        want = rt["swar_fused_votes_plain"](not_words, inc_words, vm)
        torch.cuda.synchronize()
        exact_err(torch, "swar_fused_votes", got, want, f"C={c} B={b}")
        if not bool(want.any()):
            raise AssertionError(f"swar_fused_votes C={c}: no clause fired")
        print(f"check swar_fused_votes C={c} M=1 B={b:3d}: bitwise=True",
              flush=True)
    ms = device_ms(lambda: rt["swar_fused_votes"](not_words, inc_words, vm),
                   reps=20)
    plain_ms = device_ms(lambda: rt["swar_fused_votes_plain"](
        not_words, inc_words, vm), reps=3)
    print(f"time  swar_fused_votes C={c} M=1 B={SERVE_BATCH}: kernel "
          f"{ms:.6f} ms  plain {plain_ms:.6f} ms", flush=True)
    c, m, b = K2_MANY_C, 2, 33
    lits = torch.as_tensor(rng.integers(0, 2, (b, 2 * F), dtype=np.int8),
                           device="cuda")
    keys = rt["prng"].bits(rt["prng"].key(SEED + 91), (2, b, 2)).cuda()
    inc8 = torch.as_tensor((rng.random((c, m, 2 * F)) < 0.02)
                           .astype(np.int8), device="cuda")
    masks = [torch.as_tensor(rng.random((b, m)) < 0.5, device="cuda")
             for _ in range(4)]
    y = rng.integers(0, c, (b,))
    y_neg = (y + rng.integers(1, c, (b,))) % c
    args = (lits, keys[0], keys[1], inc8, *masks,
            torch.as_tensor(y, device="cuda"),
            torch.as_tensor(y_neg, device="cuda"))
    kw = {"n_classes": c, "p_inc": (S - 1) / S, "p_dec": 1 / S}
    got = rt["train_deltas_keyed"](*args, **kw)
    want = rt["train_deltas_keyed_plain"](*args, **kw)
    torch.cuda.synchronize()
    exact_err(torch, "train_deltas_keyed", got, want, f"C={c} B={b}")
    if not bool(got.any()):
        raise AssertionError(f"train_deltas_keyed C={c}: a zero update")
    ms = device_ms(lambda: rt["train_deltas_keyed"](*args, **kw), reps=5)
    plain_ms = device_ms(lambda: rt["train_deltas_keyed_plain"](*args, **kw),
                         reps=2)
    print(f"check train_deltas C={c} M={m} B={b}: bitwise=True  "
          f"|upd|={int(got.abs().sum())}  kernel {ms:.6f} ms  plain "
          f"{plain_ms:.6f} ms", flush=True)


def check_fleet_shape(torch, rt) -> dict:
    """Phase 3f: K3 and K1 at the fleet's fused shape (FLEET_C classes of
    tm-mnist-50's M and F), bitwise against their plain versions for B in
    (1, SERVE_BATCH) on the fleet members' FLEET_DENSITY include state (a
    random row fires about a fifth of the clauses) and on a 5% one (on
    which a random row fires none), each timed at SERVE_BATCH beside its
    bound → {kernel: {"density=<d>": timing row}}."""
    rng = np.random.default_rng(SEED + 95)
    c = FLEET_C
    vm = rt["make_vote_matrix"](c, M, "cuda")
    out = {"clause_votes": {}, "swar_fused_votes": {}}
    for density in (FLEET_DENSITY, DENSITY):
        inc = torch.as_tensor((rng.random((c * M, 2 * F)) < density)
                              .astype(np.int8), device="cuda")
        inc_words = rt["pack_bits"](inc)
        for b in (1, SERVE_BATCH):
            lit = torch.as_tensor(rng.integers(0, 2, (b, 2 * F),
                                               dtype=np.int8),
                                  device="cuda")
            not_words = rt["pack_bits"](1 - lit)
            pairs = {
                "clause_votes": (rt["clause_votes"](lit, inc, vm),
                                 rt["clause_votes_plain"](lit, inc, vm)),
                "swar_fused_votes": (
                    rt["swar_fused_votes"](not_words, inc_words, vm),
                    rt["swar_fused_votes_plain"](not_words, inc_words,
                                                 vm)),
            }
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                exact_err(torch, name, got, want,
                          f"C={c} B={b} density={density}")
            if density == FLEET_DENSITY and not bool(
                    pairs["clause_votes"][1].any()):
                raise AssertionError(f"fleet shape C={c}: no vote cast")
            print(f"check fleet shape C={c} M={M} B={b:3d} density="
                  f"{density}: clause_votes bitwise=True  swar_fused_votes "
                  f"bitwise=True", flush=True)
        # timed on the last (B = SERVE_BATCH) inputs
        fired = fired_clauses(torch, lit, inc)
        for name, kern, plain in (
                ("clause_votes", lambda: rt["clause_votes"](lit, inc, vm),
                 lambda: rt["clause_votes_plain"](lit, inc, vm)),
                ("swar_fused_votes",
                 lambda: rt["swar_fused_votes"](not_words, inc_words, vm),
                 lambda: rt["swar_fused_votes_plain"](not_words, inc_words,
                                                      vm))):
            ms = device_ms(kern, reps=50)
            plain_ms = device_ms(plain, reps=5)
            bound_ms, bound_by = bound(name, SERVE_BATCH, fired, c)
            print(f"time  {name:16s} C={c} B={SERVE_BATCH} density="
                  f"{density}: kernel {ms:.6f} ms  plain {plain_ms:.6f} ms"
                  f"  bound {bound_ms:.6f} ms ({bound_by}; {fired} of "
                  f"{c * M} vote rows read)", flush=True)
            out[name][f"density={density}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "vote_rows_read": fired}
    return out


def profile_launches(torch, rt) -> dict:
    """Phase 3d: the device activities of one K1 call (B=SERVE_BATCH) and
    of one K2 call (B=LABEL_BATCH on a fused step's inputs, int64 labels
    included) → {name: count, or None where the profiler traced no
    device activity}.  Each must be one kernel and no memset wherever the
    profiler traces the card."""
    rng = np.random.default_rng(SEED + 80)
    ta = make_ta(rng, DENSITY)
    inc = torch.as_tensor((ta > 128).astype(np.int8).reshape(C * M, -1),
                          device="cuda")
    lit = torch.as_tensor(rng.integers(0, 2, (SERVE_BATCH, 2 * F),
                                       dtype=np.int8), device="cuda")
    k1 = (rt["pack_bits"](1 - lit), rt["pack_bits"](inc),
          rt["make_vote_matrix"](C, M, "cuda"))
    cfg = rt["TMConfig"](n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    k2 = k2_inputs(torch, rt, cfg, ta, LABEL_BATCH, SEED + 81)
    kw = {"n_classes": C, "p_inc": 1.0, "p_dec": 1 / S}
    counts = {}
    for name, fn in (
            ("swar_fused_votes", lambda: rt["swar_fused_votes"](*k1)),
            ("train_deltas_keyed",
             lambda: rt["train_deltas_keyed"](*k2, **kw))):
        acts = device_kernels(torch, fn)
        # None, not 0, where the profiler saw nothing of the card
        counts[name] = len(acts) if acts else None
        print(f"profile {name}: "
              + (f"{len(acts)} device activities per call: {acts}" if acts
                 else "the profiler traced no device activity"), flush=True)
        if acts and (len(acts) != 1 or
                     any("memset" in a.lower() for a in acts)):
            raise AssertionError(f"{name}: one call ran {acts}, not one "
                                 f"kernel")
    return counts


def label_feed(rt, cfg) -> tuple:
    """Phase 5's labeled stream: N_UPDATES batches of LABEL_BATCH random
    rows, labeled by a fixed teacher machine (seed SEED + 2) → (feed,
    labels)."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.engine import get_engine
    rng = np.random.default_rng(SEED + 3)
    feed = rng.integers(0, 2, (N_UPDATES, LABEL_BATCH, 2 * F), dtype=np.int8)
    teacher = get_engine("oracle", cfg, state_from_numpy(
        make_ta(np.random.default_rng(SEED + 2), DENSITY)))
    return feed, [teacher.infer(lits).prediction.cpu().numpy()
                  for lits in feed]


def reference_replay(rt, cfg, ta: np.ndarray, feed, labels,
                     seed: int = SEED) -> list:
    """The CPU ``reference`` engine over the labeled stream on one key
    chain from ``prng.key(seed)`` → [state_0, ..., state_N] on the CPU."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.engine import get_train_engine
    prng, ref = rt["prng"], get_train_engine("reference", cfg)
    chain, state = prng.key(seed), state_from_numpy(ta, device="cpu")
    replay = [state]
    for lits, y in zip(feed, labels):
        chain, k = prng.split(chain)
        state = ref.step(state, k, lits, y)
        replay.append(state)
    return replay


async def serve_and_learn(torch, rt, ta: np.ndarray, *, backend,
                          train_backend: str, expect) -> dict:
    """Phases 5 and 5b: predicts and labeled updates through one TMServer
    on cuda (``backend=None``: default routing); every published state
    checked against the CPU reference replay and every response against
    the CPU oracle at its pinned version; the kernel counters, zeroed
    just before the traffic, must equal ``expect(stats)`` → stats, launch
    counts and update latencies."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.engine import get_engine, get_train_engine
    from repro_torch.serve import ServePolicy, TMServer

    prng = rt["prng"]
    cfg = rt["TMConfig"](n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    feed, labels = label_feed(rt, cfg)
    published = {}
    server = TMServer(cfg, state_from_numpy(ta),
                      ServePolicy(max_batch=SERVE_BATCH, max_wait_us=500,
                                  backend=backend),
                      train_backend=train_backend, train_seed=SEED,
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
        routes = set(server.routing.values())
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
    replay = reference_replay(rt, cfg, ta, feed, labels)
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
    tag = f"{train_backend}+{backend or '/'.join(sorted(routes))}"
    print(f"learn {tag}: {N_UPDATES} updates x {LABEL_BATCH} rows "
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
    print(f"learn {tag} routing={stats['routing']}  routing_updates="
          f"{stats['routing_updates']}  sparse_layout="
          f"{json.dumps(stats['sparse_layout'])}", flush=True)
    print(f"learn {tag} buckets: {json.dumps(stats['buckets'])}",
          flush=True)
    want_launches = expect(stats)
    if launches != want_launches:
        raise AssertionError(f"learn: launches {launches}, expected "
                             f"{want_launches}")
    # where one update's time goes with no predict traffic: the step on
    # the card (host clock, ending in a stream sync) and, within it, the
    # key draws on the CPU
    engine, step_s, draw_s = get_train_engine(train_backend, cfg), [], []
    for i in range(10):
        k = prng.split(prng.key(i))[1]
        t0 = time.perf_counter()
        engine.step(published[N_UPDATES], k, feed[i], labels[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rt["feedback_draws"](cfg, k, LABEL_BATCH)
        draw_s.append(time.perf_counter() - t0)
    print(f"learn step alone ms (host clock, 10 steps): {train_backend} "
          f"step p50={statistics.median(step_s) * 1e3:.3f}  of which key "
          f"draws on the CPU p50={statistics.median(draw_s) * 1e3:.3f}",
          flush=True)
    return {"stats": stats, "launches": launches, "routes": routes,
            "state": published[N_UPDATES]}


async def lifecycle(torch, rt, ta: np.ndarray, directory: str) -> dict:
    """Phase 9: kill, restart and roll back a learning cuda TMServer
    (``mxu_fused`` serving, ``fused`` training) through checkpoints in
    ``directory``: server A takes phase 5's first 8 labeled batches under
    the predict clients and stops (its snapshots); a fresh server B
    restores and takes the other 8, then rolls back to a version only the
    disk holds.  Every published state must equal the CPU reference
    replay on one key chain, every response the CPU oracle at its pinned
    version; the counters (zeroed just before each server's traffic) must
    show K2 = K1 = updates and K3 = predict batches."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint._msgpack import unpackb
    from repro_torch.convert import state_from_numpy
    from repro_torch.engine import get_engine
    from repro_torch.serve import ServePolicy, TMServer

    cfg = rt["TMConfig"](n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    feed, labels = label_feed(rt, cfg)
    half = N_UPDATES // 2
    published, answered, update_s = [], [], []
    names = ("clause_votes", "swar_fused_votes", "train_deltas_keyed")
    launches = collections.Counter()
    batches = 0

    def server(seed: int):
        return TMServer(cfg, state_from_numpy(ta),
                        ServePolicy(max_batch=SERVE_BATCH, max_wait_us=500,
                                    backend="mxu_fused"),
                        train_backend="fused", train_seed=seed,
                        checkpoint_dir=directory, checkpoint_every_updates=4,
                        checkpoint_keep=2, history_size=2,
                        on_publish=lambda v, st: published.append((v, st)))

    async def client(srv, cid: int, n: int) -> None:
        rng = np.random.default_rng(SEED + 300 + cid)
        for i in range(n):
            lits = random_rows(rng)
            version = srv.state_version
            res = await srv.submit(lits, client=cid)
            answered.append((version, cid, i, lits, res))

    async def traffic(srv, lo: int, hi: int) -> list:
        nonlocal batches
        for name in names:
            rt[name].launches = 0
        n0 = srv.stats()["batches"]

        async def feeder() -> list:
            versions = []
            for i in range(lo, hi):
                t0 = time.perf_counter()
                versions.append(await srv.submit_labeled(feed[i], labels[i]))
                update_s.append(time.perf_counter() - t0)
            return versions

        versions, *_ = await asyncio.gather(
            feeder(), *[client(srv, c, PER_CLIENT // 2)
                        for c in range(N_CLIENTS)])
        launches.update({name: rt[name].launches for name in names})
        batches += srv.stats()["batches"] - n0
        return versions

    async def first() -> list:
        async with server(SEED) as srv:
            await srv.warmup(train_batches=(LABEL_BATCH,))
            return await traffic(srv, 0, half)

    t0 = time.perf_counter()
    versions = await first()        # the server stops: its snapshots land
    srv = server(SEED + 1)          # the restored cursor, not this seed
    t1 = time.perf_counter()
    restored = srv.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    if restored != half or srv.state.ta.device.type != "cuda":
        raise AssertionError(f"lifecycle: restored version {restored} on "
                             f"{srv.state.ta.device}")
    async with srv:
        await srv.warmup(train_batches=(LABEL_BATCH,))
        versions += await traffic(srv, half, N_UPDATES)
        ckpt.wait_for_complete(directory, 12, timeout=60)
        if 12 in srv.history_versions:
            raise AssertionError(f"lifecycle: the ring {srv.history_versions}"
                                 f" still holds version 12")
        for name in names:
            rt[name].launches = 0
        n0 = srv.stats()["batches"]
        rolled = srv.rollback(12)
        await asyncio.gather(*[client(srv, c, 4) for c in range(N_CLIENTS)])
        launches.update({name: rt[name].launches for name in names})
        stats = srv.stats()
        batches += stats["batches"] - n0
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    srv.checkpoint(os.path.join(directory, "blocking"))
    checkpoint_s = time.perf_counter() - t1
    if versions != list(range(1, N_UPDATES + 1)) or rolled != N_UPDATES + 1:
        raise AssertionError(f"lifecycle: versions {versions}, rollback "
                             f"{rolled}")
    replay = reference_replay(rt, cfg, ta, feed, labels)
    replay.append(replay[12])       # the rollback republished version 12
    for v, st in published:
        if not torch.equal(st.ta.cpu(), replay[v].ta):
            raise AssertionError(f"lifecycle: published version {v} differs "
                                 f"from the CPU reference replay")
    if sorted({v for v, _ in published}) != list(range(N_UPDATES + 2)):
        raise AssertionError(f"lifecycle: published "
                             f"{sorted({v for v, _ in published})}")
    oracles = {}
    for version, cid, i, lits, res in answered:
        if version not in oracles:
            oracles[version] = get_engine("oracle", cfg, replay[version])
        want = oracles[version].infer(lits)
        if not (np.array_equal(res.prediction, want.prediction.numpy())
                and np.array_equal(res.class_sums, want.class_sums.numpy())):
            raise AssertionError(f"lifecycle: response differs from the CPU "
                                 f"oracle at version {version} (client "
                                 f"{cid}, request {i})")
    if not any(v == N_UPDATES + 1 for v, *_ in answered):
        raise AssertionError("lifecycle: no response served the rollback")
    step = ckpt.latest_step(directory)
    with open(os.path.join(directory, f"step_{step}", "manifest.msgpack"),
              "rb") as f:
        manifest = unpackb(f.read())
    if manifest["dtypes"] != ["uint32", "int32"] or \
            manifest["treedef"] != "PyTreeDef({'cursor': *, 'ta': *})" or \
            manifest["extra"]["train_backend"] != "fused":
        raise AssertionError(f"lifecycle: manifest {manifest}")
    want_launches = {"clause_votes": batches, "swar_fused_votes": N_UPDATES,
                     "train_deltas_keyed": N_UPDATES}
    if dict(launches) != want_launches:
        raise AssertionError(f"lifecycle: launches {dict(launches)}, "
                             f"expected {want_launches}")
    print(f"lifecycle fused+mxu_fused: {N_UPDATES} updates across a kill/"
          f"restore at version {half} == CPU reference replay; "
          f"{len(answered)} responses == CPU oracle at their versions "
          f"({len(oracles)} versions seen) in {wall:.3f}s; rollback(12) "
          f"from disk -> version {rolled}; steps on disk "
          f"{ckpt.valid_steps(directory)}; manifest dtypes "
          f"{manifest['dtypes']} treedef {manifest['treedef']}  "
          f"launches={dict(launches)}  p50={stats['p50_ms']}ms  "
          f"p99={stats['p99_ms']}ms", flush=True)
    print(f"lifecycle host clock: blocking checkpoint() "
          f"{checkpoint_s * 1e3:.3f} ms, restore() {restore_s * 1e3:.3f} ms "
          f"of the ({C}, {M}, {2 * F}) int32 state; update latency around "
          f"submit_labeled p50={statistics.median(update_s) * 1e3:.3f} ms "
          f"max={max(update_s) * 1e3:.3f} ms, versions 4, 8, 12, 16 (each "
          f"snapshotted): {[round(update_s[v - 1] * 1e3, 3) for v in (4, 8, 12, 16)]}"
          f" ms", flush=True)
    return {"launches": dict(launches), "checkpoint_ms": checkpoint_s * 1e3,
            "restore_ms": restore_s * 1e3}


def indicator_machine() -> tuple:
    """The wide-margin machine of ``tests/test_cascade.py`` at tm-mnist-50
    width: class k's +clauses include x_k, its -clauses not-x_k → (ta,
    its C one-hot rows)."""
    ta = np.full((C, M, 2 * F), 128, np.int32)
    for k in range(C):
        ta[k, 0::2, k] = 129
        ta[k, 1::2, F + k] = 129
    rows = np.zeros((C, 2 * F), np.int8)
    rows[np.arange(C), np.arange(C)] = 1
    rows[:, F:] = 1 - rows[:, :F]
    return ta, rows


async def shed_tier(torch, rt, ta: np.ndarray) -> dict:
    """Phase 10: the overload tier on cuda.  Phase 4's traffic on the
    learned state through ``shed_backend="cascade"`` at ``shed_qdepth=0``
    (escalation on ``mxu_fused``), then the indicator machine's one-hot
    rows (every row must settle), then the same traffic through
    ``routing={b: "cascade"}`` with exact sums.  Predictions (and every
    exact sum) == CPU oracle; K1 = stage-1 + completion passes, K3 =
    escalated sub-batches."""
    from repro_torch.serve import default_buckets
    tier = {"shed_backend": "cascade", "shed_qdepth": 0,
            "shed_opts": {"full_backend": "mxu_fused"}}
    ind_ta, onehot = indicator_machine()
    routed = {b: "cascade" for b in default_buckets(SERVE_BATCH)}

    def onehot_rows(rng):
        return onehot[rng.integers(0, C, int(rng.integers(1, 17)))]

    runs = {
        "shed": await serve(torch, rt, "mxu_fused", ta, label="shed tier",
                            policy_kw=tier, exact_sums=False),
        "indicator": await serve(torch, rt, "mxu_fused", ind_ta,
                                 label="shed indicator", policy_kw=tier,
                                 make_lits=onehot_rows, exact_sums=False),
        "routed": await serve(torch, rt, None, ta, label="routed cascade",
                              routing=routed),
        # the exact-sums completion pass runs only on rows that settle
        "routed indicator": await serve(
            torch, rt, None, ind_ta, label="routed indicator",
            routing=routed, make_lits=onehot_rows),
    }
    for name, run in runs.items():
        st, passes, got = run["stats"], run["passes"], run["launches"]
        tiers = st["tiers"]
        shed = not name.startswith("routed")
        want = {"swar_fused_votes": passes["stage1"] + passes["completion"],
                "clause_votes": passes["escalation"] if shed else 0}
        if got != want or passes["stage1"] != st["batches"] or \
                tiers["cascade_rows"] != st["rows"]:
            raise AssertionError(f"shed tier {name}: launches {got}, "
                                 f"expected {want}; passes {passes}, "
                                 f"{st['batches']} batches, tiers {tiers}")
        if shed and (tiers["shed_batches"] != st["batches"]
                     or passes["completion"]):
            raise AssertionError(f"shed tier {name}: tiers {tiers}, "
                                 f"passes {passes}")
        print(f"shed {name}: tiers={json.dumps(tiers)}  passes={passes}  "
              f"launches={got}  p50={st['p50_ms']}ms  p99={st['p99_ms']}ms",
              flush=True)
    for name in ("indicator", "routed indicator"):
        if runs[name]["stats"]["tiers"]["escalated_rows"] != 0:
            raise AssertionError(f"shed tier: the indicator machine "
                                 f"escalated rows ({name})")
    if not runs["routed indicator"]["passes"]["completion"]:
        raise AssertionError("shed tier: no exact-sums completion pass ran")
    return {"launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in ("swar_fused_votes", "clause_votes")},
            "escalation_rate":
                runs["shed"]["stats"]["tiers"]["escalation_rate"]}


def fleet_models() -> dict:
    """Phase 11's models → {name: (TMConfig, numpy ta, TMServer kw)},
    each state a random draw from its own seed: FLEET_DENSITY for the
    tm-mnist members, 5% for tm-iris-50 (24 literals: a clause holds about
    one), densities at which a random row fires clauses."""
    from repro_torch.core.tm import TMConfig
    models = {}
    for i in range(FLEET_M50):
        kw = ({"train_backend": "fused", "train_seed": SEED + 1 + i}
              if i < FLEET_LEARNERS else {})
        models[f"mnist50-{i:02d}"] = (
            TMConfig(n_classes=C, n_clauses=M, n_features=F, T=T, s=S),
            make_ta(np.random.default_rng(SEED + 1000 + i),
                    FLEET_DENSITY), kw)
    for i in range(FLEET_M100):
        models[f"mnist100-{i}"] = (
            TMConfig(n_classes=10, n_clauses=100, n_features=784, T=5,
                     s=10.0),
            make_ta(np.random.default_rng(SEED + 1100 + i), FLEET_DENSITY,
                    10, 100, 784), {})
    models["iris50"] = (
        TMConfig(n_classes=3, n_clauses=50, n_features=12, T=7, s=6.5),
        make_ta(np.random.default_rng(SEED + 1200), DENSITY, 3, 50, 12), {})
    return models


def fleet_learning(rt, models) -> dict:
    """Each learning member's labeled batches (phase 5's teacher stream,
    FLEET_UPDATES batches apiece) and their CPU ``reference`` replay on
    the member's key chain → {name: (batches, replay)}."""
    learners = [n for n, (_, _, kw) in models.items() if kw]
    cfg = models[learners[0]][0]
    feed, labels = label_feed(rt, cfg)
    out = {}
    for j, name in enumerate(learners):
        sl = slice(j * FLEET_UPDATES, (j + 1) * FLEET_UPDATES)
        _, ta, kw = models[name]
        out[name] = (list(zip(feed[sl], labels[sl])),
                     reference_replay(rt, cfg, ta, feed[sl], labels[sl],
                                      seed=kw["train_seed"]))
    return out


async def fleet_arm(torch, rt, models, learning, *, pack: bool,
                    cache_entries=None) -> dict:
    """Phase 11, one arm: a cuda TMFleet (``pack`` or the solo control)
    under FLEET_CLIENTS closed-loop clients of 1-16-row requests, each
    model drawn Zipf-skewed, every third with a deadline, while each
    learning member takes its labeled batches.  Every response must equal
    the CPU oracle of its model under the member version its request
    pinned, every published member version the CPU replay; the counters,
    zeroed just before the traffic, must show K3 = batches served by the
    serving servers (group planes and solo models) and K2 = K1 =
    updates → launch counts, batching and latency numbers."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.engine import engine_cache_info, get_engine
    from repro_torch.serve import ServePolicy, TMFleet, percentiles_ms

    specs = {name: {"cfg": cfg, "state": state_from_numpy(ta), **kw}
             for name, (cfg, ta, kw) in models.items()}
    fleet = TMFleet(specs, ServePolicy(max_batch=SERVE_BATCH,
                                       max_wait_us=500, backend="mxu_fused"),
                    pack=pack, cache_entries=cache_entries)
    # the device worker's busy time: the host clock around each call the
    # fleet's one worker thread runs (the serving batches' engine calls)
    busy = [0.0]
    submit = fleet._pool.submit

    def timed_submit(fn, *args, **kw):
        def run():
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                busy[0] += time.perf_counter() - t
        return submit(run)

    fleet._pool.submit = timed_submit
    names = list(models)
    rank = np.random.default_rng(SEED + 7).permutation(len(names))
    p = 1.0 / (rank + 1.0) ** FLEET_ZIPF
    p /= p.sum()
    answered, lat, published = [], [], {}

    async def client(cid: int) -> None:
        rng = np.random.default_rng(SEED + 300 + cid)
        for i in range(FLEET_PER_CLIENT):
            name = names[rng.choice(len(names), p=p)]
            lits = rng.integers(0, 2, (int(rng.integers(1, 17)),
                                       models[name][0].n_literals),
                                dtype=np.int8)
            kw = {"deadline_us": 2_000_000} if i % 3 == 0 else {}
            # the submit below pins the group (or solo) version current
            # now, with no await in between while the queue has room; a
            # member publish re-stacks its group inside the publish
            version = fleet.server_for(name).state_version
            t0 = time.perf_counter()
            res = await fleet.submit(name, lits, client=cid, **kw)
            lat.append(time.perf_counter() - t0)
            answered.append((name, version, cid, i, lits, res))

    async def feeder(name: str) -> None:
        srv = fleet.server_for(name)
        for lits, y in learning[name][0]:
            v = await fleet.submit_labeled(name, lits, y)
            if srv.state_version != v or (name, v) in published:
                raise AssertionError(f"fleet: {name} published v{v} at "
                                     f"v{srv.state_version}")
            published[(name, v)] = srv.state.ta

    counters = ("clause_votes", "swar_fused_votes", "train_deltas_keyed")
    async with fleet:
        t0 = time.perf_counter()
        await fleet.warmup(train_batches=(LABEL_BATCH,))
        warm = time.perf_counter() - t0
        for k in counters:
            rt[k].launches = 0
        cache0 = engine_cache_info()
        busy[0] = 0.0
        t0 = time.perf_counter()
        await asyncio.gather(*[feeder(n) for n in learning],
                             *[client(c) for c in range(FLEET_CLIENTS)])
        wall = time.perf_counter() - t0
        busy_s = busy[0]
        launches = {k: rt[k].launches for k in counters}
        stats = fleet.stats()
        cache = {k: v - cache0[k] for k, v in stats["engine_cache"].items()
                 if k in ("hits", "misses", "evictions", "superseded")}
        # the servers that answered predicts: the group planes (whose
        # batching counters the fleet's group rows summarise) and the solo
        # models
        serving = [g.server.stats() for g in fleet._groups] + \
            [m["server"] for m in stats["models"].values()
             if not m["packed"]]
    arm = "packed" if pack else "solo"
    # checked after the traffic: the CPU oracles and replays stay off the
    # event loop the fleet shares
    for (name, v), ta in published.items():
        if not torch.equal(ta.cpu(), learning[name][1][v].ta):
            raise AssertionError(f"fleet {arm}: {name} published v{v} "
                                 f"differs from the CPU reference replay")
    oracles = {}
    for name, version, cid, i, lits, res in answered:
        if (name, version) not in oracles:
            cfg, ta, _ = models[name]
            state = (learning[name][1][version] if name in learning
                     else state_from_numpy(ta, device="cpu"))
            oracles[name, version] = get_engine("oracle", cfg, state,
                                                cache=False)
        want = oracles[name, version].infer(lits)
        if not (np.array_equal(res.prediction, want.prediction.numpy())
                and np.array_equal(res.class_sums,
                                   want.class_sums.numpy())):
            raise AssertionError(f"fleet {arm}: {name} response differs from "
                                 f"the CPU oracle at v{version} (client "
                                 f"{cid}, request {i})")
    # the oracle check can only fail where clauses fire: per model family
    # (the 640- and 40-class planes, the solo model), most response rows
    # must carry nonzero class sums and the predictions must differ
    nonzero = {}
    for family in ("mnist50", "mnist100", "iris50"):
        res = [r for name, _, _, _, _, r in answered
               if name.startswith(family)]
        if not res:
            raise AssertionError(f"fleet {arm}: no request reached "
                                 f"{family}")
        sums = np.concatenate([r.class_sums for r in res])
        preds = np.concatenate([r.prediction for r in res])
        share = float((sums != 0).any(axis=1).mean())
        nonzero[family] = (share, len(np.unique(preds)))
        if share < 0.5 or len(np.unique(preds)) < 2:
            raise AssertionError(f"fleet {arm}: {family} responses carry "
                                 f"nonzero class sums on {share:.3f} of "
                                 f"their rows, predictions "
                                 f"{np.unique(preds).tolist()}")
    batches = sum(sv["batches"] for sv in serving)
    rows = sum(sv["rows"] for sv in serving)
    padded = sum(round(sv["rows"] / sv["batch_fill"]) for sv in serving
                 if sv["rows"])
    updates = sum(m["updates"] for m in stats["models"].values())
    want = {"clause_votes": batches, "swar_fused_votes": updates,
            "train_deltas_keyed": updates}
    n = len(answered)
    if n != FLEET_CLIENTS * FLEET_PER_CLIENT or \
            len(published) != len(learning) * FLEET_UPDATES or \
            launches != want or any(m["errors_total"]
                                    for m in stats["models"].values()):
        raise AssertionError(f"fleet {arm}: {n} responses, "
                             f"{len(published)} updates, launches "
                             f"{launches} (expected {want}), stats "
                             f"{json.dumps(stats['groups'])}")
    p50, p99 = percentiles_ms(lat, (0.50, 0.99))
    return {"arm": arm, "launches": launches, "requests": n,
            "batches": batches, "rows": rows, "fill": rows / padded,
            "wall": wall, "warm": warm,
            "p50_ms": p50, "p99_ms": p99, "versions": len(oracles),
            "busy": busy_s, "nonzero": nonzero, "stats": stats, "cache": cache,
            "group_buckets": [sv["buckets"] for sv in serving[
                :len(stats["groups"])]]}


def fleet_phase(torch, rt) -> dict:
    """Phase 11: the fleet's two arms on the same traffic — packed, then
    the solo control with FLEET_SOLO_CACHE cache entries — and the numbers
    each prints: K3 launches per 1,000 requests, rows per batch, batch
    fill, request p50/p99 (host clock around ``TMFleet.submit``), the
    device worker's busy time → the packed arm's launch counts."""
    from repro_torch.engine import ENGINE_CACHE_SIZE, set_engine_cache_budget
    models = fleet_models()
    t0 = time.perf_counter()
    learning = fleet_learning(rt, models)
    print(f"fleet: {len(models)} models ({FLEET_M50} tm-mnist-50, "
          f"{FLEET_M100} tm-mnist-100, 1 tm-iris-50), {len(learning)} "
          f"learning; CPU replay of {len(learning) * FLEET_UPDATES} updates "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    try:
        arms = [asyncio.run(fleet_arm(torch, rt, models, learning,
                                      pack=True)),
                asyncio.run(fleet_arm(torch, rt, models, learning,
                                      pack=False,
                                      cache_entries=FLEET_SOLO_CACHE))]
    finally:
        set_engine_cache_budget(ENGINE_CACHE_SIZE)
    for a in arms:
        st = a["stats"]
        k3 = a["launches"]["clause_votes"]
        hot = sorted(st["models"].items(), key=lambda kv: -kv[1]["requests"])
        print(f"fleet {a['arm']:6s}: {a['requests']} responses == CPU oracle "
              f"at their pinned versions ({a['versions']} model versions); "
              f"{a['launches']['train_deltas_keyed']} updates == CPU "
              f"reference replay; K3 {k3} launches = {a['batches']} served "
              f"batches ({k3 * 1000 / a['requests']:.1f} per 1,000 "
              f"requests)  rows/batch={a['rows'] / a['batches']:.3f}  "
              f"fill={a['fill']:.4f}  request p50={a['p50_ms']:.3f}ms  "
              f"p99={a['p99_ms']:.3f}ms  in {a['wall']:.3f}s (warmup "
              f"{a['warm']:.3f}s; the device worker busy {a['busy']:.6f}s "
              f"of it)  rows with nonzero class sums and distinct "
              f"predictions {json.dumps(a['nonzero'])}  launches="
              f"{a['launches']}", flush=True)
        print(f"fleet {a['arm']:6s} groups: " + json.dumps(
            [{k: g[k] for k in ("fused_classes", "version", "requests",
                                "batches", "mean_batch_rows")}
             for g in st["groups"]]) + "  group service times: "
              + json.dumps(a["group_buckets"]) + "  hottest: " + json.dumps(
            {n: m["requests"] for n, m in hot[:5]}) + "  engine_cache: "
              + json.dumps(st["engine_cache"]) + "  during the traffic: "
              + json.dumps(a["cache"]), flush=True)
    return arms[0]


def timed_row(torch, name, kern, plain, nbytes, t_ops, label,
              library=None) -> dict:
    """Median device times of a kernel, its plain version and (where one
    PyTorch call computes the same function) that call, beside the bound
    — the larger of ``nbytes`` at the HBM rate and ``t_ops`` seconds of
    operations at their peak."""
    ms = device_ms(kern, reps=50)
    plain_ms = device_ms(plain, reps=5)
    library_ms = device_ms(library, reps=50) if library else None
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
    ``torch._int_mm`` (cuBLASLt's int8 GEMM, the same function here) at
    the BNN's shape and at 1024^3 → the row at the BNN's shape, with the
    1024^3 row under ``"at_1024^3"``."""
    rng = np.random.default_rng(SEED + 50)
    timed = {}
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
        if (m, k, n) not in (K6_MAIN, K6_SHAPES[-1]):
            continue
        lib = torch._int_mm(x, w)
        torch.cuda.synchronize()
        if not torch.equal(lib, got):
            raise AssertionError("torch._int_mm disagrees with binary_matmul")
        row = timed_row(
            torch, "binary_matmul",
            lambda: rt["binary_matmul"](x, w),
            lambda: rt["binary_matmul_plain"](x, w),
            m * k + k * n + 4 * m * n, 2 * m * n * k / INT8_OPS,
            f"{m}x{k}x{n}", library=lambda: torch._int_mm(x, w))
        row["max_abs_err"] = 0
        timed[(m, k, n)] = row
    row = timed[K6_MAIN]
    row["at_1024^3"] = timed[K6_SHAPES[-1]]
    return row


def check_tensor_cores(libs: dict) -> None:
    """Phase 2b: K3's and K6's products run on the int8 tensor cores —
    ``cuobjdump -sass`` of each library shows integer MMA instructions
    (``IMMA``, from ``mma.sync`` with s8 operands) and no ``IDP``
    (``__dp4a``)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in ("clause_votes", "binary_matmul"):
        sass = subprocess.run([tool, "-sass", str(libs[name])], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
        ops = collections.Counter(re.findall(r"\b((?:IMMA|IDP)[.\w]*)",
                                             sass))
        print(f"sass  {name}: {dict(ops)}", flush=True)
        if not any(op.startswith("IMMA") for op in ops):
            raise AssertionError(f"{name}: no IMMA instruction in its SASS")
        if any(op.startswith("IDP") for op in ops):
            raise AssertionError(f"{name}: __dp4a (IDP) in its SASS")


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
    cases = [(shape, True) for shape in K5_SHAPES + K5_EDGES] + \
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
    # whole rows of ties on integer delays: class C-1 copies class 0, and
    # in the first 8 rows every class arrives together (gap 0)
    b, c, m = K5_SHAPES[-1]
    sel, ed, skew = k5_inputs(torch, rng, 64, c, m, integer=True)
    sel[:, c - 1], ed[c - 1], skew[c - 1] = sel[:, 0], ed[0], skew[0]
    sel[:8] = sel[:8, :1].clone()
    ed[:], skew[:] = ed[:1].clone(), skew[:1].clone()
    sel[8:, 1:c - 1] = 1 - sel[8:, :1]
    got = k5(sel, ed, skew, T_RES)
    want = plain(sel, ed, skew, T_RES)
    if not all(torch.equal(g, w_) for g, w_ in zip(got, want)) or \
            not bool(got[2][:8].all()):
        raise AssertionError("pdl_race tied rows differ from the plain "
                             "version")
    print(f"check pdl_race         (64, {c}, {m}) tied rows: bitwise=True",
          flush=True)
    b, c, m = K5_SHAPES[-1]
    args = k5_inputs(torch, rng, b, c, m, integer=False)
    row = timed_row(torch, "pdl_race", lambda: k5(*args, T_RES),
                    lambda: plain(*args, T_RES),
                    b * c * m + 8 * c * m + 4 * c + 9 * b,
                    b * c * m / FP32_ADDS, f"B={b} C={c} M={m}")
    row["max_abs_err"] = lat_err
    return row


def time_domain_popcount(torch, rt, state) -> dict:
    """Phase 7: the clause bits of K5_ROWS rows under ``state`` (the last
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
    """Phase 8: the BNN entry point on cuda; K6's counter zeroed before,
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
    check_tensor_cores(libs)

    kernels = check_kernels(torch, rt)
    kernels["train_deltas_keyed"] = check_train_deltas(torch, rt)
    per_call = profile_launches(torch, rt)
    check_class_tiles(torch, rt)
    fleet_shape = check_fleet_shape(torch, rt)
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
    # default routing: the trained-density state goes to sparse_csr, the
    # ELL gather in plain tensor code (no kernel of its own)
    default = asyncio.run(serve(torch, rt, None, ta))
    if default["routes"] != {"sparse_csr"} or any(
            default["launches"].values()):
        raise AssertionError(f"default routing: routes "
                             f"{default['routes']}, launches "
                             f"{default['launches']}")
    learn = asyncio.run(serve_and_learn(
        torch, rt, ta, backend="mxu_fused", train_backend="fused",
        expect=lambda st: {"train_deltas_keyed": N_UPDATES,
                           "swar_fused_votes": N_UPDATES,
                           "clause_votes": st["batches"]}))
    # default routing: a trained-density state routes every bucket to
    # sparse_csr (no kernel of its own: the ELL gather is torch ops), and
    # the sparse train engine's deltas go through K2 alone
    sparse = asyncio.run(serve_and_learn(
        torch, rt, ta, backend=None, train_backend="sparse",
        expect=lambda st: {"train_deltas_keyed": N_UPDATES,
                           "swar_fused_votes": 0, "clause_votes": 0}))
    if sparse["routes"] != {"sparse_csr"} or \
            sparse["stats"]["sparse_layout"] is None:
        raise AssertionError(f"default routing chose {sparse['routes']}, "
                             f"layout {sparse['stats']['sparse_layout']}")
    asyncio.run(serve(torch, rt, "time_domain",
                      learn["state"].ta.cpu().numpy()))
    slice_run = time_domain_popcount(torch, rt, learn["state"])
    bnn = bnn_phase(torch, rt)
    with tempfile.TemporaryDirectory() as tmp:
        life = asyncio.run(lifecycle(torch, rt, ta, tmp))
    shed = asyncio.run(shed_tier(torch, rt, learn["state"].ta.cpu().numpy()))
    fleet = fleet_phase(torch, rt)

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
                "binary_matmul": "{}x{}x{}".format(*K6_MAIN)}
    # launches in the later paths, each counted from 0 around its traffic:
    # phase 9 (lifecycle), phase 10 (shed tier) and phase 11 (the packed
    # fleet)
    by_phase = {name: {ph: run["launches"][name]
                       for ph, run in (("9", life), ("10", shed),
                                       ("11", fleet))
                       if name in run["launches"]}
                for name in meta}
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
                     "shape": shape_of[name],
                     **({"launches_by_phase": by_phase[name]}
                        if by_phase[name] else {}),
                     **({"device_kernels_per_call": per_call[name]}
                        if name in per_call else {}),
                     **({"at_1024^3": k["at_1024^3"]} if "at_1024^3" in k
                        else {}),
                     **({f"at_C{FLEET_C}": fleet_shape[name]}
                        if name in fleet_shape else {})})
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
