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
the control, each model solo, serves and learns data-parallel over a
device mesh (the card's own, and four simulated shards of it) through a
kill and an elastic restore onto another mesh size, serves the LM
zoo's qwen1.5-4b, tinyllama-1.1b, mamba2-130m, zamba2-2.7b,
llama4-scout-17b-a16e and deepseek-v2-236b (depth cut) and
seamless-m4t-large-v2 at their published widths, trains
tinyllama-1.1b, deepseek-v2 (depth and experts cut) and
seamless-m4t-large-v2 at their published widths, serves qwen1.5-4b and
trains tinyllama-1.1b tensor- and data-parallel on a (2, 2) LM mesh,
serves llama4-scout and deepseek-v2 (depth cut), mamba2-130m,
zamba2-2.7b and seamless-m4t-large-v2 on that mesh, and trains
deepseek-v2, mamba2-130m, zamba2-2.7b and seamless-m4t-large-v2 (depth
cut) there.

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
   with ``backend="time_domain"`` (the ideal PDL race: the low-net
   count from K3, the delays and the race in plain tensor code) on the
   state phase 5 learned (the random state of phase 4 fires
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
12. the mesh: tm-mnist-50 at full width through ``TMServer(mesh=...,
   train_backend="sharded")`` with ``ServePolicy(max_batch=64,
   max_wait_us=500, backend="mxu_fused")`` (each bucket a
   ``ShardedEngine`` over K3, each update K1 + K2 per shard), on
   ``data_mesh(1)`` and on ``data_mesh(4, devices=[cuda:0] * 4)`` (C=10
   pads to 12 there).  The eight predict clients (phase 5's request
   stream, 20 requests each; 10 in each half of the 4-shard run) run
   while the server learns phase 5's 16 batches of 32 rows and one
   ragged batch of 37 (padded to 40 at D=4).  The 4-shard learner
   snapshots every 4 versions and is killed after update 8; a fresh
   server restores the snapshot onto ``data_mesh(1)`` and runs to the
   end, and its final state must equal the uninterrupted D=1 run's.
   Every published version must equal the CPU ``reference`` replay,
   every response the CPU oracle at its pinned version, and the
   counters (zeroed just before each run's traffic) must show K1 = K2 =
   updates x D and K3 = served batches x D.  Request p50/p99, update
   p50/max and one step alone print for D=1 and D=4 beside phase 5's
   ``fused`` numbers and the card's name and power limit.  A mesh of
   distinct GPUs is not run (one card);
13. the LM zoo: qwen1.5-4b and tinyllama-1.1b (dense), mamba2-130m
   (ssm), zamba2-2.7b (hybrid), llama4-scout-17b-a16e and
   deepseek-v2-236b (moe, depth cut to 8 and 5 layers: ``LM_LAYERS``)
   and seamless-m4t-large-v2 (encdec, whole) at their published widths
   in bfloat16, weights from a seeded cuda ``torch.Generator``, through
   ``launch.serve.run`` at the launcher's defaults (batch 8, prompt 32,
   16 new tokens: its closing line and tokens/s); first deepseek-v2 at
   its published size must raise ``torch.OutOfMemoryError`` naming its
   weight bytes; then per model prefill time at (8, 32) (seamless with
   seeded frames), decode-step p50/p99 (host clock with a sync) over
   the 48 steps of a run, one decode step's device kernels, busy time
   and the card's idle share from ``torch.profiler``, the step's bound
   (the bytes it must move over 3.35 TB/s: weights, KV entries or MLA
   latents, the cross-attention cache, the mamba layers' state; for
   the MoE models once with every routed expert and once with only the
   experts the step's kept tokens route to) and
   ``max_memory_allocated``.  Checks (``LM_ARCHS``'s comment): 1a
   prefill-vs-decode greedy consistency at 2 layers (zamba2: its first
   superblock; llama4: its first) of the same weights under the
   near-tie rule (printed, not gated, for moe; skipped for encdec;
   full depth printed, not gated); 1b every layer at full depth
   teacher-forced, float32, one layer's copy at a time (the attention
   half and the cache writes of a moe or encdec layer; each MoE half
   against ``moe_apply`` on the CPU); 2 two layers (zamba2 and llama4:
   the first superblock; seamless: two encoder and two decoder layers)
   in float32 on the card against the CPU, expert choices included;
   logits finite throughout; K1–K6's counters read 0 (the LM path has
   no kernel of its own);
14. LM training (``LM_TRAIN_ARCH``'s comment): tinyllama-1.1b at its
   published width and depth through the port's train step at the
   training launcher's defaults — step time p50/p99 (host clock with a
   sync), tokens/s, model FLOPs over the bf16 dense peak, peak memory,
   one step's device kernels and busy time; gate 1 one float32 step
   card vs CPU at 2 layers, gate 2 the loss falling on a fixed batch
   at 2 layers of the same weights, gate 3 ``launch.train.run`` killed once and resumed equal to an
   unbroken run; K1–K6's counters read 0;
14b. the moe and encdec families training (``LM_TRAIN_MOE``'s comment):
   deepseek-v2 at 2 layers with 64 of its 160 routed experts (no depth
   of either MoE model fits one card's training state whole) and
   seamless-m4t-large-v2 whole with seeded frames, published widths:
   step p50/p99, tokens/s, model FLOPs over the bf16 dense peak, one
   step's device kernels and busy time, peak memory; gate 1 one float32
   step card vs CPU at the reduced llama4, deepseek and seamless configs
   under phase 14's gate-1 bounds with the expert choices compared, gate
   2 the loss falling on a fixed batch at 2 layers; K1–K6's counters
   read 0; a ``{"lm_moe_encdec_training": ...}`` line;
15. the LM mesh (``LM_MESH``'s comment): qwen1.5-4b at its published
   width through ``launch.serve.run(full=True, mesh="host4")`` on a
   (2, 2) ``("data", "model")`` mesh (4 distinct GPUs where visible,
   else cuda:0 four times); 2 layers float32 sharded against unsharded
   within phase 13's check-2 limit (a TF32 control above it; the ratio
   to the CPU test's tolerance printed) and bfloat16 greedy picks under
   the near-tie rule; each member's stored bytes against the dry-run's
   argument bytes; decode-step p50/p99 sharded and unsharded;
   tinyllama-1.1b one float32 step at 2 layers on the mesh against the
   unsharded one under phase 14's gate-1 bounds, 3 full-width bfloat16
   mesh steps (p50), and ``launch.train.run(mesh="host4")`` at reduced
   width; K1–K6's counters read 0; a ``{"lm_mesh": ...}`` line;
15b. the moe family on the LM mesh (``LM_MOE_MESH_LAYERS``' comment):
   llama4-scout at one superblock and deepseek-v2 at 3 layers, published
   widths, through ``launch.serve.run(full=True, mesh="host4")`` on the
   (2, 2) mesh (experts split over ``model``, routing once; deepseek's
   latent cache of 1,024 positions split over ``model`` by length);
   float32 sharded against unsharded (deepseek at 2 layers, llama4 at
   reduced width) with a TF32 control above the limit, bfloat16 lockstep
   picks under the near-tie rule with the expert choices compared by
   ``route_flips``, each member's bytes against the dry-run's, decode
   p50/p99 sharded and unsharded; K1–K6's counters read 0; a
   ``{"lm_moe_mesh": ...}`` line;
15c. the ssm, hybrid and encdec families on the LM mesh
   (``LM_SSM_MESH``'s comment): mamba2-130m, zamba2-2.7b and
   seamless-m4t-large-v2 at published width and full depth through
   ``launch.serve.run(full=True, mesh="host4")`` on the (2, 2) mesh
   (each mamba layer's ``in_proj`` columns over ``model``, its SSM state
   split along ``P``; zamba2's shared block per superblock; seamless's
   encoder and cross-attention heads over ``model``, prefill with
   ``frames``); at a cut depth float32 sharded against unsharded within
   phase 13's check-2 limit with a TF32 control above it and bfloat16
   lockstep picks (seamless: and prefill picks) under the near-tie rule;
   at full depth each member's bytes against the dry-run's, decode
   p50/p99 sharded and unsharded from a bfloat16 lockstep whose
   agreement prints (not gated, R5); K1–K6's counters read 0; a
   ``{"lm_ssm_mesh": ...}`` line;
15d. the non-dense families training on the LM mesh (``LM_MESH_TRAIN``'s
   comment): deepseek-v2 at 2 layers with 32 routed experts, mamba2-130m
   whole, zamba2-2.7b's first superblock and seamless at 2 + 2 layers,
   published widths, on the (2, 2) mesh: one float32 step sharded
   against unsharded under phase 14's gate-1 bounds with the expert
   choices compared and a TF32 control past the limit, 3 bfloat16 steps
   (p50) sharded and unsharded, each member's bytes against the
   dry-run's train cell; ``launch.train.run(mesh="host4")`` at reduced
   width for llama4, mamba2 and zamba2; K1–K6's counters read 0; a
   ``{"lm_mesh_train": ...}`` line;
16. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
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
from typing import Any, NamedTuple

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
# phase 12, the mesh: phase 5's 16 labeled batches and one ragged batch of
# MESH_RAGGED rows; the 4-shard learner is killed after update MESH_KILL.
# Requests per client (the uninterrupted run; half each for the killed
# and the restored run): this phase's count is cut first for time
MESH_RAGGED, MESH_KILL, MESH_PER_CLIENT = 37, 8, 20

# phase 13, the LM zoo's dense family at published widths in bfloat16:
# qwen1.5-4b (src/repro/configs/qwen1_5_4b.py, the JAX serving launcher's
# default arch) and tinyllama-1.1b (GQA, rep 8), at the launcher's
# defaults.  The JAX init (fan_in = shape[-2]) gives q and k entries of
# about sqrt(d_model / heads) at these widths, attention scores of std
# ~120 at layer 0: two correct computations that differ only in rounding
# drift apart about 3-10x per layer (ROADMAP.md, R5), so the checks
# compare prefill and decode where that drift cannot hide a fault:
# - 1a, free-running greedy consistency (decode-stepping the first
#   LM_CONSIST_LEN prompt tokens against prefill over them) at depth
#   LM_FREE_DEPTH of the same weights, in bfloat16, under the near-tie
#   rule of tests/test_models_smoke.py::test_prefill_decode_consistency
#   (there 0.06 on reduced widths) scaled to the top logit's binade: a
#   pick may differ from prefill's only within LM_TIE_ULPS bfloat16 ulps
#   of the top logit; at full depth, in float32, the picks and the drift
#   by depth (at LM_DRIFT_AT) print, not gated (R5);
# - 1b, teacher-forced at full depth: every layer's decode step, fed the
#   prefill path's input and a cache holding prefill's keys and values,
#   must give prefill's output at the last position within LM_LAYER_TOL
#   of that layer's update (max |x' - x|), write prefill's key and value
#   within LM_LAYER_TOL of their largest entry, and pick prefill's token
#   up to near ties (logits within LM_F32_TOL), in float32 (the same
#   weights upcast one layer at a time, TF32 off);
# - 2, the first LM_F32_LAYERS layers of the same weights in float32 on
#   the card and on the CPU: logits within LM_F32_TOL, greedy picks equal
#   up to near ties within it; and a control, the same products in TF32,
#   must land above LM_F32_TOL.  Read on the H100 (PERF.md, PR 20): float32
#   6.83e-4 / 7.55e-4 (qwen / tinyllama), TF32 1.12 / 0.627, so the limit
#   sits 13x above the one and 63x below the other.
# The ssm and hybrid families join at their published widths: mamba2-130m
# (src/repro/configs/mamba2_130m.py: 24 mamba layers, d_model 768, state
# 128, tied embeddings) and zamba2-2.7b (zamba2_2_7b.py: 54 mamba layers in
# 9 superblocks of 6, the shared attention + MLP block after each).  A
# "layer" of the checks is one unit of the forward: a dense layer, a
# mamba layer or one site of zamba2's shared block (63 units); the
# truncated depths (LM_FREE_DEPTH, LM_F32_LAYERS) round up to zamba2's
# first superblock (6 mamba layers and one site).  1b feeds a mamba
# layer's decode step the state of a prefill over the earlier tokens and
# compares the state it writes with the prefill's over all of them.
# The moe and encdec families join at their published widths:
# llama4-scout-17b-a16e (llama4_scout_17b_a16e.py: superblocks of 3
# chunked-local layers and 1 global NoPE layer, 16 routed experts top-1
# and a shared expert) and deepseek-v2-236b (deepseek_v2_236b.py: MLA, a
# dense first layer, 160 routed experts top-6 and 2 shared) with their
# depth cut to LM_LAYERS (107.77 B and 235.74 B parameters do not fit
# 80 GB: 2 superblocks are 39.4 GB in bf16, the first layer and 4 MoE
# layers 34.6 GB), and seamless-m4t-large-v2 (seamless_m4t_large_v2.py:
# 24 encoder and 24 decoder layers, 4.07 GB) whole, prefilled with
# seeded frames.  A MoE layer's prefill and decode step differ by design
# (the expert capacity counts T = B·S tokens against T = B, R7), and the
# encdec decode attends to a zero cross-attention cache (R6), so for
# them 1a prints without gating (moe) or is skipped (encdec), and 1b
# gates the attention half of each layer and the cache it writes, and
# holds each MoE half of a decode step against moe_apply on the CPU at
# the same float32 inputs.  Checks 1b and 2 upcast one layer at a time
# (a float32 llama4 superblock is 35.2 GB), so no unit of any model is
# held in float32 whole.  LM_OVERSIZE's published size must make the
# serving launcher raise torch.OutOfMemoryError naming its weight bytes.
LM_ARCHS = ("qwen1.5-4b", "tinyllama-1.1b", "mamba2-130m", "zamba2-2.7b",
            "llama4-scout-17b-a16e", "deepseek-v2-236b",
            "seamless-m4t-large-v2")
LM_LAYERS = {"llama4-scout-17b-a16e": 8, "deepseek-v2-236b": 5}
LM_OVERSIZE = "deepseek-v2-236b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 32, 16
LM_CONSIST_LEN, LM_FREE_DEPTH = 16, 2
LM_F32_LAYERS, LM_F32_STEPS = 2, 4
LM_LAYER_TOL = 1e-3
# check 2's limit by model (and 1b's near-tie width): 1e-2 for the
# dense models; mamba2's two layers read 1.91e-5 in float32 and
# 3.79e-3 in TF32 on the H100 (PERF.md §6), under 1e-2, so its limit
# is 1e-3 (52x above the one, 3.8x below the other); zamba2's first
# superblock read 8.73e-4 and 0.249 (11x / 25x around 1e-2).  The moe
# and encdec models were first run at 1e-2 (PERF.md §6):
# llama4's superblock read 0.0635 in float32 (the last position's
# hidden error over its largest grows 1.7e-5, 3.3e-4, 2.0e-3, 1.0e-2
# layer by layer, R5's amplification) and 2.39 in TF32, so its limit is
# 0.3 (4.7x / 8x); deepseek's first two layers 3.61e-5 and 0.0165, so
# 1e-3 (28x / 16x); seamless's two encoder and two decoder layers
# 6.28e-3 and 1.59, so 0.1 (16x / 16x)
LM_F32_TOL = {"qwen1.5-4b": 1e-2, "tinyllama-1.1b": 1e-2,
              "mamba2-130m": 1e-3, "zamba2-2.7b": 1e-2,
              "llama4-scout-17b-a16e": 0.3, "deepseek-v2-236b": 1e-3,
              "seamless-m4t-large-v2": 0.1}
# 1a runs in the served bfloat16 for the dense and ssm families and in
# float32 for hybrid: zamba2's first superblock in bfloat16 put 5 of 8
# picks 0.2-0.9 past the rule on the H100 (PERF.md §6; read by
# scripts/lm_reference_drift.py --card), as the reference's bfloat16
# zamba2 case fails its own rule on the CPU (ROADMAP.md, R3)
LM_FREE_DTYPE = {"dense": "bfloat16", "ssm": "bfloat16", "hybrid": "float32",
                 "moe": "bfloat16"}
LM_DRIFT_AT = (1, 2, 5, 10, 20)
LM_TIE_ULPS = 8
LM_PREFILL_REPS = 5
# phase 14, LM training: tinyllama-1.1b (the JAX training launcher's
# default arch) at its published width and depth through the port's
# train step (float32 masters, gradients and AdamW moments, bf16 compute,
# remat) at the launcher's defaults (global batch 8, sequence 128, its
# token stream and loader, TrainHParams()), LM_TRAIN_WARM steps then
# LM_TRAIN_TIMED timed ones.  Gates:
# - 1, one train step of the same weights truncated to LM_TRAIN_F32_LAYERS
#   layers (published widths) in float32 on the card and on the CPU (TF32
#   off; (LM_TRAIN_F32_BATCH, LM_TRAIN_F32_SEQ) tokens; peak lr
#   LM_TRAIN_F32_LR, no warmup): loss rtol 1e-5, grad_norm and every
#   gradient leaf within LM_TRAIN_GRAD_TOL (relative to the CPU's norm
#   and to each leaf's largest CPU magnitude); the updated parameters
#   within 1e-2 lr on average, and every entry whose CPU gradient lies
#   farther from 0 than LM_TRAIN_GRAD_TOL of its leaf's largest (where
#   the gradient limit cannot flip its sign) stepped the CPU's way (a
#   first AdamW step moves an entry by about lr times the sign of its
#   gradient, so a per-entry bound on the difference could not fail);
#   and a control, the same card step with TF32 on, whose gradients
#   must land farther than LM_TRAIN_GRAD_TOL.  The limit was set after a
#   reading on the H100 (PERF.md §6): the backward pass through the
#   near-one-hot attention of the JAX init (R5) amplifies float32
#   rounding to 4.98e-3 of a leaf's largest gradient (the embedding's;
#   wq 3.43e-3) and 1.2e-3 of the norm, so the first limit of 1e-3
#   failed; TF32 read 1.09;
# - 2, the first LM_TRAIN_F32_LAYERS layers of the full-width weights fit
#   one fixed batch of the stream: LM_TRAIN_FIT_STEPS steps at peak lr
#   LM_TRAIN_FIT_LR (no warmup, fresh moments, clip 1) must lower the
#   loss by LM_TRAIN_FIT_DROP nats.  Not at full depth: there the JAX
#   init's gradient norm reads 1.2e14 on the reference itself
#   (scripts/lm_reference_drift.py --grads; ROADMAP.md, R5), so
#   clipping to 1 leaves every entry's step far below AdamW's eps and
#   the loss stays flat (read on the card by that script's --card);
# - 3, launch.train.run at reduced width on the card, LM_TRAIN_KILL_STEPS
#   steps with a checkpoint every LM_TRAIN_KILL_EVERY, killed once (the
#   step at LM_TRAIN_KILL_AT raises) and resumed from its checkpoint,
#   must end at the unbroken run's parameters, step and count bitwise and
#   its AdamW moments within 1e-6 of each leaf's largest (both print
#   whether they are bitwise: on the CPU a replayed step's embedding
#   gradient was seen an ulp apart, which moves a moment and, through
#   AdamW's normalized step, no parameter).
# No full-width checkpoint is written (13.2 GB of masters and moments).
LM_TRAIN_ARCH = "tinyllama-1.1b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
LM_TRAIN_WARM, LM_TRAIN_TIMED = 2, 10
LM_TRAIN_F32_LAYERS, LM_TRAIN_F32_BATCH, LM_TRAIN_F32_SEQ = 2, 2, 32
LM_TRAIN_F32_LR, LM_TRAIN_GRAD_TOL = 1e-3, 2e-2
LM_TRAIN_FIT_STEPS, LM_TRAIN_FIT_LR, LM_TRAIN_FIT_DROP = 8, 1e-3, 0.5
LM_TRAIN_KILL_STEPS, LM_TRAIN_KILL_EVERY, LM_TRAIN_KILL_AT = 6, 2, 3
# H100 SXM dense bf16 tensor-core peak (NVIDIA H100 datasheet, 700 W)
BF16_FLOPS = 989e12
# phase 15, the LM mesh: the serving launcher's --mesh host4 builds a
# (data=2, model=2) mesh with tp = 2 (the JAX launcher's arithmetic:
# model = min(2, N)) over 4 distinct GPUs where 4 are visible, else over
# cuda:0 listed 4 times, whose members then run one after another: on one
# card the mesh measures its extra launches and copies, not a speedup.
# qwen1.5-4b (LM_MESH_ARCH) serves at published width; at LM_MESH_LAYERS
# layers of seeded weights the mesh is held against the unsharded model
# on the card: float32 logits over the prompts (teacher-forced: every
# position of the same tokens) within phase 13's check-2 limit for the
# model (LM_F32_TOL), with a TF32 control that must land above it, and
# the ratio to tests/test_torch_lm_sharding.py's tolerance (|got - want|
# <= LM_MESH_ATOL * max(1, max |want|) + LM_MESH_RTOL * |want|) printed:
# at published width the two float32 computations differ by more (read
# 1.19e-3 on the H100, R5's growth over 2 layers; PERF.md §6), and
# bfloat16 greedy decode in lockstep (both fed the unsharded model's
# picks) under phase 13's near-tie rule; at full depth every member's
# stored bytes (parameter shards, decode-cache shards, its token rows)
# must equal the port dry-run's argument bytes for the (LM_BATCH, cache
# LM_PROMPT + LM_NEW) decode cell on a (2, 2) meta mesh, to the byte.
# tinyllama-1.1b (LM_TRAIN_ARCH) trains on the same mesh: one float32
# step at LM_TRAIN_F32_LAYERS layers against the unsharded step under
# phase 14's gate-1 bounds, then LM_MESH_TRAIN_STEPS bfloat16 steps at
# published width (step p50), then launch.train.run(mesh="host4") at
# reduced width.
LM_MESH = "host4"
LM_MESH_ARCH = "qwen1.5-4b"
LM_MESH_LAYERS = 2
LM_MESH_RTOL = LM_MESH_ATOL = 1e-4
LM_MESH_TRAIN_STEPS = 3
# phase 15b, the moe family on the mesh: llama4-scout and deepseek-v2 at
# published widths through launch.serve.run(full=True, mesh="host4") on
# phase 15's (2, 2) mesh, depth cut to LM_MOE_MESH_LAYERS (one
# superblock; the dense first layer and two MoE layers) and the traffic
# to (LM_BATCH, LM_MOE_MESH_PROMPT) prompts and LM_MOE_MESH_NEW new
# tokens; deepseek decodes into a cache of LM_MOE_MESH_CACHE positions,
# so its latent cache (no head axis) splits its length over model and
# the decode runs sequence-parallel.  Checks: float32 logits over the
# prompts sharded against unsharded on the card, deepseek at
# LM_MOE_MESH_F32_LAYERS layers of published width within phase 13's
# LM_F32_TOL with a TF32 control above it, llama4 at configs/reduce.py's
# width (a float32 superblock at published width is 43.5 GB, twice that
# does not fit) within tests/test_torch_lm_moe_mesh.py's tolerance (the
# LM_MESH_RTOL / LM_MESH_ATOL rule: phase 13's 0.3 for llama4 was set for
# R5's growth at published width, which a TF32 control at d_model 64
# cannot reach), its TF32 control above that; bfloat16 greedy picks in
# lockstep at the served depth under phase 13's near-tie rule, each MoE
# layer's expert choices on the mesh against the unsharded model's by
# route_flips (a flip outside a near tie fails; since a decode step's
# capacity is one slot an expert at B = 8 (R7), one token's flip can
# push another past its expert's slot, so a row whose experts or kept
# slots differ leaves the pick rule from then on, counted); every
# member's stored bytes against the dry-run's argument bytes to the
# byte; decode-step p50/p99 sharded and unsharded from the lockstep run.
LM_MOE_MESH_LAYERS = {"llama4-scout-17b-a16e": 4, "deepseek-v2-236b": 3}
LM_MOE_MESH_CACHE = {"deepseek-v2-236b": 1024}
LM_MOE_MESH_F32_LAYERS = 2
LM_MOE_MESH_PROMPT, LM_MOE_MESH_NEW = 16, 8
# phase 15c, the ssm, hybrid and encdec families on the mesh: mamba2-130m,
# zamba2-2.7b and seamless-m4t-large-v2 at published width and full depth
# through launch.serve.run(full=True, mesh="host4") on phase 15's (2, 2)
# mesh, traffic cut to (LM_BATCH, LM_MOE_MESH_PROMPT) prompts and
# LM_MOE_MESH_NEW new tokens (seamless decodes without frames, R6).
# Checks, at the cut depth LM_SSM_MESH_CUT gives (mamba2 2 layers,
# zamba2 its first superblock of 6 mamba layers and the shared block,
# seamless 2 encoder + 2 decoder layers): float32 logits over the
# prompts (seamless over seeded frames) sharded against unsharded on the
# card within phase 13's LM_F32_TOL[arch], a TF32 control above it, the
# ratio to the CPU test's tolerance printed; greedy decode in lockstep
# with the unsharded model (both fed its picks) and seamless's prefill
# with frames, the mesh's picks under phase 13's near-tie rule, in
# LM_SSM_MESH_CUT_DTYPE: the served bfloat16 for mamba2, float32 for
# zamba2 and seamless, whose bfloat16 runs on the card put a pick past
# the rule at the cut depth too (zamba2's superblock 1.9x at its fourth
# step, as its bfloat16 prefill against decode does, R3; seamless's
# prefill 2.4x), the mesh's partial sums rounded to bfloat16 where the
# unsharded product rounds once (PERF.md §6).
# At full depth: the serving launcher's run; every member's stored bytes
# against the dry-run's argument bytes for the (LM_BATCH, prompt + new)
# decode cell, to the byte; the bfloat16 lockstep decode, each step
# timed with a sync (decode p50/p99), and seamless's prefill with
# frames, their agreement with the unsharded model printed, not gated:
# the first card run put the worst pick 1.1x (mamba2), 20x (zamba2) and
# 15x (seamless; its prefill 6.9x) past the near-tie rule, bfloat16
# rounding grown over 24-54 layers (R5), while float32 at the cut depth
# held (PERF.md §6).
LM_SSM_MESH = ("mamba2-130m", "zamba2-2.7b", "seamless-m4t-large-v2")
LM_SSM_MESH_CUT_DTYPE = {"mamba2-130m": "bfloat16",
                         "zamba2-2.7b": "float32",
                         "seamless-m4t-large-v2": "float32"}
LM_SSM_MESH_CUT = {"mamba2-130m": {"n_layers": 2},
                   "zamba2-2.7b": {"n_layers": 6},
                   "seamless-m4t-large-v2": {"n_layers": 2,
                                             "n_enc_layers": 2}}
# phase 14b, the moe and encdec families training on the card at
# published widths (bf16 compute; float32 masters, gradients and AdamW
# moments: 16 bytes a parameter).  No depth of llama4-scout fits one
# card's training state (one superblock is about 10.9 B parameters, 174
# GB), nor does deepseek-v2 at 2 layers (the dense first layer and one
# MoE layer: about 5.4 B, 86 GB), so deepseek trains at LM_TRAIN_MOE_CUT:
# 2 layers with 64 of its 160 routed experts, top-6 kept (its parameter
# count is computed from the ParamDef shapes and printed before the
# run); seamless-m4t-large-v2 trains whole, fed seeded frames of (batch,
# seq // 4, d_model) that the phase builds (the training launcher feeds
# none, R10).  Each: LM_TRAIN_WARM + LM_TRAIN_MOE_TIMED steps of the
# launcher's token stream at (LM_TRAIN_BATCH, LM_TRAIN_SEQ): step
# p50/p99 (host clock with a sync), tokens/s, model FLOPs (the dry-run's
# 6·N_active·T) over the bf16 dense peak, one step's device kernels and
# busy time (torch.profiler), peak memory.  Gates:
# - 1, one float32 train step card against CPU at the reduced configs
#   (configs/reduce.py) of llama4, deepseek and seamless, under phase
#   14's gate-1 bounds (loss rtol 1e-5; grad_norm and every gradient
#   leaf within LM_TRAIN_GRAD_TOL; parameters within 1e-2 lr on average,
#   no entry whose gradient lies past the limit stepped the other way;
#   llama4's routers, whose gradient is rounding (ROADMAP.md, R9), within
#   LM_R9_ABS absolute on both), every routing's expert choices compared
#   by route_flips (a flip outside a near tie fails), and a TF32 control
#   that must land past the limit.  Written to print the control only
#   (at d_model 64 it need not reach phase 14's limit, phase 15b); the
#   first card run read float32 2.66e-4 / 5.83e-5 / 1.45e-4 and TF32
#   0.207 / 0.201 / 0.309 (llama4 / deepseek / seamless, PERF.md §6),
#   so the control gates;
# - 2, the loss falls by LM_TRAIN_FIT_DROP on one fixed batch in
#   LM_TRAIN_FIT_STEPS steps from fresh moments (phase 14's gate 2) at 2
#   layers of the timed weights (deepseek: the timed model; seamless: its
#   first 2 encoder and 2 decoder layers).
LM_TRAIN_MOE = ("deepseek-v2-236b", "seamless-m4t-large-v2")
LM_TRAIN_MOE_CUT = {"deepseek-v2-236b": {"n_layers": 2, "n_experts": 64},
                    "seamless-m4t-large-v2": {}}
LM_TRAIN_MOE_FIT = {"deepseek-v2-236b": {},
                    "seamless-m4t-large-v2": {"n_layers": 2,
                                              "n_enc_layers": 2}}
LM_TRAIN_MOE_F32 = ("llama4-scout-17b-a16e", "deepseek-v2-236b",
                    "seamless-m4t-large-v2")
LM_TRAIN_MOE_TIMED = 5
LM_R9_ABS = 1e-6
# phase 15d, the non-dense families training on phase 15's (2, 2) mesh,
# published widths, at LM_MESH_TRAIN_CUT (deepseek-v2 2 layers with 32 of
# its 160 routed experts, top-6; mamba2-130m whole; zamba2-2.7b its first
# superblock: 6 mamba layers and the shared block; seamless 2 encoder +
# 2 decoder layers).  Each mesh model and its unsharded twin run one
# after the other, the first freed (its results parked on the host), so
# no two trainable copies share the card.  Checks:
# - one float32 step at (LM_TRAIN_F32_BATCH, LM_TRAIN_F32_SEQ) on the
#   mesh against the unsharded step on the card, under phase 14's gate-1
#   bounds, expert choices compared, and a TF32 control (the mesh step
#   with TF32 products) whose gradients must land past the gradient
#   limit: LM_TRAIN_GRAD_TOL, or LM_MESH_TRAIN_TOL's, set after the first
#   card run (PERF.md §6): deepseek read float32 1.72e-5 and TF32 0.0177,
#   under phase 14's 2e-2, so its limit is 1e-3 (58x / 18x around it);
#   seamless's 2 + 2 layers read 0.0323 (the wq gradient: R5's
#   near-one-hot attention at published width) and 3.97, so its limit
#   is phase 13's 0.1 for it (3.1x / 40x);
# - for LM_MESH_TRAIN_WITNESS (seamless), a witness without the mesh:
#   the same unsharded float32 step, on the same weights and batch, on
#   the card against the CPU, under the same bounds (its TF32 control
#   printed); past phase 14's LM_TRAIN_GRAD_TOL the mesh's worst gradient
#   error must stay within LM_MESH_WITNESS_RATIO times the witness's, so
#   a gap that belongs to the mesh (a backward fault seen only at
#   published width) fails even under the wide limit, while two float32
#   orders of the same sums, which R5 amplifies alike, pass; beside it,
#   printed, how far LM_MESH_WITNESS_DRAWS perturbations of every
#   parameter by 1 + 1e-7·N(0, 1) move the unsharded card step's
#   gradients (the conditioning at this cut);
# - LM_MESH_TRAIN_STEPS bfloat16 steps at (LM_TRAIN_BATCH, LM_TRAIN_SEQ)
#   on the mesh and unsharded (p50 each), and every member's stored bytes
#   (parameter, gradient and moment shards, the count, its rows of the
#   inputs) against the dry-run's argument + gradient bytes for the train
#   cell on a (2, 2) meta mesh, to the byte;
# - launch.train.run(mesh="host4") at reduced width for LM_MESH_TRAIN_LAUNCH
#   (seamless is left out: the launcher feeds no frames, R10).
LM_MESH_TRAIN = ("deepseek-v2-236b", "mamba2-130m", "zamba2-2.7b",
                 "seamless-m4t-large-v2")
LM_MESH_TRAIN_CUT = {"deepseek-v2-236b": {"n_layers": 2, "n_experts": 32},
                     "mamba2-130m": {},
                     "zamba2-2.7b": {"n_layers": 6},
                     "seamless-m4t-large-v2": {"n_layers": 2,
                                               "n_enc_layers": 2}}
LM_MESH_TRAIN_TOL = {"deepseek-v2-236b": 1e-3, "seamless-m4t-large-v2": 0.1}
LM_MESH_TRAIN_WITNESS = ("seamless-m4t-large-v2",)
LM_MESH_WITNESS_RATIO = 10.0
LM_MESH_WITNESS_DRAWS = 4
# the kernel libraries whose launches the LM phases count (K1-K6)
COUNTED = ("swar_fused_votes", "clause_votes", "train_deltas",
           "popcount_words", "pdl_race", "binary_matmul")
LM_MESH_TRAIN_LAUNCH = ("llama4-scout-17b-a16e", "mamba2-130m",
                        "zamba2-2.7b")


def launch_counts(names, since: dict | None = None) -> dict:
    """Hand-written launches of each kernel library in ``names`` so far
    in this process (``kernels.ops.launches``), less the counts
    ``since``."""
    from repro_torch.kernels.ops import launches
    now = {n: launches(n) for n in names}
    return now if since is None else {n: now[n] - since[n] for n in names}


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


async def serve(torch, backend, ta: np.ndarray, *, label=None,
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
        launch0 = launch_counts(("clause_votes", "swar_fused_votes"))
        passes0 = cascade_passes(server)
        t0 = time.perf_counter()
        await asyncio.gather(*[client(c) for c in range(N_CLIENTS)])
        wall = time.perf_counter() - t0
        launches = launch_counts(("clause_votes", "swar_fused_votes"),
                                 launch0)
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


def device_activity(torch, fn) -> tuple:
    """The device activities (kernels, memsets, copies) one call of ``fn``
    puts on the card, from ``torch.profiler``'s trace → (names, their
    summed durations in µs, {name: µs}); empty where the profiler traces
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    return [e.name for e in events], float(sum(by_name.values())), by_name


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
            ("train_deltas",
             lambda: rt["train_deltas_keyed"](*k2, **kw))):
        acts = device_activity(torch, fn)[0]
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
        launch0 = launch_counts(("clause_votes", "swar_fused_votes",
                                 "train_deltas"))
        t0 = time.perf_counter()
        versions, *_ = await asyncio.gather(
            feeder(), *[client(c) for c in range(N_CLIENTS)])
        wall = time.perf_counter() - t0
        launches = launch_counts(("clause_votes", "swar_fused_votes",
                                  "train_deltas"), launch0)
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
            "state": published[N_UPDATES],
            "update_ms": (statistics.median(lat) * 1e3, lat[-1] * 1e3),
            "step_ms": statistics.median(step_s) * 1e3}


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
    names = ("clause_votes", "swar_fused_votes", "train_deltas")
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
        launch0 = launch_counts(names)
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
        launches.update(launch_counts(names, launch0))
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
        launch0 = launch_counts(names)
        n0 = srv.stats()["batches"]
        rolled = srv.rollback(12)
        await asyncio.gather(*[client(srv, c, 4) for c in range(N_CLIENTS)])
        launches.update(launch_counts(names, launch0))
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
                     "train_deltas": N_UPDATES}
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
        "shed": await serve(torch, "mxu_fused", ta, label="shed tier",
                            policy_kw=tier, exact_sums=False),
        "indicator": await serve(torch, "mxu_fused", ind_ta,
                                 label="shed indicator", policy_kw=tier,
                                 make_lits=onehot_rows, exact_sums=False),
        "routed": await serve(torch, None, ta, label="routed cascade",
                              routing=routed),
        # the exact-sums completion pass runs only on rows that settle
        "routed indicator": await serve(
            torch, None, ind_ta, label="routed indicator",
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


async def fleet_arm(torch, models, learning, *, pack: bool,
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

    counters = ("clause_votes", "swar_fused_votes", "train_deltas")
    async with fleet:
        t0 = time.perf_counter()
        await fleet.warmup(train_batches=(LABEL_BATCH,))
        warm = time.perf_counter() - t0
        launch0 = launch_counts(counters)
        cache0 = engine_cache_info()
        busy[0] = 0.0
        t0 = time.perf_counter()
        await asyncio.gather(*[feeder(n) for n in learning],
                             *[client(c) for c in range(FLEET_CLIENTS)])
        wall = time.perf_counter() - t0
        busy_s = busy[0]
        launches = launch_counts(counters, launch0)
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
            "train_deltas": updates}
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
        arms = [asyncio.run(fleet_arm(torch, models, learning,
                                      pack=True)),
                asyncio.run(fleet_arm(torch, models, learning,
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
              f"{a['launches']['train_deltas']} updates == CPU "
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


def mesh_feed(rt, cfg) -> tuple:
    """Phase 12's labeled stream: phase 5's 16 batches of 32 rows, then
    one ragged batch of MESH_RAGGED rows (the same teacher) → (feed,
    labels) lists."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.engine import get_engine
    feed, labels = label_feed(rt, cfg)
    feed, labels = list(feed), list(labels)
    rows = np.random.default_rng(SEED + 5).integers(
        0, 2, (MESH_RAGGED, 2 * F), dtype=np.int8)
    teacher = get_engine("oracle", cfg, state_from_numpy(
        make_ta(np.random.default_rng(SEED + 2), DENSITY)))
    feed.append(rows)
    labels.append(teacher.infer(rows).prediction.cpu().numpy())
    return feed, labels


async def mesh_run(torch, cfg, ta: np.ndarray, mesh, feed, labels,
                   lo: int, hi: int, *, per_client: int,
                   directory: str | None = None,
                   restore_onto=None) -> dict:
    """One phase-12 server: ``TMServer(mesh=mesh, train_backend=
    "sharded")`` serving ``mxu_fused`` takes labeled batches ``lo..hi-1``
    under the predict clients (``per_client`` requests each).  With
    ``restore_onto`` it first restores the newest snapshot in
    ``directory`` onto that mesh; with ``directory`` alone it snapshots
    every 4 versions.  The counters are zeroed after warmup → published
    (version, state) pairs, pinned responses, stats, launches, update
    latencies."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.serve import ServePolicy, TMServer

    published, answered, update_s = [], [], []
    names = ("clause_votes", "swar_fused_votes", "train_deltas")
    server = TMServer(
        cfg, state_from_numpy(ta),
        ServePolicy(max_batch=SERVE_BATCH, max_wait_us=500,
                    backend="mxu_fused"),
        mesh=mesh, train_backend="sharded",
        # a restore must resume the snapshot's key chain, not this seed
        train_seed=SEED + (1 if restore_onto is not None else 0),
        history_size=len(feed) + 1,
        checkpoint_dir=directory,
        checkpoint_every_updates=4 if restore_onto is None and directory
        else 0,
        on_publish=lambda v, st: published.append((v, st)))
    restore_ms = None
    if restore_onto is not None:
        t0 = time.perf_counter()
        if server.restore(mesh=restore_onto) != lo:
            raise AssertionError(f"mesh: restored {server.state_version}, "
                                 f"not version {lo}")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    shards = server.stats()["mesh"]["devices"]
    devices = {d.type for d in server._train_engine.mesh.devices}
    if server._train_engine.n_devices != shards or devices != {"cuda"} \
            or server.state.ta.device.type != "cuda":
        raise AssertionError(f"mesh: {shards} serving shards, train mesh "
                             f"{server._train_engine.mesh}, state on "
                             f"{server.state.ta.device}")

    async def client(cid: int) -> None:
        crng = np.random.default_rng(SEED + 200 + cid)
        for i in range(per_client):
            lits = crng.integers(0, 2, (int(crng.integers(1, 17)), 2 * F),
                                 dtype=np.int8)
            version = server.state_version
            res = await server.submit(lits, client=cid)
            answered.append((version, cid, i, lits, res))

    async def feeder() -> list:
        versions = []
        for i in range(lo, hi):
            t0 = time.perf_counter()
            versions.append(await server.submit_labeled(feed[i], labels[i]))
            update_s.append(time.perf_counter() - t0)
        return versions

    async with server:
        await server.warmup(train_batches=tuple(
            sorted({len(feed[i]) for i in range(lo, hi)})))
        launch0 = launch_counts(names)
        t0 = time.perf_counter()
        versions, *_ = await asyncio.gather(
            feeder(), *[client(c) for c in range(N_CLIENTS)])
        wall = time.perf_counter() - t0
        launches = launch_counts(names, launch0)
        stats = server.stats()
    if versions != list(range(lo + 1, hi + 1)) or stats["errors"]:
        raise AssertionError(f"mesh: versions {versions}, "
                             f"{stats['errors']} errors")
    want = {"clause_votes": stats["batches"] * shards,
            "swar_fused_votes": (hi - lo) * shards,
            "train_deltas": (hi - lo) * shards}
    if launches != want:
        raise AssertionError(f"mesh D={shards}: launches {launches}, "
                             f"expected {want}")
    return {"published": published, "answered": answered, "stats": stats,
            "launches": launches, "update_s": update_s, "wall": wall,
            "shards": shards, "restore_ms": restore_ms,
            "state": server.state}


def mesh_phase(torch, rt, ta: np.ndarray, learn: dict, card: str) -> dict:
    """Phase 12: tm-mnist-50 serving and learning data-parallel over the
    card's own mesh (``data_mesh(1)``) and a simulated 4-shard mesh of it
    (C=10 classes pad to 12 there; the 37-row batch pads to 40).  Every
    published version must equal the CPU ``reference`` replay and every
    response the CPU oracle at its pinned version; the 4-shard learner is
    killed after update 8 and restored onto ``data_mesh(1)``, and its
    final state must equal the uninterrupted run's; K1 = K2 = updates × D
    and K3 = served batches × D in every run."""
    from repro_torch.engine import get_engine, get_train_engine

    data_mesh, prng = rt["data_mesh"], rt["prng"]
    cfg = rt["TMConfig"](n_classes=C, n_clauses=M, n_features=F, T=T, s=S)
    feed, labels = mesh_feed(rt, cfg)
    n = len(feed)
    one = data_mesh(1)
    four = data_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    t0 = time.perf_counter()
    whole = asyncio.run(mesh_run(torch, cfg, ta, one, feed, labels, 0,
                                 n, per_client=MESH_PER_CLIENT))
    with tempfile.TemporaryDirectory() as tmp:
        killed = asyncio.run(mesh_run(
            torch, cfg, ta, four, feed, labels, 0, MESH_KILL,
            per_client=MESH_PER_CLIENT // 2, directory=tmp))
        from repro_torch import checkpoint as ckpt
        extra = ckpt.read_manifest_extra(tmp, ckpt.latest_step(tmp))
        if ckpt.latest_step(tmp) != MESH_KILL or \
                extra["mesh_devices"] != 4 or \
                extra["train_opts"]["n_devices"] != 4:
            raise AssertionError(f"mesh: snapshot step "
                                 f"{ckpt.latest_step(tmp)} extra {extra}")
        resumed = asyncio.run(mesh_run(
            torch, cfg, ta, four, feed, labels, MESH_KILL, n,
            per_client=MESH_PER_CLIENT // 2, directory=tmp,
            restore_onto=one))
    wall = time.perf_counter() - t0
    if resumed["shards"] != 1:
        raise AssertionError(f"mesh: restored onto {resumed['shards']} "
                             f"shards")
    # checked after the traffic: the CPU replay and oracles stay off the
    # event loop
    replay = reference_replay(rt, cfg, ta, feed, labels)
    oracles = {}
    for label, run in (("D=1", whole), ("D=4", killed),
                       ("restored", resumed)):
        for v, st in run["published"]:
            if not torch.equal(st.ta.cpu(), replay[v].ta):
                raise AssertionError(f"mesh {label}: published version {v} "
                                     f"differs from the CPU replay")
        for version, cid, i, lits, res in run["answered"]:
            if version not in oracles:
                oracles[version] = get_engine("oracle", cfg, replay[version])
            want = oracles[version].infer(lits)
            if not (np.array_equal(res.prediction, want.prediction.numpy())
                    and np.array_equal(res.class_sums,
                                       want.class_sums.numpy())):
                raise AssertionError(f"mesh {label}: response differs from "
                                     f"the CPU oracle at version {version} "
                                     f"(client {cid}, request {i})")
    if not torch.equal(resumed["state"].ta, whole["state"].ta):
        raise AssertionError("mesh: the restored run's final state differs "
                             "from the uninterrupted run's")

    # one update's step alone at B=32, no predict traffic (host clock,
    # ending in a stream sync), on each mesh
    step_ms = {}
    for d, mesh in ((1, one), (4, four)):
        engine, times = get_train_engine("sharded", cfg, mesh=mesh), []
        for i in range(10):
            k = prng.split(prng.key(i))[1]
            t1 = time.perf_counter()
            engine.step(whole["state"], k, feed[i], labels[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        step_ms[d] = statistics.median(times) * 1e3

    def summary(run) -> str:
        lat = sorted(run["update_s"])
        st = run["stats"]
        return (f"{len(run['answered'])} responses  batches={st['batches']}"
                f"  p50={st['p50_ms']}ms  p99={st['p99_ms']}ms  update "
                f"p50={statistics.median(lat) * 1e3:.3f}ms  "
                f"max={lat[-1] * 1e3:.3f}ms  launches={run['launches']}")

    print(f"mesh D=1 (data_mesh(1)): {n} updates ({n - 1} x {LABEL_BATCH} "
          f"+ {MESH_RAGGED} rows) == CPU reference replay, every response "
          f"== CPU oracle at its version; {summary(whole)}", flush=True)
    print(f"mesh D=4 (4 shards of cuda:0, C={C} padded to 12, "
          f"{MESH_RAGGED} rows padded to 40): updates 1-{MESH_KILL} == "
          f"replay, then killed; {summary(killed)}", flush=True)
    print(f"mesh elastic: the 4-shard snapshot at version {MESH_KILL} "
          f"restored onto data_mesh(1) in {resumed['restore_ms']:.3f} ms "
          f"(host clock); updates {MESH_KILL + 1}-{n} == replay; final "
          f"state == the uninterrupted D=1 run's; {summary(resumed)}; "
          f"{len(oracles)} versions seen across the runs; phase wall "
          f"{wall:.1f}s", flush=True)
    fused = learn["stats"]
    print(f"mesh vs phase 5 fused, {card}: request p50/p99 "
          f"fused {fused['p50_ms']}/{fused['p99_ms']} ms, D=1 "
          f"{whole['stats']['p50_ms']}/{whole['stats']['p99_ms']} ms, D=4 "
          f"{killed['stats']['p50_ms']}/{killed['stats']['p99_ms']} ms; "
          f"update p50/max fused {learn['update_ms'][0]:.3f}/"
          f"{learn['update_ms'][1]:.3f} ms, D=1 "
          f"{statistics.median(whole['update_s']) * 1e3:.3f}/"
          f"{max(whole['update_s']) * 1e3:.3f} ms, D=4 "
          f"{statistics.median(killed['update_s']) * 1e3:.3f}/"
          f"{max(killed['update_s']) * 1e3:.3f} ms; step alone p50 fused "
          f"{learn['step_ms']:.3f} ms, D=1 {step_ms[1]:.3f} ms, D=4 "
          f"{step_ms[4]:.3f} ms", flush=True)
    launches = collections.Counter()
    for run in (whole, killed, resumed):
        launches.update(run["launches"])
    return {"launches": dict(launches), "step_ms": step_ms}


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

    launch0 = launch_counts(("popcount_words", "pdl_race"))
    low_count = rt["popcount_words"](words).reshape(K5_ROWS, C)
    win, lat, meta = rt["pdl_race"](low_sel, elem, dev.skew, pdl.t_res)
    torch.cuda.synchronize()
    launches = launch_counts(("popcount_words", "pdl_race"), launch0)

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


def bnn_phase(torch) -> dict:
    """Phase 8: the BNN entry point on cuda; K6's counter zeroed before,
    read after."""
    from repro_torch.launch.bnn_popcount import run
    launch0 = launch_counts(("binary_matmul",))
    t0 = time.perf_counter()
    out = run(device="cuda")
    torch.cuda.synchronize()
    launches = launch_counts(("binary_matmul",), launch0)
    print(f"bnn: {time.perf_counter() - t0:.2f}s  losses={out['losses']}  "
          f"test_acc={out['test_acc']}  time-domain agreement "
          f"{out['agreement']:.3f} accuracy {out['td_acc']:.3f}  "
          f"launches={launches}", flush=True)
    if launches["binary_matmul"] != 1 or out["h_shape"] != (120, 128):
        raise AssertionError(f"bnn: h {out['h_shape']}, launches "
                             f"{launches}")
    return {"launches": launches}


def bf16_ulp(torch, v):
    """The bfloat16 ulp at each value of ``v`` (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
                      - 7)


def experts_hit(torch, fn) -> list:
    """The distinct experts each ``moe_apply`` call of ``fn()`` routes
    its kept tokens to, in call order (the routing recomputed by
    ``moe_route`` on the call's own inputs)."""
    from repro_torch.models import model as lm_module
    from repro_torch.models.moe import moe_route
    real, hits = lm_module.moe_apply, []

    def recording(c, p, x):
        r = moe_route(c, p["router"], x.reshape(-1, x.shape[-1]))
        hits.append(int(torch.unique(r.sorted_e[r.keep]).numel()))
        return real(c, p, x)
    lm_module.moe_apply = recording
    try:
        fn()
    finally:
        lm_module.moe_apply = real
    return hits


def lm_depth(cfg, n_layers: int) -> int:
    """``n_layers`` rounded up to whole superblocks (zamba2's mamba
    superblocks, llama4's local + global ones), so a truncated model
    keeps its structure."""
    k = cfg.shared_attn_every if cfg.family == "hybrid" else \
        cfg.global_every if cfg.family == "moe" and cfg.global_every else 1
    return -(-n_layers // k) * k


class Unit(NamedTuple):
    """One unit of an LM's forward for phase 13's checks: ``kind``
    "attn" (an attention + FFN layer, or zamba2's shared block at one
    site), "mamba" or "dec" (a decoder layer with cross-attention);
    ``lp`` its parameters; ``cfg`` its attention config; ``slots(cache)``
    the cache tensors its decode step writes (and, for "dec", the
    cross-attention's ``xk`` / ``xv`` it reads)."""
    kind: str
    lp: Any
    cfg: Any
    slots: Any


def lm_units(lm) -> list:
    """Phase 13's per-layer view of ``lm``, in forward order: a zamba2
    superblock's mamba layers, then its shared-block site; a llama4
    superblock's local layers, then its global layer; deepseek's first
    layer, then the others."""
    c, units = lm.cfg, []
    if c.family == "dense":
        for i, lp in enumerate(lm.layers):
            units.append(Unit("attn", lp, lm.attn_cfg, lambda cache, i=i: (
                cache["k"][i], cache["v"][i])))
    elif c.family == "moe" and not c.use_mla:
        loc, glo = "local", "global"
        for s, bp in enumerate(lm.blocks):
            for j, lp in enumerate(bp.local):
                units.append(Unit("attn", lp, lm.attn_local,
                                  lambda cache, s=s, j=j: (
                                      cache[loc]["k"][s, j],
                                      cache[loc]["v"][s, j])))
            units.append(Unit("attn", bp[glo], lm.attn_global,
                              lambda cache, s=s: (cache[glo]["k"][s],
                                                  cache[glo]["v"][s])))
    elif c.family == "moe":
        units.append(Unit("attn", lm.first, lm.mla_cfg, lambda cache: (
            cache["first"]["ckv"], cache["first"]["kpe"])))
        for i, lp in enumerate(lm.layers):
            units.append(Unit("attn", lp, lm.mla_cfg, lambda cache, i=i: (
                cache["rest"]["ckv"][i], cache["rest"]["kpe"][i])))
    elif c.family == "ssm":
        for i, lp in enumerate(lm.layers):
            units.append(Unit("mamba", lp, None, lambda cache, i=i: (
                cache["conv"][i], cache["ssm"][i])))
    elif c.family == "hybrid":
        for s, bp in enumerate(lm.blocks):
            for j, lp in enumerate(bp):
                units.append(Unit("mamba", lp, None, lambda cache, s=s, j=j: (
                    cache["conv"][s, j], cache["ssm"][s, j])))
            units.append(Unit("attn", lm.shared, lm.attn_cfg,
                              lambda cache, s=s: (cache["attn"]["k"][s],
                                                  cache["attn"]["v"][s])))
    else:
        for i, lp in enumerate(lm.layers):
            units.append(Unit("dec", lp, lm.attn_cfg, lambda cache, i=i: (
                cache["k"][i], cache["v"][i], cache["xk"][i],
                cache["xv"][i])))
    return units


def lm_first_units(lm, n_layers: int) -> list:
    """The units of ``lm``'s first ``lm_depth(n_layers)`` layers (with
    zamba2's shared-block sites among them)."""
    depth = lm_depth(lm.cfg, n_layers)
    sites = depth // lm.cfg.shared_attn_every \
        if lm.cfg.family == "hybrid" else 0
    return lm_units(lm)[:depth + sites]


def unit_full(lm, u: Unit, lp, x, enc=None) -> tuple:
    """Unit ``u`` with parameters ``lp`` over the whole sequence → (x',
    its prefill cache, x after the attention half or None)."""
    from repro_torch.models.common import rms_norm
    if u.kind == "mamba":
        y, st = lm._mamba_layer(lp, x)
        return y, st, None
    mid, kv = lm._attn(u.cfg, lp, x)
    if u.kind == "attn":
        return lm._ffn(lp, mid), kv, mid
    xa, _ = lm._cross_attn(lp.xattn, rms_norm(mid, lp.ln2, lm.cfg.norm_eps),
                           enc)
    return lm._ffn(lp, mid + xa, "ln3"), kv, mid


def unit_step(lm, u: Unit, lp, x, cache, pos: int) -> tuple:
    """Unit ``u``'s decode step for one token, writing its slots of
    ``cache`` → (x', x after the attention half or None)."""
    slots = u.slots(cache)
    if u.kind == "mamba":
        return lm._mamba_decode_layer(lp, x, *slots), None
    mid = lm._attn_decode(u.cfg, lp, x, slots[0], slots[1], pos)
    if u.kind == "attn":
        return lm._ffn(lp, mid), mid
    return lm._ffn(lp, lm._cross_decode(lp, mid, *slots[2:]), "ln3"), mid


class HostStage:
    """Page-locked host buffers for float32 CPU copies of card weights,
    one per parameter path, reused unit after unit: a weight is cast on
    the card and copied at the link's rate, where a pageable copy and a
    CPU-side cast would take most of phase 13's time.  A copy stays
    valid until the next copy of the same path."""

    def __init__(self, torch):
        self.torch, self.bufs = torch, {}

    def __call__(self, path: str, p, dtype):
        t = p.detach().to(dtype)
        buf = self.bufs.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != dtype:
            buf = self.bufs[path] = self.torch.empty(t.shape, dtype=dtype,
                                                     pin_memory=True)
        return buf.copy_(t)


def unit_copy(torch, module, device, dtype, keys=None, stage=None):
    """A copy of a unit's parameter module (only its children ``keys``,
    when given) in ``dtype`` on ``device``: through ``stage`` (a
    ``HostStage``) for the CPU, else cast on ``device``."""
    from torch import nn
    from repro_torch.models.model import _Layer

    def leaf(path, p):
        t = stage(path, p, dtype) if stage is not None else \
            p.detach().to(device).to(dtype)
        return nn.Parameter(t, requires_grad=False)

    def tree(m, prefix=""):
        out = {k: leaf(prefix + k, p)
               for k, p in m.named_parameters(recurse=False)}
        out.update({k: tree(ch, f"{prefix}{k}.")
                    for k, ch in m.named_children()})
        return out
    if keys:
        return _Layer({k: leaf(k, module[k]) if isinstance(
            module[k], torch.nn.Parameter) else tree(module[k], k + ".")
            for k in keys})
    return _Layer(tree(module))


def moe_routing(lm, lp, mid):
    """The expert choice (sorted top-k per token) and the gates of the
    MoE half of a layer whose attention half gave ``mid``."""
    from repro_torch.models.common import rms_norm
    from repro_torch.models.moe import moe_route
    h = rms_norm(mid, lp.ln2, lm.cfg.norm_eps)
    r = moe_route(lm.moe_cfg, lp.moe["router"], h.reshape(-1, h.shape[-1]))
    return r.top_i.sort(-1).values, r.gates


def route_flips(torch, got, want) -> tuple[int, int]:
    """Tokens whose expert choice ``got`` (one device's (choice, gates))
    differs from ``want`` (the reference's) → (flips, flips outside a
    near tie: the reference's k-th and (k+1)-th gates lie farther apart
    than twice the largest difference between the two devices' gates of
    that token, so the rounding difference cannot explain the flip)."""
    (gi, gg), (wi, wg) = got, want
    gg, wg = gg.cpu(), wg.cpu()
    flip = (gi.cpu() != wi.cpu()).any(-1)
    k = wi.shape[-1]
    top = wg.sort(-1, descending=True).values
    tie = (top[:, k - 1] - top[:, k]) <= 2 * (gg - wg).abs().amax(-1) \
        if top.shape[-1] > k else torch.ones_like(flip)
    return int(flip.sum()), int((flip & ~tie).sum())


def lm_embed(lm, toks, dtype, device):
    """Embedding rows of ``toks`` in ``dtype`` on ``device``."""
    return lm.embed[toks.long()].to(device).to(dtype)


def lm_head_logits(torch, lm, x, head_cache: dict):
    """Final norm and head over ``x`` (B, 1, E) in ``x``'s dtype on its
    device (the head copied there once per ``head_cache``), float32
    logits with the padded vocabulary at ``-1e30``."""
    from repro_torch.models.common import rms_norm
    c = lm.cfg
    key = (x.device, x.dtype)
    if key not in head_cache:
        head = lm.embed.T if c.tie_embeddings else lm.lm_head
        head_cache[key] = (head.detach().to(x.device).to(x.dtype),
                           lm.final_norm.detach().to(x.device))
    head, norm = head_cache[key]
    logits = (rms_norm(x, norm, c.norm_eps) @ head).float()[:, 0]
    logits[..., c.vocab_size:] = -1e30
    return logits


def lm_encode(torch, lm, frames, n_layers: int, cast):
    """The first ``n_layers`` encoder layers over ``frames`` (each
    layer's parameters through ``cast``), then ``enc_norm``, in
    ``frames``' dtype on its device."""
    from repro_torch.models.common import rms_norm
    enc = frames
    for lp in list(lm.encoder)[:n_layers]:
        enc, _ = lm._enc_layer(cast(lp), enc)
    return rms_norm(enc, lm.enc_norm.detach().to(frames.device),
                    lm.cfg.norm_eps)


def lm_stream(torch, lm, units, toks, device, dtype, frames=None,
              n_enc: int = 0, steps: int = 0, stage=None):
    """``units`` of ``lm`` in ``dtype`` on ``device``, one unit's copy at
    a time (the served weights themselves where they already are
    ``dtype`` on ``device``): prefill over ``toks`` and, fed ``toks``,
    decode steps at positions ``0..steps-1`` → (logits at the last
    prefill position, each step's logits, each MoE call's routing in
    order, each unit's prefill output at the last position, each unit's
    last step output).  The same computation as the model truncated to
    ``units`` (each unit's cache is its own), reordered unit by unit.
    CPU copies go through ``stage`` (a ``HostStage``)."""
    from repro_torch import tree as ttree
    served = device == lm.device.type and dtype == lm.dtype

    def cast(lp):
        return lp if served else unit_copy(torch, lp, device, dtype,
                                           stage=stage)
    toks = toks.to(lm.device)
    x = lm_embed(lm, toks, dtype, device)
    xs = [lm_embed(lm, toks[:, p:p + 1], dtype, device) for p in range(steps)]
    cache = ttree.map(lambda t: t.to(device),
                      lm.init_cache(toks.shape[0], max(steps, 1), dtype=dtype))
    enc = None if frames is None else \
        lm_encode(torch, lm, frames.to(device).to(dtype), n_enc, cast)
    routes, hidden, step_hidden = [], [], []
    with torch.no_grad():
        for u in units:
            lp = cast(u.lp)
            x, _, mid = unit_full(lm, u, lp, x, enc)
            hidden.append(x[:, -1].float().cpu())
            if hasattr(lp, "moe"):
                routes.append(moe_routing(lm, lp, mid))
            for p in range(steps):
                xs[p], mid = unit_step(lm, u, lp, xs[p], cache, p)
                if hasattr(lp, "moe"):
                    routes.append(moe_routing(lm, lp, mid))
            if steps:
                step_hidden.append(xs[-1][:, 0].float().cpu())
            del lp
        heads = {}
        out = lm_head_logits(torch, lm, x[:, -1:], heads)
        step_logits = [lm_head_logits(torch, lm, xp, heads) for xp in xs]
    return out, step_logits, routes, hidden, step_hidden


def lm_frames(torch, lm, batch: int, seq: int):
    """Seeded encoder frames for ``seq`` tokens: (batch, seq //
    enc_len_ratio, d_model), float32 on the card."""
    c = lm.cfg
    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.normal(
        0, 1, (batch, seq // c.enc_len_ratio, c.d_model))
        .astype(np.float32), device="cuda")


def lm_check_f32(torch, lm, prompts, arch: str, stage) -> dict:
    """Phase 13, check 2: the first LM_F32_LAYERS layers of ``lm``'s
    weights (``lm_first_units``; seamless: that many encoder and decoder
    layers, with frames) in float32 on the card and on the CPU, one
    layer's copy at a time — prefill logits at the last prompt position
    and LM_F32_STEPS teacher-forced decode steps' logits within the
    model's LM_F32_TOL, greedy picks equal up to near ties (CPU logits
    of the two picks within it), and every MoE call's expert choice the
    CPU's up to near ties of its gates (``route_flips``; flips
    counted); the same card run with TF32 on must differ by more than the limit, or
    the limit could not see a lost precision."""
    from repro_torch.core.popcount import argmax_tournament
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: float32 products would round")
    f32, c = torch.float32, lm.cfg
    units = lm_first_units(lm, LM_F32_LAYERS)
    kw = {"steps": LM_F32_STEPS}
    if c.family == "encdec":
        kw.update(frames=lm_frames(torch, lm, prompts.shape[0],
                                   prompts.shape[1]), n_enc=LM_F32_LAYERS)
    ref_last, ref_steps, ref_routes, ref_hidden, _ = lm_stream(
        torch, lm, units, prompts, "cpu", f32, stage=stage, **kw)
    ref = [ref_last] + ref_steps
    got_last, got_steps, got_routes, got_hidden, _ = lm_stream(
        torch, lm, units, prompts, "cuda", f32, **kw)
    # how the card's rounding difference grows unit by unit (R5)
    unit_err = [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got_hidden, ref_hidden)]
    tol = LM_F32_TOL[arch]
    err, flips = 0.0, 0
    for got, want in zip([got_last] + got_steps, ref):
        got = got.cpu()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{arch} float32: non-finite logits")
        err = max(err, float((got - want).abs().max()))
        g, r = argmax_tournament(got).long(), argmax_tournament(want).long()
        rows = torch.arange(len(r))
        gap = (want[rows, g] - want[rows, r]).abs()
        if not ((g == r) | (gap <= tol)).all():
            raise AssertionError(f"{arch} float32: greedy picks {g} vs CPU "
                                 f"{r}, CPU logit gaps {gap}")
        flips += int((g != r).sum())
    route_flips_n = route_bad = 0
    for got, want in zip(got_routes, ref_routes):
        n, bad = route_flips(torch, got, want)
        route_flips_n, route_bad = route_flips_n + n, route_bad + bad
    if route_bad:
        raise AssertionError(f"{arch} float32: {route_bad} tokens routed "
                             f"to other experts than on the CPU outside a "
                             f"near tie of gates")
    # the control: the same products in TF32 (10-bit mantissa) must land
    # above the limit
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl_last, ctl_steps, *_ = lm_stream(torch, lm, units, prompts,
                                            "cuda", f32, **kw)
        ctl = max(float((got.cpu() - want).abs().max())
                  for got, want in zip([ctl_last] + ctl_steps, ref))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if err > tol:
        raise AssertionError(f"{arch} float32 card vs CPU: max |logit "
                             f"error| {err} > {tol} (per unit, the last "
                             f"position's hidden error over its largest: "
                             f"{unit_err}; TF32 control {ctl})")
    if ctl <= tol:
        raise AssertionError(f"{arch} TF32 control: max |logit error| {ctl} "
                             f"<= {tol}, the limit is too loose")
    torch.cuda.empty_cache()
    return {"f32_max_abs_err": err, "f32_near_tie_flips": flips,
            "f32_route_flips": route_flips_n, "f32_unit_err": unit_err,
            "f32_routed_calls": len(ref_routes),
            "tf32_control_err": ctl, "f32_layers": lm_depth(c, LM_F32_LAYERS),
            "f32_units": len(units), "f32_tol": tol}


def lm_free_running(torch, lm, units, toks, dtype) -> dict:
    """Prefill over ``toks`` against decode-stepping them, free-running,
    through ``units`` (``lm_stream`` in ``dtype`` on the card: the
    served weights, or a copy of each unit): after each unit the last
    position's hidden-state difference over its largest entry on the
    prefill path (``drift``, at LM_DRIFT_AT and the last unit: how fast
    rounding differences grow with depth, R5), and the decode path's
    greedy pick against prefill's logits under the near-tie rule
    (LM_TIE_ULPS bfloat16 ulps of the top logit)."""
    from repro_torch.core.popcount import argmax_tournament
    v = lm.cfg.vocab_size
    logits, steps, _, hidden, step_hidden = lm_stream(
        torch, lm, units, toks, "cuda", dtype, steps=toks.shape[1])
    dlogits = steps[-1]
    drift = {i + 1: float((d - h).abs().max() / h.abs().max())
             for i, (h, d) in enumerate(zip(hidden, step_hidden))
             if i + 1 in LM_DRIFT_AT or i + 1 == len(units)}
    if not (torch.isfinite(logits).all() and torch.isfinite(dlogits).all()):
        raise AssertionError(f"{lm.cfg.name}: non-finite logits")
    nxt = argmax_tournament(dlogits).long()
    top = logits[:, :v].max(-1).values
    gap = top - logits[torch.arange(len(nxt), device=nxt.device), nxt]
    tol = LM_TIE_ULPS * bf16_ulp(torch, top)
    return {"exact": int((nxt == argmax_tournament(logits)).sum()),
            "rows": len(nxt), "max_gap": float(gap.max()),
            "tol": float(tol.max()), "within": bool((gap <= tol).all()),
            "max_abs_logit_diff": float((logits[:, :v] - dlogits[:, :v])
                                        .abs().max()),
            "drift": drift, "gaps": gap.tolist(), "tols": tol.tolist()}


def lm_teacher_forced(torch, lm, toks, stage, frames=None) -> dict:
    """Unit by unit at full depth, in float32 (one unit's copy at a time
    on the card): prefill's unit over ``toks`` and the decode step's
    unit for the last token, fed the same input and a cache holding what
    prefill gives for the earlier positions (an attention unit:
    prefill's keys and values, or MLA's latents; a mamba unit: the state
    of a prefill over the earlier tokens).  → per unit, the error of the
    step's output relative to the unit's update — the whole unit, or
    only its attention half where the decode step computes the rest
    otherwise by design (a MoE half's capacity, R7; the decoder's
    cross-attention over the zero ``xk`` / ``xv``, R6) — and relative to
    the largest entry of what the step writes (the key and value or
    latent at the last position; the mamba layer's conv and SSM state,
    against prefill's over all the tokens); per MoE unit, the step's MoE
    half on the card against ``moe_apply`` on the CPU (float32, the
    same input: error over the MoE update, on the tokens routed alike)
    and the tokens routed differently (within a near tie of gates or
    not); and both paths' final logits at the last position."""
    f32, s = torch.float32, toks.shape[1]
    x = lm_embed(lm, toks, f32, "cuda")
    cache = lm.init_cache(toks.shape[0], s, dtype=f32)
    enc = None if frames is None else lm_encode(
        torch, lm, frames.float(), lm.cfg.n_enc_layers,
        lambda lp: unit_copy(torch, lp, "cuda", f32))
    out_err, kv_err, moe_err = [], [], []
    flips = bad_flips = 0
    with torch.no_grad():
        for u in lm_units(lm):
            lp = unit_copy(torch, u.lp, "cuda", f32)
            y, outs, mid = unit_full(lm, u, lp, x, enc)
            dst = u.slots(cache)
            if u.kind == "mamba":
                _, early, _ = unit_full(lm, u, lp, x[:, :s - 1])
                for d, t in zip(dst, early):
                    d.copy_(t)
                pairs = list(zip(dst, outs))
            else:
                for d, t in zip(dst[:2], outs):
                    d[:, :s - 1] = t[:, :s - 1]
                pairs = [(d[:, s - 1], t[:, s - 1])
                         for d, t in zip(dst[:2], outs)]
            yd, midd = unit_step(lm, u, lp, x[:, -1:], cache, s - 1)
            moe = hasattr(lp, "moe")
            whole = u.kind == "mamba" or (u.kind == "attn" and not moe)
            ref, got = (y, yd) if whole else (mid, midd)
            upd = (ref[:, -1] - x[:, -1]).abs().max()
            out_err.append(float((got[:, 0] - ref[:, -1]).abs().max() / upd))
            kv_err.append(max(float((d - t).abs().max() / t.abs().max())
                              for d, t in pairs))
            if moe:
                cpu_lp = unit_copy(torch, u.lp, "cpu", f32, ("ln2", "moe"),
                                   stage)
                m_card = lm._ffn(lp, midd).cpu()
                m_cpu = lm._ffn(cpu_lp, midd.cpu())
                r_card = moe_routing(lm, lp, midd)
                r_cpu = moe_routing(lm, cpu_lp, midd.cpu())
                n, bad = route_flips(torch, r_card, r_cpu)
                flips, bad_flips = flips + n, bad_flips + bad
                rows = (r_card[0].cpu() == r_cpu[0]).all(-1).reshape(
                    m_cpu.shape[:2])
                if rows.any():
                    upd = (m_cpu - midd.cpu())[rows].abs().max()
                    moe_err.append(float((m_card - m_cpu)[rows].abs().max()
                                         / upd))
                del cpu_lp
            x = y
            del lp
        heads = {}
        logits = lm_head_logits(torch, lm, x[:, -1:], heads)
        dlogits = lm_head_logits(torch, lm, yd, heads)
    return {"out_err": out_err, "kv_err": kv_err, "moe_err": moe_err,
            "route_flips": flips, "route_flips_outside_ties": bad_flips,
            "logits": logits, "dlogits": dlogits}


def lm_check_consistency(torch, lm, prompts, arch: str, stage) -> dict:
    """Phase 13, checks 1a and 1b (see LM_CONSIST_LEN): prefill against
    decode on the first LM_CONSIST_LEN prompt tokens (CPU copies through
    ``stage``)."""
    from repro_torch.core.popcount import argmax_tournament
    toks, fam = prompts[:, :LM_CONSIST_LEN], lm.cfg.family
    out = {}
    if fam != "encdec":
        # 1a: free-running at LM_FREE_DEPTH layers of the same weights,
        # gated but for moe (its decode capacity differs by design, R7)
        depth = lm_depth(lm.cfg, LM_FREE_DEPTH)
        dtype = getattr(torch, LM_FREE_DTYPE[fam])
        fr = lm_free_running(torch, lm, lm_first_units(lm, LM_FREE_DEPTH),
                             toks, dtype)
        fr["depth"], fr["dtype"], fr["gated"] = depth, LM_FREE_DTYPE[fam], \
            fam != "moe"
        if fr["gated"] and not fr["within"]:
            raise AssertionError(f"{arch} at {depth} layers: decode "
                                 f"picks beyond the near-tie rule: gaps "
                                 f"{fr['gaps']} > {fr['tols']}")
        # in float32 at full depth: the drift R5 cites, not gated (not
        # for moe, whose decode drifts from prefill by design, R7)
        out["free_gated"] = fr
        if fam != "moe":
            out["free_f32"] = lm_free_running(torch, lm, lm_units(lm), toks,
                                              torch.float32)
    frames = lm_frames(torch, lm, toks.shape[0], toks.shape[1]) \
        if fam == "encdec" else None
    tf = lm_teacher_forced(torch, lm, toks, stage, frames)
    g = argmax_tournament(tf["dlogits"]).long()
    r = argmax_tournament(tf["logits"]).long()
    rows = torch.arange(len(r), device=r.device)
    gap = (tf["logits"][rows, g] - tf["logits"][rows, r]).abs()
    # the final picks agree only where every unit's step computes what
    # its prefill computes (not across a MoE half or a cross-attention)
    picks_gated = fam not in ("moe", "encdec")
    moe_err = max(tf["moe_err"], default=0.0)
    out["teacher_forced_f32"] = {
        "units": len(tf["out_err"]),
        "max_layer_err": max(tf["out_err"]), "max_kv_err": max(tf["kv_err"]),
        "max_moe_err": moe_err, "moe_units": len(tf["moe_err"]),
        "route_flips": tf["route_flips"],
        "route_flips_outside_ties": tf["route_flips_outside_ties"],
        "exact": int((g == r).sum()), "max_gap": float(gap.max()),
        "picks_gated": picks_gated}
    if max(tf["out_err"]) > LM_LAYER_TOL or max(tf["kv_err"]) > LM_LAYER_TOL \
            or moe_err > LM_LAYER_TOL or tf["route_flips_outside_ties"] \
            or (picks_gated and not ((g == r) | (gap <= LM_F32_TOL[arch]))
                .all()):
        worst = max(range(len(tf["out_err"])), key=lambda i: tf["out_err"][i])
        raise AssertionError(
            f"{arch} teacher-forced float32: layer {worst} error "
            f"{tf['out_err'][worst]}, key/value error {max(tf['kv_err'])}, "
            f"MoE error {moe_err} (tol {LM_LAYER_TOL}), "
            f"{tf['route_flips_outside_ties']} routing flips outside a "
            f"near tie; picks {g.tolist()} vs {r.tolist()}, gaps "
            f"{gap.tolist()}")
    del tf
    torch.cuda.empty_cache()
    return out


def lm_serve_arch(torch, arch: str, card: str) -> dict:
    """Phase 13, one arch: the serving launcher's run at full width (the
    depth LM_LAYERS cuts it to, where it does not fit), then prefill and
    per-step decode times, the decode step's device kernels and bound,
    and checks 1 and 2."""
    from repro_torch.configs import get_config
    from repro_torch.engine.base import nearest_rank
    from repro_torch.launch.serve import run
    from repro_torch.models.common import count_params
    from repro_torch.roofline.analysis import lm_decode_bytes, lm_state_bytes

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(arch, batch=LM_BATCH, prompt_len=LM_PROMPT, max_new=LM_NEW,
              full=True, layers=LM_LAYERS.get(arch), device="cuda")
    build_s = time.perf_counter() - t0
    lm, prompts, out = res["lm"], res["prompts"], res["out"]
    c = lm.cfg
    print(res["line"], flush=True)
    if tuple(out.shape) != (LM_BATCH, LM_NEW) or int(out.min()) < 0 or \
            int(out.max()) >= c.vocab_size:
        raise AssertionError(f"{arch}: generated {tuple(out.shape)} tokens "
                             f"in [{int(out.min())}, {int(out.max())}]")
    n_params = count_params(lm)
    weight_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    depth = (f"{c.n_layers} layers" + (f" + {c.n_enc_layers} encoder layers"
                                       if c.n_enc_layers else ""))
    if arch in LM_LAYERS:
        depth += f" (cut from {get_config(arch).n_layers})"

    batch = {"tokens": prompts}
    if c.family == "encdec":
        batch["frames"] = lm_frames(torch, lm, LM_BATCH, LM_PROMPT)
    lm.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = []
    for _ in range(LM_PREFILL_REPS):
        t1 = time.perf_counter()
        tok, _ = lm.prefill(batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t1)

    total = LM_PROMPT + LM_NEW
    cache = lm.init_cache(LM_BATCH, total)
    step_s, last = [], prompts[:, :1]
    for pos in range(total):
        tok = prompts[:, pos:pos + 1] if pos < LM_PROMPT else last[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        last, cache = lm.decode_step(cache, tok, pos)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    step_s.sort()
    p50, p99 = (nearest_rank(step_s, q) * 1e3 for q in (0.50, 0.99))
    mid = total // 2
    names, busy_us, by_name = device_activity(torch, lambda: lm.decode_step(
        cache, last[:, None], mid))
    kernels = sum(1 for n in names if "memcpy" not in n.lower()
                  and "memset" not in n.lower())
    bound_ms = lm_decode_bytes(lm, LM_BATCH, mid, total) / HBM_BPS * 1e3
    top = [(n[:60], round(us, 3)) for n, us in by_name.most_common(5)]
    hit = None
    if c.n_experts:
        hit = experts_hit(torch, lambda: lm.decode_step(cache, last[:, None],
                                                         mid))
        hit_ms = lm_decode_bytes(lm, LM_BATCH, mid, total, hit) / HBM_BPS \
            * 1e3

    state_bytes = lm_state_bytes(lm, LM_BATCH)
    t1 = time.perf_counter()
    stage = HostStage(torch)
    checks = lm_check_consistency(torch, lm, prompts, arch, stage)
    t2 = time.perf_counter()
    checks.update(lm_check_f32(torch, lm, prompts, arch, stage))
    checks_s = {"1": t2 - t1, "2": time.perf_counter() - t2}
    del stage
    peak = torch.cuda.max_memory_allocated()
    row = {"arch": arch, "layers": c.n_layers,
           "enc_layers": c.n_enc_layers, "depth": depth,
           "params": n_params, "weight_bytes": weight_bytes,
           "decode_state_bytes": state_bytes,
           "init_and_launcher_s": build_s, "generate_ms": res["seconds"] * 1e3,
           "tok_per_s": res["tok_per_s"],
           "prefill_ms": statistics.median(prefill_s) * 1e3,
           "decode_step_p50_ms": p50, "decode_step_p99_ms": p99,
           "decode_steps": len(step_s),
           "device_activities_per_step": len(names),
           "device_kernels_per_step": kernels,
           "decode_device_busy_ms": busy_us / 1e3,
           "decode_device_idle_share": 1 - busy_us / 1e3 / p50,
           "decode_top_kernels_us": top,
           "decode_bound_ms": bound_ms, "decode_bound_by": "bytes",
           "decode_x_bound": p50 / bound_ms,
           "max_memory_allocated": peak, "checks_s": checks_s, **checks}
    experts = ""
    if hit is not None:
        row.update(experts_hit_per_layer=hit, decode_bound_hit_ms=hit_ms,
                   decode_x_bound_hit=p50 / hit_ms)
        experts = (f"; experts hit per MoE layer {hit} of {c.n_experts}: "
                   f"bound {hit_ms:.3f} ms (p50 = {p50 / hit_ms:.2f}x)")
    print(f"lm {arch}, {card}: {depth}, {n_params:,} params, "
          f"{weight_bytes:,} weight bytes; prefill ({LM_BATCH}, "
          f"{LM_PROMPT}) {row['prefill_ms']:.3f} ms; decode step p50/p99 "
          f"{p50:.3f} / {p99:.3f} ms over {len(step_s)} steps; "
          f"{row['tok_per_s']:.1f} tok/s generated; {kernels} device kernels "
          f"per step ({len(names)} activities) busy {busy_us / 1e3:.3f} ms "
          f"of the card (idle share "
          f"{row['decode_device_idle_share']:.3f} at p50); bound "
          f"{bound_ms:.3f} ms (bytes{', all experts' if hit else ''}; the "
          f"mamba state {state_bytes:,} B read and written), p50 = "
          f"{row['decode_x_bound']:.2f}x, device busy = "
          f"{busy_us / 1e3 / bound_ms:.2f}x{experts}; peak memory "
          f"{peak:,} bytes (init's float32 draw of the largest stacked leaf "
          f"included); top kernels (µs) {top}", flush=True)
    tf32 = checks["teacher_forced_f32"]
    if "free_gated" in checks:
        fr2 = checks["free_gated"]
        first = (f"1a free-running at {fr2['depth']} layers {fr2['dtype']} "
                 f"{'' if fr2['gated'] else '(printed, not gated: R7) '}"
                 f"{fr2['exact']}/{fr2['rows']} picks equal, max gap "
                 f"{fr2['max_gap']:.4f} vs {fr2['tol']:.4f}, max |logit "
                 f"diff| {fr2['max_abs_logit_diff']:.4f}")
    else:
        first = "1a skipped (encdec: decode never sees the encoder, R6)"
    moe = (f", MoE halves vs CPU moe_apply {tf32['max_moe_err']:.3g} over "
           f"{tf32['moe_units']} layers ({tf32['route_flips']} tokens routed "
           f"otherwise, {tf32['route_flips_outside_ties']} outside a near "
           f"tie)" if tf32["moe_units"] else "")
    print(f"lm {arch} checks: {first}; 1b teacher-forced "
          f"{tf32['units']} layers float32 (one layer's copy at a time): "
          f"max layer error {tf32['max_layer_err']:.3g}"
          f"{'' if tf32['picks_gated'] else ' (attention half)'}, key/value,"
          f" latent or state {tf32['max_kv_err']:.3g} <= {LM_LAYER_TOL}"
          f"{moe}, picks {tf32['exact']}/{LM_BATCH} equal"
          f"{'' if tf32['picks_gated'] else ' (not gated)'}; 2 float32 "
          f"{checks['f32_units']} units card vs CPU max |logit err| "
          f"{checks['f32_max_abs_err']:.3g} <= {checks['f32_tol']} "
          f"({checks['f32_near_tie_flips']} near-tie flips, "
          f"{checks['f32_route_flips']} routing flips in "
          f"{checks['f32_routed_calls']} MoE calls), TF32 control "
          f"{checks['tf32_control_err']:.3g} > {checks['f32_tol']}; hidden "
          f"error by unit {[f'{e:.3g}' for e in checks['f32_unit_err']]}; "
          f"checks 1 and 2 took {checks_s['1']:.1f} / {checks_s['2']:.1f} s "
          f"after {build_s:.1f} s of init and launcher",
          flush=True)
    if "free_f32" in checks:
        frl = checks["free_f32"]
        print(f"lm {arch} float32 free-running at full depth (R5, not "
              f"gated): {frl['exact']}/{frl['rows']} picks equal, max "
              f"|logit diff| {frl['max_abs_logit_diff']:.4f}; hidden drift "
              f"by depth (max |prefill - decode| / max |prefill| at the "
              f"last position) {frl['drift']}", flush=True)
    del lm, res, cache
    torch.cuda.empty_cache()
    return row


def lm_oversize(torch, arch: str) -> str:
    """``launch.serve.run(arch, full=True)`` for a config that does not
    fit the card must raise ``torch.OutOfMemoryError`` naming its weight
    bytes → the message."""
    import gc
    from repro_torch.launch.serve import run
    msg = None
    try:
        run(arch, max_new=1, full=True, device="cuda")
    except torch.OutOfMemoryError as e:
        msg = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    if msg is None or "bytes of bfloat16 weights" not in msg:
        raise AssertionError(f"{arch} --full: {msg!r}")
    return msg


def lm_phase(torch, card: str) -> dict:
    """Phase 13: the LM zoo's families served at full width on cuda.
    It reaches none of the port's CUDA kernels: their counters are zeroed
    before and must read 0 after."""
    launch0 = launch_counts(COUNTED)
    t0 = time.perf_counter()
    oversize = lm_oversize(torch, LM_OVERSIZE)
    print(f"lm {LM_OVERSIZE} --full: {oversize}", flush=True)
    rows = [lm_serve_arch(torch, arch, card) for arch in LM_ARCHS]
    launched = {k: v for k, v in launch_counts(COUNTED, launch0).items()
                if v}
    if launched:
        raise AssertionError(f"the LM path launched TM kernels: {launched}")
    wall = time.perf_counter() - t0
    print(f"phase 13 (LM serving) wall {wall:.1f}s, {card}", flush=True)
    print(json.dumps({"lm_serving": rows, "card": card, "wall_s": wall,
                      "oversize": oversize}), flush=True)
    return {"rows": rows, "wall_s": wall}


def train_flops(lm, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6·N·T for the N parameters that
    enter matrix products (all but the embedding table, which is
    gathered) over T = batch·seq tokens, plus attention's score and
    value products (4·B·S²·hq·D a layer forward, the full S×S the port
    computes; backward twice forward)."""
    c, a = lm.cfg, lm.attn_cfg
    n = sum(p.numel() for p in lm.parameters()) - lm.embed.numel()
    attn = 3 * c.n_layers * 4 * batch * seq * seq * a.hq * a.head_dim
    return 6.0 * n * batch * seq + attn


def fit_fixed_batch(torch, lm, batch) -> dict:
    """LM_TRAIN_FIT_STEPS train steps of ``lm`` on ``batch`` from fresh
    moments at peak lr LM_TRAIN_FIT_LR, no warmup, clip 1 → the losses
    and gradient norms (phase 14's gate 2)."""
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    fit = make_train_step(lm, TrainHParams(
        peak_lr=LM_TRAIN_FIT_LR, warmup=0, total_steps=LM_TRAIN_FIT_STEPS))
    st, losses, norms = init_train_state(lm.params), [], []
    for _ in range(LM_TRAIN_FIT_STEPS):
        st, m = fit(st, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


def train_timed(torch, card: str) -> dict:
    """Phase 14 at full width: LM_TRAIN_WARM + LM_TRAIN_TIMED steps of
    the launcher's setup (host clock per step, ending in a sync), one
    step's device kernels and busy time, then gate 2 on the first
    LM_TRAIN_F32_LAYERS layers of its weights."""
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, lm_token_stream
    from repro_torch.engine.base import nearest_rank
    from repro_torch.launch.train import STREAM_TOKENS
    from repro_torch.models.model import LM
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_TRAIN_ARCH)
    lm = LM(cfg, device="cuda", dtype=torch.bfloat16, trainable=True)
    lm.init(torch.Generator(device="cuda").manual_seed(0))
    n_steps = LM_TRAIN_WARM + LM_TRAIN_TIMED
    step = make_train_step(lm, TrainHParams(total_steps=n_steps + 2))
    state = init_train_state(lm.params)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      ttree.leaves((lm.params, lm.grads, state.opt.mu,
                                    state.opt.nu)))
    stream = lm_token_stream(STREAM_TOKENS, cfg.vocab_size, seed=0)
    loader = ShardedLoader(stream, global_batch=LM_TRAIN_BATCH,
                           seq_len=LM_TRAIN_SEQ)
    times, losses, metrics = [], [], {}
    try:
        batches = [dict(zip(("tokens", "targets"), next(loader)))
                   for _ in range(n_steps)]
    finally:
        loader.close()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        if i >= LM_TRAIN_WARM:
            times.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    names, busy_us, by_name = device_activity(
        torch, lambda: step(state, batches[-1]))
    kernels = sum(1 for n in names if "memcpy" not in n.lower()
                  and "memset" not in n.lower())
    times.sort()
    p50, p99 = (nearest_rank(times, q) for q in (0.50, 0.99))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = train_flops(lm, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    peak = torch.cuda.max_memory_allocated()
    top = [(n[:60], round(us, 3)) for n, us in by_name.most_common(5)]
    row = {"arch": LM_TRAIN_ARCH, "params": sum(p.numel() for p in
                                                 lm.parameters()),
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "step_p50_ms": p50 * 1e3, "step_p99_ms": p99 * 1e3,
           "timed_steps": len(times), "tokens_per_s": tokens / p50,
           "model_flops_per_step": flops,
           "model_flops_share_of_bf16_peak": flops / p50 / BF16_FLOPS,
           "masters_grads_moments_bytes": state_bytes,
           "max_memory_allocated": peak,
           "device_kernels_per_step": kernels,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / (p50 * 1e3),
           "top_kernels_us": top, "losses": losses,
           "grad_norm": float(metrics["grad_norm"]),
           "lr": float(metrics["lr"])}
    print(f"train {LM_TRAIN_ARCH}, {card}: {row['params']:,} params; "
          f"masters + gradients + AdamW moments {state_bytes:,} bytes, "
          f"peak memory {peak:,} bytes; ({LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}) "
          f"step p50/p99 {p50 * 1e3:.3f} / {p99 * 1e3:.3f} ms over "
          f"{len(times)} steps, {tokens / p50:,.0f} tokens/s; model FLOPs "
          f"{flops:.4g} a step = {row['model_flops_share_of_bf16_peak']:.4f} "
          f"of the bf16 dense peak ({BF16_FLOPS:.4g} FLOP/s) at p50; "
          f"{kernels} device kernels a step, busy {busy_us / 1e3:.3f} ms "
          f"(idle share {row['device_idle_share']:.3f}); top kernels (µs) "
          f"{top}; losses {[round(x, 4) for x in losses]}", flush=True)
    # gate 2: the first LM_TRAIN_F32_LAYERS layers of the same weights fit
    # one fixed batch from fresh moments
    del state, metrics, step
    import dataclasses
    sub = LM(dataclasses.replace(cfg, n_layers=LM_TRAIN_F32_LAYERS),
             device="cuda", dtype=torch.bfloat16, trainable=True)
    want = sub.state_dict()
    sub.load_state_dict({k: v for k, v in lm.state_dict().items()
                         if k in want})
    del lm
    fit = fit_fixed_batch(torch, sub, batches[0])
    print(f"train gate 2: {LM_TRAIN_FIT_STEPS} steps on one batch at peak "
          f"lr {LM_TRAIN_FIT_LR} (clip 1.0), {LM_TRAIN_F32_LAYERS} layers: "
          f"losses {[round(x, 4) for x in fit['losses']]}, grad norms "
          f"{[round(x, 4) for x in fit['grad_norms']]}", flush=True)
    got = fit["losses"]
    if not (all(np.isfinite(got)) and got[-1] < got[0] - LM_TRAIN_FIT_DROP):
        raise AssertionError(f"gate 2: the loss did not fall by "
                             f"{LM_TRAIN_FIT_DROP}: {got}")
    row["fit"] = fit
    del sub
    torch.cuda.empty_cache()
    return row


def train_check_f32(torch) -> dict:
    """Phase 14, gate 1: one train step at published widths truncated to
    LM_TRAIN_F32_LAYERS layers, float32, on the card and on the CPU; the
    same card step with TF32 on is the control (its gradients must land
    farther from the CPU's than LM_TRAIN_GRAD_TOL)."""
    import dataclasses
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.models.common import flatten_defs
    from repro_torch.models.model import LM
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: float32 products would round")
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              n_layers=LM_TRAIN_F32_LAYERS)
    cpu = LM(cfg, device="cpu", dtype=torch.float32, trainable=True)
    cpu.init(torch.Generator().manual_seed(1))
    init = {k: v.detach().clone() for k, v in cpu.state_dict().items()}
    rng = np.random.default_rng(SEED)
    batch = {k: rng.integers(0, cfg.vocab_size, (LM_TRAIN_F32_BATCH,
                                                 LM_TRAIN_F32_SEQ), np.int32)
             for k in ("tokens", "targets")}
    hp = TrainHParams(peak_lr=LM_TRAIN_F32_LR, warmup=0, total_steps=10)

    def one_step(lm):
        _, m = make_train_step(lm, hp)(init_train_state(lm.params), batch)
        return {k: float(v) for k, v in m.items()}

    def card_step():
        dev = LM(cfg, device="cuda", dtype=torch.float32, trainable=True)
        dev.load_state_dict(init)
        return dev, one_step(dev)

    names = ["/".join(p) for p, _ in flatten_defs(cpu.param_defs())]

    def grad_errs(dev):
        return {n: float((g.cpu() - w).abs().max() / w.abs().max())
                for n, g, w in zip(names, ttree.leaves(dev.grads),
                                   ttree.leaves(cpu.grads))}

    lr, tol = LM_TRAIN_F32_LR, LM_TRAIN_GRAD_TOL
    before = [t.detach().clone() for t in ttree.leaves(cpu.params)]

    def param_errs(dev):
        """→ the mean |card − CPU| over the updated parameters, and the
        entries whose CPU gradient lies farther from 0 than ``tol`` of
        its leaf's largest yet stepped another way on the card."""
        total, n, flips = 0.0, 0, 0
        for p, w, p0, g in zip(ttree.leaves(dev.params),
                               ttree.leaves(cpu.params), before,
                               ttree.leaves(cpu.grads)):
            p = p.detach().cpu()
            total += float((p - w.detach()).abs().sum())
            n += p.numel()
            sure = g.abs() > tol * g.abs().max()
            flips += int(((p - p0).sign() != (w.detach() - p0).sign())
                          [sure].sum())
        return total / n, flips

    cm = one_step(cpu)
    dev, dm = card_step()
    errs = grad_errs(dev)
    p_mean, flips = param_errs(dev)
    del dev
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl_dev, ctl_m = card_step()
        ctl = max(grad_errs(ctl_dev).values())
        ctl_p_mean, _ = param_errs(ctl_dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del ctl_dev
    grad_err = max(errs.values())
    norm_err = abs(dm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
    row = {"loss": (dm["loss"], cm["loss"]),
           "grad_norm": (dm["grad_norm"], cm["grad_norm"]),
           "grad_rel_err_by_leaf": errs, "grad_max_rel_err": grad_err,
           "tf32_control_grad_err": ctl,
           "tf32_control_grad_norm": ctl_m["grad_norm"],
           "param_mean_abs_diff": p_mean, "param_sign_flips": flips,
           "tf32_control_param_mean_abs_diff": ctl_p_mean}
    print(f"train gate 1, {LM_TRAIN_F32_LAYERS} layers float32 card vs CPU: "
          f"loss {dm['loss']:.7f} / {cm['loss']:.7f}, grad_norm "
          f"{dm['grad_norm']:.6f} / {cm['grad_norm']:.6f} (rel {norm_err:.3g}"
          f" <= {tol}), max gradient error {grad_err:.3g} of the leaf's "
          f"largest (<= {tol}; by leaf "
          f"{ {n: float(f'{e:.3g}') for n, e in errs.items()} }), TF32 "
          f"control {ctl:.3g} (> {tol}; its grad_norm "
          f"{ctl_m['grad_norm']:.6f}), updated parameters mean |diff| "
          f"{p_mean:.3g} (<= {1e-2 * lr:.3g}; TF32 control "
          f"{ctl_p_mean:.3g}), {flips} entries with a gradient past the "
          f"limit stepped against the CPU's (0 allowed)", flush=True)
    if abs(dm["loss"] - cm["loss"]) > 1e-5 * abs(cm["loss"]) or \
            norm_err > tol or grad_err > tol or ctl <= tol or \
            p_mean > 1e-2 * lr or flips:
        raise AssertionError(f"gate 1: card vs CPU train step {row}")
    del cpu, init
    torch.cuda.empty_cache()
    return row


def train_check_recovery(torch) -> dict:
    """Phase 14, gate 3: ``launch.train.run`` at reduced width on cuda,
    unbroken and killed once (the step at LM_TRAIN_KILL_AT raises, the
    run restores its latest checkpoint and replays), bitwise equal."""
    import repro_torch.train.step as step_mod
    from repro_torch import tree as ttree
    from repro_torch.launch.train import run
    real = step_mod.make_train_step
    crashed = []

    def crashing(lm, hp):
        inner = real(lm, hp)

        def train_step(state, batch):
            if int(state.step) == LM_TRAIN_KILL_AT and not crashed:
                crashed.append(int(state.step))
                raise RuntimeError("simulated node failure")
            return inner(state, batch)
        return train_step

    kw = dict(steps=LM_TRAIN_KILL_STEPS, ckpt_every=LM_TRAIN_KILL_EVERY,
              device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        whole = run(LM_TRAIN_ARCH, ckpt_dir=os.path.join(tmp, "whole"), **kw)
        step_mod.make_train_step = crashing
        try:
            killed = run(LM_TRAIN_ARCH, ckpt_dir=os.path.join(tmp, "killed"),
                         **kw)
        finally:
            step_mod.make_train_step = real
    def differ(x, y):
        return {i: float((p.float() - q.float()).abs().max()
                         / q.float().abs().max().clamp(min=1e-30))
                for i, (p, q) in enumerate(zip(ttree.leaves(x),
                                               ttree.leaves(y)))
                if not torch.equal(p, q)}
    k, w = killed["state"], whole["state"]
    exact = differ((k.params, k.step, k.opt.count),
                   (w.params, w.step, w.opt.count))
    moments = differ((k.opt.mu, k.opt.nu), (w.opt.mu, w.opt.nu))
    row = {"crashed_at": crashed, "steps_run": len(killed["losses"]),
           "treedef_equal": ttree.flatten(k)[1] == ttree.flatten(w)[1],
           "params_step_count_differing": exact,
           "moments_differing_rel": moments, "final_step": int(k.step)}
    print(f"train gate 3, {whole['cfg'].name} on cuda: killed at step "
          f"{crashed}, {len(killed['losses'])} steps run for "
          f"{LM_TRAIN_KILL_STEPS}; parameters, step and count differing "
          f"from the unbroken run's: {exact or 'none (bitwise)'}; AdamW "
          f"moments differing (relative): {moments or 'none (bitwise)'}",
          flush=True)
    if not crashed or exact or not row["treedef_equal"] or \
            any(v > 1e-6 for v in moments.values()) or \
            row["final_step"] != LM_TRAIN_KILL_STEPS or \
            len(killed["losses"]) <= LM_TRAIN_KILL_STEPS:
        raise AssertionError(f"gate 3: {row}")
    return row


def train_phase(torch, card: str) -> dict:
    """Phase 14: LM training on cuda.  It reaches none of the port's CUDA
    kernels: their counters are zeroed before and must read 0 after."""
    launch0 = launch_counts(COUNTED)
    t0 = time.perf_counter()
    row = train_timed(torch, card)
    row["gate1"] = train_check_f32(torch)
    row["gate3"] = train_check_recovery(torch)
    launched = {k: v for k, v in launch_counts(COUNTED, launch0).items()
                if v}
    if launched:
        raise AssertionError(f"the LM training path launched TM kernels: "
                             f"{launched}")
    wall = time.perf_counter() - t0
    print(f"phase 14 (LM training) wall {wall:.1f}s, {card}", flush=True)
    print(json.dumps({"lm_training": row, "card": card, "wall_s": wall}),
          flush=True)
    return row


def mesh_members(torch, mesh) -> str:
    """Which devices a mesh's members are, for the phase's lines."""
    devs = mesh.distinct_devices()
    if len(devs) == mesh.size:
        return f"{mesh.size} distinct GPUs"
    return f"{', '.join(str(d) for d in devs)} listed {mesh.size} times " \
        f"(members run one after another: extra launches and copies, " \
        f"not a speedup)"


def copy_weights(src, dst) -> None:
    """Every leaf of the unsharded ``src`` into ``dst`` (sliced where
    ``dst`` is sharded)."""
    from repro_torch.models.common import flatten_defs
    for path, _ in flatten_defs(src.param_defs()):
        leaf = src.params
        for k in path:
            leaf = leaf[k]
        dst.load_leaf(path, leaf)


def decode_times(torch, lm, prompts, n_new: int) -> tuple:
    """Host time of every decode step (with a sync) of a greedy run over
    ``prompts`` and ``n_new`` generated tokens → (p50 ms, p99 ms)."""
    from repro_torch.engine.base import nearest_rank
    b, s = prompts.shape
    cache = lm.init_cache(b, s + n_new)
    times, last = [], None
    for pos in range(s + n_new):
        tok = prompts[:, pos:pos + 1] if pos < s else last[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = lm.decode_step(cache, tok, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return nearest_rank(times, 0.50) * 1e3, nearest_rank(times, 0.99) * 1e3


def mesh_check_layers(torch, mesh, prompts) -> dict:
    """Phase 15, the serving checks at LM_MESH_LAYERS layers: float32
    logits and bfloat16 lockstep picks, sharded against unsharded."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.popcount import argmax_tournament
    from repro_torch.models.model import LM
    cfg = dataclasses.replace(get_config(LM_MESH_ARCH),
                              n_layers=LM_MESH_LAYERS)
    tp = mesh.shape["model"]
    out = {}
    flat = LM(cfg, tp=tp, device="cuda", dtype=torch.float32)
    flat.init(torch.Generator(device="cuda").manual_seed(0))
    shard = LM(cfg, tp=tp, mesh=mesh, dtype=torch.float32)
    copy_weights(flat, shard)
    v = cfg.vocab_size           # the padded columns are -1e30 on both
    with torch.no_grad():
        want = flat._logits(flat._forward(prompts)[0])[..., :v]
        got = shard._mesh_exec().logits({"tokens": prompts})[..., :v]
        # the control: the mesh's products in TF32 must land above the limit
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ctl = float((shard._mesh_exec().logits({"tokens": prompts})
                         [..., :v] - want).abs().max())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    err = (got - want).abs()
    atol = LM_MESH_ATOL * max(1.0, float(want.abs().max()))
    ratio = float((err / (atol + LM_MESH_RTOL * want.abs())).max())
    tol = LM_F32_TOL[LM_MESH_ARCH]
    out.update(f32_max_abs_err=float(err.max()),
               f32_max_abs_logit=float(want.abs().max()),
               f32_err_over_test_tol=ratio, f32_tol=tol,
               tf32_control_err=ctl)
    if not torch.isfinite(got).all() or float(err.max()) > tol or ctl <= tol:
        raise AssertionError(f"mesh float32 logits: max |err| "
                             f"{float(err.max())} (limit {tol}; "
                             f"{ratio} of the CPU test's tolerance), TF32 "
                             f"control {ctl} (must exceed {tol})")
    del flat, shard, want, got, err
    flat = LM(cfg, tp=tp, device="cuda", dtype=torch.bfloat16)
    flat.init(torch.Generator(device="cuda").manual_seed(0))
    shard = LM(cfg, tp=tp, mesh=mesh, dtype=torch.bfloat16)
    copy_weights(flat, shard)
    b, s = prompts.shape
    cf, cs = flat.init_cache(b, s + LM_NEW), shard.init_cache(b, s + LM_NEW)
    rows = torch.arange(b, device="cuda")
    tok, exact, steps, worst = prompts[:, :1], 0, 0, 0.0
    for pos in range(s + LM_NEW - 1):
        lg = flat._logits(flat._decode_hidden(cf, tok, pos))[:, 0]
        pick = argmax_tournament(lg).long()
        got, _ = shard.decode_step(cs, tok, pos)
        got = got.long()
        top = lg[:, :v].max(-1).values
        gap = top - lg[rows, got]
        tol = LM_TIE_ULPS * bf16_ulp(torch, top)
        worst = max(worst, float((gap / tol).max()))
        if not (gap <= tol).all():
            raise AssertionError(f"mesh bfloat16 step {pos}: picks "
                                 f"{got.tolist()} vs {pick.tolist()}, "
                                 f"gaps {gap.tolist()} > {tol.tolist()}")
        exact += int((got == pick).sum())
        steps += b
        tok = prompts[:, pos + 1:pos + 2] if pos + 1 < s else pick[:, None]
    out.update(bf16_exact=exact, bf16_picks=steps,
               bf16_worst_gap_over_tol=worst)
    del flat, shard, cf, cs
    torch.cuda.empty_cache()
    return out


def mesh_stored_bytes(lm, cache, batch: int) -> list:
    """Bytes each member holds: its parameter shards, decode-cache shards
    and token rows."""
    from repro_torch import tree as ttree
    rows = lm._mesh_exec()._rows(batch)
    out = []
    for k in range(lm.mesh.size):
        n = sum(t.nbytes(k) for t in ttree.leaves(lm.params))
        n += sum(t.nbytes(k) for t in ttree.leaves(cache))
        out.append(n + len(range(batch)[rows[k]]) * 4)
    return out


def mesh_train_check(torch, mesh) -> dict:
    """Phase 15, training: one float32 step at LM_TRAIN_F32_LAYERS layers
    on the mesh against the unsharded step on the card, under phase 14's
    gate-1 bounds."""
    import dataclasses
    from repro_torch import tree as ttree
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              n_layers=LM_TRAIN_F32_LAYERS)
    tp = mesh.shape["model"]
    flat = LM(cfg, tp=tp, device="cuda", dtype=torch.float32, trainable=True)
    flat.init(torch.Generator(device="cuda").manual_seed(1))
    shard = LM(cfg, tp=tp, mesh=mesh, dtype=torch.float32, trainable=True)
    copy_weights(flat, shard)
    before = [t.detach().clone() for t in ttree.leaves(flat.params)]
    rng = np.random.default_rng(SEED)
    batch = {k: rng.integers(0, cfg.vocab_size, (LM_TRAIN_F32_BATCH,
                                                 LM_TRAIN_F32_SEQ), np.int32)
             for k in ("tokens", "targets")}
    hp = TrainHParams(peak_lr=LM_TRAIN_F32_LR, warmup=0, total_steps=10)
    fm = {k: float(v) for k, v in make_train_step(flat, hp)(
        init_train_state(flat.params), batch)[1].items()}
    sm = {k: float(v) for k, v in make_train_step(shard, hp)(
        init_train_state(shard.params), batch)[1].items()}
    tol, lr = LM_TRAIN_GRAD_TOL, LM_TRAIN_F32_LR
    grad_err, total, n, flips = 0.0, 0.0, 0, 0
    for g, w, p, q, p0 in zip(ttree.leaves(shard.grads),
                              ttree.leaves(flat.grads),
                              ttree.leaves(shard.params),
                              ttree.leaves(flat.params), before):
        g = g.gather("cuda")
        grad_err = max(grad_err, float((g - w).abs().max() / w.abs().max()))
        p, q = p.gather("cuda"), q.detach()
        total += float((p - q).abs().sum())
        n += p.numel()
        sure = w.abs() > tol * w.abs().max()
        flips += int(((p - p0).sign() != (q - p0).sign())[sure].sum())
    norm_err = abs(sm["grad_norm"] - fm["grad_norm"]) / fm["grad_norm"]
    row = {"loss": (sm["loss"], fm["loss"]),
           "grad_norm": (sm["grad_norm"], fm["grad_norm"]),
           "grad_max_rel_err": grad_err, "param_mean_abs_diff": total / n,
           "param_sign_flips": flips}
    if abs(sm["loss"] - fm["loss"]) > 1e-5 * abs(fm["loss"]) or \
            norm_err > tol or grad_err > tol or total / n > 1e-2 * lr or \
            flips:
        raise AssertionError(f"mesh train step vs unsharded: {row}")
    del flat, shard, before
    torch.cuda.empty_cache()
    return row


def lm_mesh_phase(torch, card: str) -> dict:
    """Phase 15: the LM mesh (LM_MESH's comment).  Its counters of K1–K6
    are zeroed before and must read 0 after."""
    from repro_torch import tree as ttree
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data import ShardedLoader, lm_token_stream
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.engine.base import nearest_rank
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.serve import run
    from repro_torch.launch.train import STREAM_TOKENS
    from repro_torch.models.model import LM
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    launch0 = launch_counts(COUNTED)
    t0 = time.perf_counter()
    res = run(LM_MESH_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
              max_new=LM_NEW, full=True, device="cuda", mesh=LM_MESH)
    lm, mesh, prompts, out = res["lm"], res["mesh"], res["prompts"], \
        res["out"]
    where = mesh_members(torch, mesh)
    print(f"{res['line']} on a {mesh.dims} mesh of {where}; {card}",
          flush=True)
    if tuple(out.shape) != (LM_BATCH, LM_NEW) or int(out.min()) < 0 or \
            int(out.max()) >= lm.cfg.vocab_size:
        raise AssertionError(f"mesh serve: tokens {tuple(out.shape)} "
                             f"{int(out.min())}..{int(out.max())}")
    row = {"arch": LM_MESH_ARCH, "mesh": list(mesh.dims), "members": where,
           "serve_line": res["line"]}
    row.update(mesh_check_layers(torch, mesh, prompts))
    # each member's storage against the dry-run's argument bytes
    cache_len = LM_PROMPT + LM_NEW
    stored = mesh_stored_bytes(lm, lm.init_cache(LM_BATCH, cache_len),
                               LM_BATCH)
    meta = Mesh((torch.device("meta"),) * mesh.size, mesh.axis_names,
                mesh.dims)
    rec = dryrun.run_cell(LM_MESH_ARCH, "serve", False, roofline=False,
                          cfg=lm.cfg, mesh=meta,
                          shape=ShapeSpec("serve", cache_len, LM_BATCH,
                                          "decode"))
    want = rec["memory"]["bytes"]["argument"]
    row["member_bytes"], row["dryrun_argument_bytes"] = stored, want
    if any(n != want for n in stored):
        raise AssertionError(f"mesh members hold {stored} bytes, the "
                             f"dry-run's argument is {want}")
    # decode steps at full depth, sharded and unsharded
    flat = LM(lm.cfg, tp=lm.tp, device="cuda", dtype=torch.bfloat16)
    flat.init(torch.Generator(device="cuda").manual_seed(0))
    p50, p99 = decode_times(torch, lm, prompts, LM_NEW)
    f50, f99 = decode_times(torch, flat, prompts, LM_NEW)
    row.update(decode_p50_ms=p50, decode_p99_ms=p99,
               unsharded_decode_p50_ms=f50, unsharded_decode_p99_ms=f99)
    print(f"lm mesh {LM_MESH_ARCH}, {card}: {mesh.dims} mesh of {where}; "
          f"float32 at {LM_MESH_LAYERS} layers max |logit err| "
          f"{row['f32_max_abs_err']:.3g} (<= {row['f32_tol']}; TF32 control "
          f"{row['tf32_control_err']:.3g}; {row['f32_err_over_test_tol']:.3g}"
          f" of the CPU test's tolerance at max |logit| "
          f"{row['f32_max_abs_logit']:.3g}), bfloat16 picks {row['bf16_exact']}/"
          f"{row['bf16_picks']} exact, all within the near-tie rule; each "
          f"member stores {stored[0]:,} bytes == the dry-run's argument "
          f"bytes; decode step p50/p99 {p50:.2f}/{p99:.2f} ms sharded, "
          f"{f50:.2f}/{f99:.2f} ms unsharded", flush=True)
    del res, lm, flat
    torch.cuda.empty_cache()

    row["train_check"] = mesh_train_check(torch, mesh)
    cfg = get_config(LM_TRAIN_ARCH)
    tlm = LM(cfg, tp=mesh.shape["model"], mesh=mesh, dtype=torch.bfloat16,
             trainable=True)
    tlm.init(torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(tlm, TrainHParams(total_steps=10))
    state = init_train_state(tlm.params)
    loader = ShardedLoader(lm_token_stream(STREAM_TOKENS, cfg.vocab_size,
                                           seed=0),
                           global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ)
    times, losses = [], []
    try:
        for _ in range(LM_MESH_TRAIN_STEPS):
            batch = dict(zip(("tokens", "targets"), next(loader)))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
    finally:
        loader.close()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"mesh train losses {losses}")
    times.sort()
    row.update(train_step_p50_ms=nearest_rank(times, 0.5) * 1e3,
               train_losses=losses,
               train_state_bytes_per_member=sum(
                   t.nbytes(0) for t in ttree.leaves(
                       (tlm.params, tlm.grads, state.opt.mu,
                        state.opt.nu))))
    del tlm, state, step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        small = train_launch.run(LM_TRAIN_ARCH, steps=2, device="cuda",
                                 mesh=LM_MESH, ckpt_dir=tmp, ckpt_every=1)
    row["train_launcher_losses"] = small["losses"]
    print(f"lm mesh train {LM_TRAIN_ARCH}, {card}: float32 step at "
          f"{LM_TRAIN_F32_LAYERS} layers mesh vs unsharded {row['train_check']};"
          f" {LM_MESH_TRAIN_STEPS} bfloat16 steps at published width on the "
          f"mesh: p50 {row['train_step_p50_ms']:.1f} ms, losses {losses}, "
          f"{row['train_state_bytes_per_member']:,} bytes of masters, "
          f"gradients and moments per member; launch.train --mesh "
          f"{LM_MESH} at reduced width: losses {small['losses']}",
          flush=True)
    launched = {k: v for k, v in launch_counts(COUNTED, launch0).items()
                if v}
    if launched:
        raise AssertionError(f"the LM mesh path launched TM kernels: "
                             f"{launched}")
    wall = time.perf_counter() - t0
    print(f"phase 15 (LM mesh) wall {wall:.1f}s, {card}", flush=True)
    print(json.dumps({"lm_mesh": row, "card": card, "wall_s": wall}),
          flush=True)
    return row


def moe_mesh_f32(torch, mesh, arch: str, prompts) -> dict:
    """Phase 15b, float32: the mesh's logits over ``prompts`` against the
    unsharded model's on the card (LM_MOE_MESH's comment), the unsharded
    copy freed before the mesh computes (a deepseek pair at 2 layers is
    42.8 GB, and each member gathers its experts' embed halves)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models.model import LM
    full = arch == "deepseek-v2-236b"
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=LM_MOE_MESH_F32_LAYERS) if full \
        else reduced(get_config(arch))
    prompts = prompts % cfg.vocab_size
    tp = mesh.shape["model"]
    flat = LM(cfg, tp=tp, device="cuda", dtype=torch.float32)
    flat.init(torch.Generator(device="cuda").manual_seed(1))
    shard = LM(cfg, tp=tp, mesh=mesh, dtype=torch.float32)
    copy_weights(flat, shard)
    v = cfg.vocab_size
    with torch.no_grad():
        want = flat._logits(flat._forward(prompts)[0])[..., :v]
    del flat
    torch.cuda.empty_cache()
    ex = shard._mesh_exec()
    got = ex.logits({"tokens": prompts})[..., :v]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = ex.logits({"tokens": prompts})[..., :v]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    atol = LM_MESH_ATOL * max(1.0, float(want.abs().max()))

    def over(x):
        return float(((x - want).abs() / (atol + LM_MESH_RTOL
                                          * want.abs())).max())
    err, ctl_err = float((got - want).abs().max()), \
        float((ctl - want).abs().max())
    row = {"f32_config": f"{cfg.n_layers} layers" + ("" if full else
                                                     ", reduced width"),
           "f32_max_abs_err": err, "f32_max_abs_logit":
           float(want.abs().max()), "f32_err_over_test_tol": over(got),
           "tf32_control_err": ctl_err,
           "tf32_control_over_test_tol": over(ctl)}
    if full:
        tol = LM_F32_TOL[arch]
        row["f32_tol"] = tol
        ok = err <= tol < ctl_err
    else:
        row["f32_tol"] = "tests/test_torch_lm_moe_mesh.py's"
        ok = row["f32_err_over_test_tol"] <= 1.0 < \
            row["tf32_control_over_test_tol"]
    if not torch.isfinite(got).all() or not ok:
        raise AssertionError(f"{arch} mesh float32 logits: {row}")
    del shard, ex, want, got, ctl
    torch.cuda.empty_cache()
    return row


def moe_mesh_lockstep(torch, lm, prompts, cache_len: int) -> dict:
    """Phase 15b, bfloat16: the mesh ``lm`` and an unsharded copy of its
    weights decode in lockstep (both fed the unsharded model's picks),
    each step timed with a sync; each MoE layer's expert choices on the
    mesh held against the unsharded model's (LM_MOE_MESH's comment)."""
    from repro_torch.core.popcount import argmax_tournament
    from repro_torch.engine.base import nearest_rank
    from repro_torch.models import moe as moe_module
    from repro_torch.models import sharded
    from repro_torch.models.model import LM
    flat = LM(lm.cfg, tp=lm.tp, device="cuda", dtype=torch.bfloat16)
    flat.init(torch.Generator(device="cuda").manual_seed(0))
    routes = {"mesh": [], "flat": []}
    real = moe_module.moe_route

    def recorder(key):
        def route(c, router, xt):
            r = real(c, router, xt)
            # each token's experts ascending and whether each kept its slot
            routes[key].append((r.top_i.sort(-1).values, r.gates,
                                r.keep[moe_module.combine_order(r)]))
            return r
        return route
    b, s = prompts.shape
    cf, cs = flat.init_cache(b, cache_len), lm.init_cache(b, cache_len)
    rows = torch.arange(b, device="cuda")
    v = lm.cfg.vocab_size
    tok, exact, gated, worst = prompts[:, :1], 0, 0, 0.0
    flips = unexplained = first = 0
    left = torch.zeros(b, dtype=torch.bool)     # rows out of the pick rule
    t_mesh, t_flat = [], []
    moe_module.moe_route = recorder("flat")
    sharded.moe_route = recorder("mesh")
    try:
        for pos in range(s + LM_MOE_MESH_NEW - 1):
            routes["mesh"].clear()
            routes["flat"].clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg = flat._logits(flat._decode_hidden(cf, tok, pos))[:, 0]
            pick = argmax_tournament(lg).long()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got, _ = lm.decode_step(cs, tok, pos)
            torch.cuda.synchronize()
            t_flat.append(t1 - t0)
            t_mesh.append(time.perf_counter() - t1)
            if len(routes["mesh"]) != len(routes["flat"]):
                raise AssertionError(f"step {pos}: the mesh routed "
                                     f"{len(routes['mesh'])} times, the "
                                     f"unsharded model "
                                     f"{len(routes['flat'])}")
            was = left.clone()
            for g_r, w_r in zip(routes["mesh"], routes["flat"]):
                n, out = route_flips(torch, g_r[:2], w_r[:2])
                flips += n
                unexplained += out
                flipped = (g_r[0] != w_r[0]).any(-1).cpu()
                first += int((flipped & ~was).sum())
                # a flip moves other rows' tokens past their experts'
                # capacity (R7): a row whose choice or slots differ leaves
                left |= flipped | (g_r[2] != w_r[2]).any(-1).cpu()
            got = got.long()
            top = lg[:, :v].max(-1).values
            gap = top - lg[rows, got]
            tol = LM_TIE_ULPS * bf16_ulp(torch, top)
            inside = (~left).to(gap.device)
            if inside.any():
                worst = max(worst, float((gap / tol)[inside].max()))
            if unexplained or not (gap <= tol)[inside].all():
                raise AssertionError(
                    f"mesh bfloat16 step {pos}: picks {got.tolist()} vs "
                    f"{pick.tolist()}, gaps {gap.tolist()} > "
                    f"{tol.tolist()}; {unexplained} expert flips outside "
                    f"a near tie")
            exact += int((got == pick).sum())
            gated += int(inside.sum())
            tok = prompts[:, pos + 1:pos + 2] if pos + 1 < s else \
                pick[:, None]
    finally:
        moe_module.moe_route = real
        sharded.moe_route = real
    del flat, cf, cs
    torch.cuda.empty_cache()
    t_mesh.sort()
    t_flat.sort()
    return {"bf16_exact": exact, "bf16_picks": len(t_mesh) * b,
            "bf16_gated_picks": gated, "bf16_worst_gap_over_tol": worst,
            "route_flips": flips, "route_flips_outside_tie": unexplained,
            "route_flips_in_lockstep_rows": first,
            "rows_left_after_a_flip": int(left.sum()),
            "decode_p50_ms": nearest_rank(t_mesh, 0.50) * 1e3,
            "decode_p99_ms": nearest_rank(t_mesh, 0.99) * 1e3,
            "unsharded_decode_p50_ms": nearest_rank(t_flat, 0.50) * 1e3,
            "unsharded_decode_p99_ms": nearest_rank(t_flat, 0.99) * 1e3}


def lm_moe_mesh_phase(torch, card: str) -> dict:
    """Phase 15b: the moe family on the LM mesh (LM_MOE_MESH's comment).
    Its counters of K1–K6 are zeroed before and must read 0 after."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import run
    launch0 = launch_counts(COUNTED)
    t0 = time.perf_counter()
    rows = {}
    for arch, layers in LM_MOE_MESH_LAYERS.items():
        cache_len = LM_MOE_MESH_CACHE.get(arch,
                                          LM_MOE_MESH_PROMPT + LM_MOE_MESH_NEW)
        res = run(arch, batch=LM_BATCH, prompt_len=LM_MOE_MESH_PROMPT,
                  max_new=LM_MOE_MESH_NEW, full=True, layers=layers,
                  device="cuda", mesh=LM_MESH, cache_len=cache_len)
        lm, mesh, prompts, out = res["lm"], res["mesh"], res["prompts"], \
            res["out"]
        where = mesh_members(torch, mesh)
        print(f"{res['line']} on a {mesh.dims} mesh of {where} (cache "
              f"{cache_len}); {card}", flush=True)
        if tuple(out.shape) != (LM_BATCH, LM_MOE_MESH_NEW) or \
                int(out.min()) < 0 or int(out.max()) >= lm.cfg.vocab_size:
            raise AssertionError(f"{arch} mesh serve: tokens "
                                 f"{tuple(out.shape)} "
                                 f"{int(out.min())}..{int(out.max())}")
        cache = lm.init_cache(LM_BATCH, cache_len)
        split = [(name, tuple(st.sharding.spec))
                 for name, st in _named_leaves(cache)]
        stored = mesh_stored_bytes(lm, cache, LM_BATCH)
        del cache
        meta = Mesh((torch.device("meta"),) * mesh.size, mesh.axis_names,
                    mesh.dims)
        rec = dryrun.run_cell(arch, "serve", False, roofline=False,
                              cfg=lm.cfg, mesh=meta,
                              shape=ShapeSpec("serve", cache_len, LM_BATCH,
                                              "decode"))
        want = rec["memory"]["bytes"]["argument"]
        if any(n != want for n in stored):
            raise AssertionError(f"{arch} mesh members hold {stored} bytes, "
                                 f"the dry-run's argument is {want}")
        row = {"arch": arch, "layers": lm.cfg.n_layers,
               "published_layers": get_config(arch).n_layers,
               "mesh": list(mesh.dims), "members": where,
               "serve_line": res["line"], "cache_len": cache_len,
               "cache_specs": split, "member_bytes": stored,
               "dryrun_argument_bytes": want}
        row.update(moe_mesh_lockstep(torch, lm, prompts, cache_len))
        del res, lm, out
        torch.cuda.empty_cache()
        row.update(moe_mesh_f32(torch, mesh, arch, prompts))
        rows[arch] = row
        print(f"lm moe mesh {arch} at {row['layers']} of "
              f"{row['published_layers']} layers, {card}: {mesh.dims} mesh "
              f"of {where}; cache {cache_len} ({split}); float32 "
              f"({row['f32_config']}) max |logit err| "
              f"{row['f32_max_abs_err']:.3g} ({row['f32_err_over_test_tol']:.3g}"
              f" of the CPU test's tolerance; limit {row['f32_tol']}; TF32 "
              f"control {row['tf32_control_err']:.3g}, "
              f"{row['tf32_control_over_test_tol']:.3g} of it); bfloat16 "
              f"picks {row['bf16_exact']}/{row['bf16_picks']} exact, "
              f"{row['bf16_gated_picks']} held to the near-tie rule (worst "
              f"{row['bf16_worst_gap_over_tol']:.3g} of it), expert flips "
              f"{row['route_flips']} ({row['route_flips_in_lockstep_rows']} "
              f"in rows still in lockstep; outside a near tie "
              f"{row['route_flips_outside_tie']}); each member stores "
              f"{stored[0]:,} bytes == the dry-run's argument bytes; decode "
              f"step p50/p99 {row['decode_p50_ms']:.2f}/"
              f"{row['decode_p99_ms']:.2f} ms sharded, "
              f"{row['unsharded_decode_p50_ms']:.2f}/"
              f"{row['unsharded_decode_p99_ms']:.2f} ms unsharded",
              flush=True)
    launched = {k: v for k, v in launch_counts(COUNTED, launch0).items()
                if v}
    if launched:
        raise AssertionError(f"the LM moe mesh path launched TM kernels: "
                             f"{launched}")
    wall = time.perf_counter() - t0
    print(f"phase 15b (LM moe mesh) wall {wall:.1f}s, {card}", flush=True)
    print(json.dumps({"lm_moe_mesh": rows, "card": card, "wall_s": wall}),
          flush=True)
    return rows


def ssm_mesh_cut(torch, mesh, arch: str, prompts, cache_len: int) -> dict:
    """Phase 15c at the cut depth LM_SSM_MESH_CUT gives: the mesh's
    float32 logits over ``prompts`` (seamless: and seeded frames)
    against the unsharded model's on the card, and a TF32 control; then
    in LM_SSM_MESH_CUT_DTYPE[arch] the lockstep decode and (seamless) the
    prefill with frames, gated by the near-tie rule."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    cfg = dataclasses.replace(get_config(arch), **LM_SSM_MESH_CUT[arch])
    tp = mesh.shape["model"]
    flat = LM(cfg, tp=tp, device="cuda", dtype=torch.float32)
    flat.init(torch.Generator(device="cuda").manual_seed(1))
    shard = LM(cfg, tp=tp, mesh=mesh, dtype=torch.float32)
    copy_weights(flat, shard)
    inputs = {"tokens": prompts}
    if cfg.family == "encdec":
        inputs["frames"] = lm_frames(torch, flat, *prompts.shape)
    v = cfg.vocab_size
    with torch.no_grad():
        want = flat._logits(flat._forward(
            prompts, frames=inputs.get("frames"))[0])[..., :v]
    del flat
    ex = shard._mesh_exec()
    got = ex.logits(inputs)[..., :v]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = ex.logits(inputs)[..., :v]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    atol = LM_MESH_ATOL * max(1.0, float(want.abs().max()))

    def over(x):
        return float(((x - want).abs() / (atol + LM_MESH_RTOL
                                          * want.abs())).max())
    tol = LM_F32_TOL[arch]
    err, ctl_err = float((got - want).abs().max()), \
        float((ctl - want).abs().max())
    row = {"cut_config": ", ".join(f"{k} {n}" for k, n in
                                   LM_SSM_MESH_CUT[arch].items()),
           "f32_max_abs_err": err, "f32_max_abs_logit":
           float(want.abs().max()), "f32_err_over_test_tol": over(got),
           "f32_tol": tol, "tf32_control_err": ctl_err,
           "tf32_control_over_test_tol": over(ctl)}
    if not torch.isfinite(got).all() or not err <= tol < ctl_err:
        raise AssertionError(f"{arch} mesh float32 logits: {row}")
    del shard, ex, want, got, ctl
    dtype = LM_SSM_MESH_CUT_DTYPE[arch]
    flat = LM(cfg, tp=tp, device="cuda", dtype=getattr(torch, dtype))
    flat.init(torch.Generator(device="cuda").manual_seed(1))
    shard = LM(cfg, tp=tp, mesh=mesh, dtype=getattr(torch, dtype))
    copy_weights(flat, shard)
    if cfg.family == "encdec":
        got = ssm_mesh_prefill(torch, shard, flat, prompts, gate=True)
        row["cut_prefill_worst_gap_over_tol"] = \
            got["prefill_worst_gap_over_tol"]
    got = ssm_mesh_lockstep(torch, shard, flat, prompts, cache_len,
                            gate=True)
    row["cut_lockstep_dtype"] = dtype
    row.update({f"cut_lockstep_{k[5:]}": got[k] for k in
                ("bf16_exact", "bf16_picks", "bf16_worst_gap_over_tol")})
    del shard, flat
    torch.cuda.empty_cache()
    return row


def ssm_mesh_lockstep(torch, lm, flat, prompts, cache_len: int,
                      gate: bool) -> dict:
    """Phase 15c, bfloat16: the mesh ``lm`` and the unsharded ``flat``
    (the same weights) decode in lockstep, both fed the unsharded
    model's picks, each step timed with a sync; with ``gate`` the mesh's
    picks must keep phase 13's near-tie rule, else their agreement is
    counted and printed (R5)."""
    from repro_torch.core.popcount import argmax_tournament
    from repro_torch.engine.base import nearest_rank
    b, s = prompts.shape
    cf, cs = flat.init_cache(b, cache_len), lm.init_cache(b, cache_len)
    rows = torch.arange(b, device="cuda")
    v = lm.cfg.vocab_size
    tok, exact, worst = prompts[:, :1], 0, 0.0
    t_mesh, t_flat = [], []
    for pos in range(cache_len - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = flat._logits(flat._decode_hidden(cf, tok, pos))[:, 0]
        pick = argmax_tournament(lg).long()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, _ = lm.decode_step(cs, tok, pos)
        torch.cuda.synchronize()
        t_flat.append(t1 - t0)
        t_mesh.append(time.perf_counter() - t1)
        got = got.long()
        top = lg[:, :v].max(-1).values
        gap = top - lg[rows, got]
        tol = LM_TIE_ULPS * bf16_ulp(torch, top)
        worst = max(worst, float((gap / tol).max()))
        if gate and not (gap <= tol).all():
            raise AssertionError(f"mesh bfloat16 step {pos}: picks "
                                 f"{got.tolist()} vs {pick.tolist()}, "
                                 f"gaps {gap.tolist()} > {tol.tolist()}")
        exact += int((got == pick).sum())
        tok = prompts[:, pos + 1:pos + 2] if pos + 1 < s else pick[:, None]
    del cf, cs
    t_mesh.sort()
    t_flat.sort()
    return {"bf16_exact": exact, "bf16_picks": len(t_mesh) * b,
            "bf16_worst_gap_over_tol": worst,
            "decode_p50_ms": nearest_rank(t_mesh, 0.50) * 1e3,
            "decode_p99_ms": nearest_rank(t_mesh, 0.99) * 1e3,
            "unsharded_decode_p50_ms": nearest_rank(t_flat, 0.50) * 1e3,
            "unsharded_decode_p99_ms": nearest_rank(t_flat, 0.99) * 1e3}


def ssm_mesh_prefill(torch, lm, flat, prompts, gate: bool) -> dict:
    """Phase 15c, seamless's prefill with seeded frames on the mesh
    (timed with a sync) and unsharded: the mesh's tokens in range, its
    cross cache's shape, and (``gate``) its tokens under the near-tie
    rule against the unsharded bfloat16 logits, else their worst gap
    printed (R5)."""
    frames = lm_frames(torch, lm, *prompts.shape)
    inputs = {"tokens": prompts, "frames": frames}
    v = lm.cfg.vocab_size
    with torch.no_grad():
        lg = flat._logits(flat._forward(prompts, frames=frames)[0][:, -1:]
                          )[:, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, cache = lm.prefill(inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = got.long()
    rows = torch.arange(prompts.shape[0], device="cuda")
    top = lg[:, :v].max(-1).values
    gap = top - lg[rows, got]
    tol = LM_TIE_ULPS * bf16_ulp(torch, top)
    (kv, xkv) = cache
    if (gate and not (gap <= tol).all()) or int(got.min()) < 0 or \
            int(got.max()) >= v or tuple(xkv[0].shape[2:4]) != \
            (frames.shape[1], lm.attn_cfg.hkv):
        raise AssertionError(f"seamless mesh prefill: picks {got.tolist()},"
                             f" gaps {gap.tolist()} (rule {tol.tolist()}); "
                             f"cross cache {xkv[0].shape}")
    return {"prefill_ms": ms, "prefill_frames": list(frames.shape),
            "prefill_worst_gap_over_tol": float((gap / tol).max())}


def lm_ssm_mesh_phase(torch, card: str) -> dict:
    """Phase 15c: the ssm, hybrid and encdec families on the LM mesh
    (LM_SSM_MESH's comment).  Its counters of K1–K6 are zeroed before
    and must read 0 after."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import run
    from repro_torch.models.model import LM
    launch0 = launch_counts(COUNTED)
    t0 = time.perf_counter()
    rows = {}
    cache_len = LM_MOE_MESH_PROMPT + LM_MOE_MESH_NEW
    for arch in LM_SSM_MESH:
        res = run(arch, batch=LM_BATCH, prompt_len=LM_MOE_MESH_PROMPT,
                  max_new=LM_MOE_MESH_NEW, full=True, device="cuda",
                  mesh=LM_MESH)
        lm, mesh, prompts, out = res["lm"], res["mesh"], res["prompts"], \
            res["out"]
        where = mesh_members(torch, mesh)
        print(f"{res['line']} on a {mesh.dims} mesh of {where}; {card}",
              flush=True)
        if tuple(out.shape) != (LM_BATCH, LM_MOE_MESH_NEW) or \
                int(out.min()) < 0 or int(out.max()) >= lm.cfg.vocab_size:
            raise AssertionError(f"{arch} mesh serve: tokens "
                                 f"{tuple(out.shape)} "
                                 f"{int(out.min())}..{int(out.max())}")
        cache = lm.init_cache(LM_BATCH, cache_len)
        split = [(name, tuple(st.sharding.spec))
                 for name, st in _named_leaves(cache)]
        stored = mesh_stored_bytes(lm, cache, LM_BATCH)
        del cache
        meta = Mesh((torch.device("meta"),) * mesh.size, mesh.axis_names,
                    mesh.dims)
        cell = ShapeSpec("serve", cache_len, LM_BATCH, "decode")
        rec = dryrun.run_cell(arch, "serve", False, roofline=False,
                              cfg=lm.cfg, mesh=meta, shape=cell)
        want = rec["memory"]["bytes"]["argument"]
        if any(n != want for n in stored):
            raise AssertionError(f"{arch} mesh members hold {stored} bytes, "
                                 f"the dry-run's argument is {want}")
        row = {"arch": arch, "layers": lm.cfg.n_layers,
               "mesh": list(mesh.dims), "members": where,
               "serve_line": res["line"], "cache_len": cache_len,
               "cache_specs": split, "member_bytes": stored,
               "dryrun_argument_bytes": want,
               "dryrun_collective_bytes": dryrun.collective_bytes(
                   dryrun.make_lm(lm.cfg, cell, meta), cell)}
        flat = LM(lm.cfg, tp=lm.tp, device="cuda", dtype=torch.bfloat16)
        flat.init(torch.Generator(device="cuda").manual_seed(0))
        if lm.cfg.family == "encdec":
            row.update(ssm_mesh_prefill(torch, lm, flat, prompts,
                                        gate=False))
        row.update(ssm_mesh_lockstep(torch, lm, flat, prompts, cache_len,
                                     gate=False))
        del res, lm, flat, out
        torch.cuda.empty_cache()
        row.update(ssm_mesh_cut(torch, mesh, arch, prompts, cache_len))
        rows[arch] = row
        print(f"lm ssm mesh {arch} at {row['layers']} layers, {card}: "
              f"{mesh.dims} mesh of {where}; cache {cache_len} ({split}); "
              f"at {row['cut_config']}: float32 max |logit err| "
              f"{row['f32_max_abs_err']:.3g} (limit {row['f32_tol']}; "
              f"{row['f32_err_over_test_tol']:.3g} of the CPU test's "
              f"tolerance; TF32 control {row['tf32_control_err']:.3g}, "
              f"{row['tf32_control_over_test_tol']:.3g} of it), "
              f"{row['cut_lockstep_dtype']} lockstep picks "
              f"{row['cut_lockstep_exact']}/{row['cut_lockstep_picks']} "
              f"exact, all within the near-tie rule (worst "
              f"{row['cut_lockstep_worst_gap_over_tol']:.3g} of it)"
              + (f", prefill with frames within it (worst "
                 f"{row['cut_prefill_worst_gap_over_tol']:.3g})"
                 if "cut_prefill_worst_gap_over_tol" in row else "")
              + f"; at full depth, not gated (R5): bfloat16 lockstep picks "
              f"{row['bf16_exact']}/{row['bf16_picks']} exact, worst gap "
              f"{row['bf16_worst_gap_over_tol']:.3g} of the rule"
              + (f", prefill with frames {row['prefill_frames']} "
                 f"{row['prefill_ms']:.2f} ms, worst gap "
                 f"{row['prefill_worst_gap_over_tol']:.3g} of the rule"
                 if "prefill_ms" in row else "")
              + f"; each member stores {stored[0]:,} bytes == the dry-run's "
              f"argument bytes (collective {row['dryrun_collective_bytes']:,.0f}"
              f" bytes a step by the dry-run's count); decode step p50/p99 "
              f"{row['decode_p50_ms']:.2f}/{row['decode_p99_ms']:.2f} ms "
              f"sharded, {row['unsharded_decode_p50_ms']:.2f}/"
              f"{row['unsharded_decode_p99_ms']:.2f} ms unsharded",
              flush=True)
    launched = {k: v for k, v in launch_counts(COUNTED, launch0).items()
                if v}
    if launched:
        raise AssertionError(f"the LM ssm mesh path launched TM kernels: "
                             f"{launched}")
    wall = time.perf_counter() - t0
    print(f"phase 15c (LM ssm / hybrid / encdec mesh) wall {wall:.1f}s, "
          f"{card}", flush=True)
    print(json.dumps({"lm_ssm_mesh": rows, "card": card, "wall_s": wall}),
          flush=True)
    return rows


def cut_config(arch: str, cut: dict, reduced_width: bool = False):
    """``arch``'s config (``configs/reduce.py``'s with ``reduced_width``)
    with the fields of ``cut`` replaced."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    cfg = get_config(arch)
    return dataclasses.replace(reduced(cfg) if reduced_width else cfg, **cut)


def n_params(torch, cfg) -> int:
    """The parameters of ``cfg``, from its ParamDef shapes (nothing
    allocated)."""
    from repro_torch.models.common import flatten_defs
    from repro_torch.models.model import LM
    lm = LM(cfg, device=torch.device("meta"), dtype=torch.bfloat16)
    return sum(int(np.prod(d.shape)) for _, d in
               flatten_defs(lm.param_defs()))


def train_batches(cfg, n: int, batch: int, seq: int) -> list:
    """``n`` batches of the training launcher's token stream and loader at
    (batch, seq), with seeded frames (batch, seq // enc_len_ratio,
    d_model) for the encdec family (the launcher feeds none, R10)."""
    from repro_torch.data import ShardedLoader, lm_token_stream
    from repro_torch.launch.train import STREAM_TOKENS
    loader = ShardedLoader(lm_token_stream(STREAM_TOKENS, cfg.vocab_size,
                                           seed=0),
                           global_batch=batch, seq_len=seq)
    rng = np.random.default_rng(SEED)
    out = []
    try:
        for _ in range(n):
            b = dict(zip(("tokens", "targets"), next(loader)))
            if cfg.family == "encdec":
                b["frames"] = rng.normal(0, 1, (
                    batch, seq // cfg.enc_len_ratio, cfg.d_model)).astype(
                        np.float32)
            out.append(b)
    finally:
        loader.close()
    return out


def f32_batch(cfg, batch: int = LM_TRAIN_F32_BATCH,
              seq: int = LM_TRAIN_F32_SEQ) -> dict:
    """Phase 14's gate-1 batch: seeded tokens and targets (and frames)."""
    rng = np.random.default_rng(SEED)
    out = {k: rng.integers(0, cfg.vocab_size, (batch, seq), np.int32)
           for k in ("tokens", "targets")}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (
            batch, seq // cfg.enc_len_ratio, cfg.d_model)).astype(np.float32)
    return out


class routes_logged:
    """While active, every ``moe_route`` call (unsharded or on a mesh)
    logs its expert choice (sorted top-k per token) and gates on the host,
    in call order (a remat recompute logs again, in the same order on
    every device)."""

    def __init__(self):
        self.log = []

    def __enter__(self):
        from repro_torch.models import moe, sharded
        self.real = real = moe.moe_route

        def logging(c, router, xt):
            r = real(c, router, xt)
            self.log.append((r.top_i.detach().sort(-1).values.cpu(),
                             r.gates.detach().cpu()))
            return r
        moe.moe_route = sharded.moe_route = logging
        return self.log

    def __exit__(self, *exc):
        from repro_torch.models import moe, sharded
        moe.moe_route = sharded.moe_route = self.real


def _host(t):
    """A copy of an unsharded parameter or gradient leaf on the host."""
    return t.detach().to("cpu", copy=True)


def _whole(t):
    """A leaf whole on the card: a sharded one gathered."""
    from repro_torch.distributed.sharding import ShardedTensor
    return t.gather("cuda") if isinstance(t, ShardedTensor) else t.detach()


def train_step_compare(torch, ref_make, dev_make, batch, *,
                       gate_control: bool,
                       tol: float = LM_TRAIN_GRAD_TOL) -> dict:
    """One float32 train step of the same weights on ``ref_make()`` (the
    reference: the CPU, or the unsharded model on the card) and on
    ``dev_make()`` (the card, or the mesh), one after the other: the
    reference's initial weights, gradients and updated parameters are
    parked on the host and it is freed before the other is built and
    loaded with those weights.  Phase 14's gate-1 bounds at the gradient
    limit ``tol``; every routing's expert choices by ``route_flips``;
    then the control, ``dev_make()`` with TF32 products, whose gradients
    must land past ``tol`` where ``gate_control``."""
    from repro_torch import tree as ttree
    from repro_torch.models.common import flatten_defs
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: float32 products would round")
    hp = TrainHParams(peak_lr=LM_TRAIN_F32_LR, warmup=0, total_steps=10)
    lr = LM_TRAIN_F32_LR
    ref = ref_make()
    r9 = ref.cfg.n_experts and ref.cfg.top_k == 1
    paths = [p for p, _ in flatten_defs(ref.param_defs())]
    p0 = [_host(t) for t in ttree.leaves(ref.params)]
    with routes_logged() as want_routes:
        # only the metrics are kept: the returned state holds the
        # reference's parameters and moments
        m = make_train_step(ref, hp)(init_train_state(ref.params), batch)[1]
    ref_m = {k: float(v) for k, v in m.items()}
    g_ref = [_host(t) for t in ttree.leaves(ref.grads)]
    p_ref = [_host(t) for t in ttree.leaves(ref.params)]
    del ref, m
    torch.cuda.empty_cache()

    def run_dev():
        lm = dev_make()
        for path, t in zip(paths, p0):
            lm.load_leaf(path, t)
        with routes_logged() as routes:
            m = make_train_step(lm, hp)(init_train_state(lm.params),
                                        batch)[1]
        return lm, {k: float(v) for k, v in m.items()}, routes

    def grad_errs(lm) -> dict:
        out = {}
        for path, g, w in zip(paths, ttree.leaves(lm.grads), g_ref):
            if r9 and path[-1] == "router":        # rounding only (R9)
                continue
            g, w = _whole(g), w.to("cuda")
            out["/".join(path)] = float((g.float() - w).abs().max()
                                        / w.abs().max().clamp(min=1e-30))
        return out

    lm, dev_m, got_routes = run_dev()
    errs = grad_errs(lm)
    total, n, flips, r9_max = 0.0, 0, 0, 0.0
    for path, t, g, w, q, s0 in zip(paths, ttree.leaves(lm.params),
                                    ttree.leaves(lm.grads), g_ref, p_ref,
                                    p0):
        p = _whole(t).float()
        q, s0, w = q.to("cuda"), s0.to("cuda"), w.to("cuda")
        total += float((p - q).abs().sum())
        n += p.numel()
        if r9 and path[-1] == "router":
            g = _whole(g)
            r9_max = max(r9_max, float(g.abs().max()), float(w.abs().max()))
            continue
        sure = w.abs() > tol * w.abs().max()
        flips += int(((p - s0).sign() != (q - s0).sign())[sure].sum())
    if len(got_routes) != len(want_routes):
        raise AssertionError(f"{len(got_routes)} routings against "
                             f"{len(want_routes)}")
    rflips = [route_flips(torch, g, w) for g, w in zip(got_routes,
                                                        want_routes)]
    del lm
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl_lm, ctl_m, _ = run_dev()
        ctl = max(grad_errs(ctl_lm).values())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del ctl_lm
    torch.cuda.empty_cache()
    grad_err = max(errs.values())
    norm_err = abs(dev_m["grad_norm"] - ref_m["grad_norm"]) / \
        ref_m["grad_norm"]
    worst = max(errs, key=errs.get)
    row = {"loss": (dev_m["loss"], ref_m["loss"]),
           "grad_norm": (dev_m["grad_norm"], ref_m["grad_norm"]),
           "grad_norm_rel_err": norm_err, "grad_max_rel_err": grad_err,
           "grad_worst_leaf": worst, "param_mean_abs_diff": total / n,
           "param_sign_flips": flips, "routings": len(rflips),
           "route_flips": sum(f for f, _ in rflips),
           "route_flips_outside_ties": sum(o for _, o in rflips),
           "grad_rel_err_by_leaf": errs,
           "grad_tol": tol, "tf32_control_grad_err": ctl,
           "tf32_control_gated": gate_control,
           **({"r9_router_max_abs_grad": r9_max} if r9 else {})}
    finite = all(np.isfinite(v) for v in (*errs.values(), *ref_m.values(),
                                          *dev_m.values(), total, ctl))
    bad = not finite or \
        abs(dev_m["loss"] - ref_m["loss"]) > 1e-5 * abs(ref_m["loss"]) \
        or norm_err > tol or grad_err > tol or total / n > 1e-2 * lr or \
        flips or row["route_flips_outside_ties"] or r9_max > LM_R9_ABS or \
        (gate_control and ctl <= tol)
    if bad:
        raise AssertionError(f"float32 train step against the reference: "
                             f"{row}")
    return row


def perturbation_spread(torch, make, batch: dict, draws: int) -> dict:
    """Per leaf of ``make()``'s float32 gradient of ``loss`` on ``batch``
    on the card, the largest change (of the leaf's largest entry) over
    ``draws`` seeded perturbations of every parameter by
    1 + 1e-7·N(0, 1): how far rounding-sized changes move them."""
    from repro_torch import tree as ttree
    from repro_torch.models.common import flatten_defs
    lm = make()
    names = ["/".join(p) for p, _ in flatten_defs(lm.param_defs())]
    params = ttree.leaves(lm.params)
    base = [t.detach().clone() for t in params]
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    def grads() -> list:
        for g in ttree.leaves(lm.grads):
            g.zero_()
        lm.loss(batch)[0].backward()
        return [g.detach().clone() for g in ttree.leaves(lm.grads)]
    want, out = grads(), dict.fromkeys(names, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for _ in range(draws):
        with torch.no_grad():
            for t, b in zip(params, base):
                t.copy_(b * (1 + 1e-7 * torch.randn(
                    b.shape, generator=gen, device="cuda")))
        for name, g, w in zip(names, grads(), want):
            out[name] = max(out[name], float((g - w).abs().max()
                                             / w.abs().max().clamp(
                                                 min=1e-30)))
    del lm, params, base, want
    torch.cuda.empty_cache()
    return out


def train_step_line(row: dict) -> str:
    """One gate-1 reading as a phrase of a phase's line."""
    return (f"loss {row['loss'][0]:.7f} / {row['loss'][1]:.7f}, grad_norm "
            f"rel {row['grad_norm_rel_err']:.3g}, max gradient error "
            f"{row['grad_max_rel_err']:.3g} of the leaf's largest "
            f"({row['grad_worst_leaf']}; <= {row['grad_tol']}), parameters "
            f"mean |diff| {row['param_mean_abs_diff']:.3g} (<= "
            f"{1e-2 * LM_TRAIN_F32_LR:.3g}), {row['param_sign_flips']} sign "
            f"flips past the limit, {row['route_flips']} expert flips in "
            f"{row['routings']} routings ({row['route_flips_outside_ties']} "
            f"outside a near tie)"
            + (f", R9 routers |g| <= {row['r9_router_max_abs_grad']:.3g}"
               if "r9_router_max_abs_grad" in row else "")
            + f"; TF32 control {row['tf32_control_grad_err']:.3g}"
            + (f" (> {row['grad_tol']})" if row["tf32_control_gated"]
               else " (printed, not gated)"))


def train_timed_arch(torch, arch: str, card: str) -> dict:
    """Phase 14b for one model at its LM_TRAIN_MOE_CUT: the timed steps,
    one step's device activity, then gate 2 at LM_TRAIN_MOE_FIT."""
    from repro_torch import tree as ttree
    from repro_torch.configs import ShapeSpec
    from repro_torch.engine.base import nearest_rank
    from repro_torch.models.model import LM
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    cfg = cut_config(arch, LM_TRAIN_MOE_CUT[arch])
    n = n_params(torch, cfg)
    cut = LM_TRAIN_MOE_CUT[arch] or "whole"
    print(f"train {arch} ({cut}): {n:,} parameters from the ParamDef shapes,"
          f" {16 * n:,} bytes of float32 masters, gradients and AdamW "
          f"moments", flush=True)
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda", dtype=torch.bfloat16, trainable=True)
    lm.init(torch.Generator(device="cuda").manual_seed(0))
    n_steps = LM_TRAIN_WARM + LM_TRAIN_MOE_TIMED
    step = make_train_step(lm, TrainHParams(total_steps=n_steps + 2))
    state = init_train_state(lm.params)
    batches = train_batches(cfg, n_steps, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    times, losses = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        if i >= LM_TRAIN_WARM:
            times.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} train losses {losses}")
    names, busy_us, by_name = device_activity(
        torch, lambda: step(state, batches[-1]))
    kernels = sum(1 for nm in names if "memcpy" not in nm.lower()
                  and "memset" not in nm.lower())
    times.sort()
    p50, p99 = (nearest_rank(times, q) for q in (0.50, 0.99))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = model_flops(cfg, ShapeSpec("train", LM_TRAIN_SEQ,
                                       LM_TRAIN_BATCH, "train"))
    peak = torch.cuda.max_memory_allocated()
    top = [(nm[:60], round(us, 3)) for nm, us in by_name.most_common(5)]
    row = {"arch": arch, "cut": LM_TRAIN_MOE_CUT[arch], "params": n,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "step_p50_ms": p50 * 1e3, "step_p99_ms": p99 * 1e3,
           "timed_steps": len(times), "tokens_per_s": tokens / p50,
           "model_flops_per_step": flops,
           "model_flops_share_of_bf16_peak": flops / p50 / BF16_FLOPS,
           "masters_grads_moments_bytes": sum(
               t.numel() * t.element_size() for t in ttree.leaves(
                   (lm.params, lm.grads, state.opt.mu, state.opt.nu))),
           "max_memory_allocated": peak, "device_kernels_per_step": kernels,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / (p50 * 1e3),
           "top_kernels_us": top, "losses": losses}
    print(f"train {arch}, {card}: {n:,} params ({cut}); masters + "
          f"gradients + AdamW moments {row['masters_grads_moments_bytes']:,}"
          f" bytes, peak memory {peak:,} bytes; ({LM_TRAIN_BATCH}, "
          f"{LM_TRAIN_SEQ}) step p50/p99 {p50 * 1e3:.3f} / {p99 * 1e3:.3f} ms"
          f" over {len(times)} steps, {tokens / p50:,.0f} tokens/s; model "
          f"FLOPs {flops:.4g} a step (6·N_active·T) = "
          f"{row['model_flops_share_of_bf16_peak']:.4f} of the bf16 dense "
          f"peak at p50; {kernels} device kernels a step, busy "
          f"{busy_us / 1e3:.3f} ms (idle share {row['device_idle_share']:.3f})"
          f"; top kernels (µs) {top}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    # gate 2: 2 layers of the same weights fit one fixed batch
    del state, metrics, step
    fit_cut = LM_TRAIN_MOE_FIT[arch]
    if fit_cut:
        sub = LM(cut_config(arch, {**LM_TRAIN_MOE_CUT[arch], **fit_cut}),
                 device="cuda", dtype=torch.bfloat16, trainable=True)
        want = sub.state_dict()
        sub.load_state_dict({k: v for k, v in lm.state_dict().items()
                             if k in want})
        del lm
    else:
        sub = lm
        for g in ttree.leaves(sub.grads):
            g.zero_()
    fit = fit_fixed_batch(torch, sub, batches[0])
    print(f"train {arch} gate 2: {LM_TRAIN_FIT_STEPS} steps on one batch at "
          f"peak lr {LM_TRAIN_FIT_LR} (clip 1.0), {fit_cut or cut}: losses "
          f"{[round(x, 4) for x in fit['losses']]}, grad norms "
          f"{[round(x, 4) for x in fit['grad_norms']]}", flush=True)
    got = fit["losses"]
    if not (all(np.isfinite(got)) and got[-1] < got[0] - LM_TRAIN_FIT_DROP):
        raise AssertionError(f"{arch} gate 2: the loss did not fall by "
                             f"{LM_TRAIN_FIT_DROP}: {got}")
    row["fit"] = fit
    del sub
    torch.cuda.empty_cache()
    return row


def train_moe_phase(torch, card: str) -> dict:
    """Phase 14b: the moe and encdec families training (LM_TRAIN_MOE's
    comment).  K1–K6's counters are zeroed before and must read 0
    after."""
    from repro_torch.models.model import LM
    launch0 = launch_counts(COUNTED)
    t0 = time.perf_counter()
    rows = {arch: train_timed_arch(torch, arch, card)
            for arch in LM_TRAIN_MOE}
    gate1 = {}
    for arch in LM_TRAIN_MOE_F32:
        cfg = cut_config(arch, {}, reduced_width=True)

        def ref_make():
            return LM(cfg, device="cpu", dtype=torch.float32,
                      trainable=True).init(torch.Generator().manual_seed(1))

        def dev_make():
            return LM(cfg, device="cuda", dtype=torch.float32, trainable=True)
        gate1[arch] = train_step_compare(torch, ref_make, dev_make,
                                         f32_batch(cfg), gate_control=True)
        print(f"train gate 1, {cfg.name} float32 card vs CPU: "
              f"{train_step_line(gate1[arch])}", flush=True)
    launched = {k: v for k, v in launch_counts(COUNTED, launch0).items()
                if v}
    if launched:
        raise AssertionError(f"the moe / encdec training path launched TM "
                             f"kernels: {launched}")
    wall = time.perf_counter() - t0
    print(f"phase 14b (moe and encdec training) wall {wall:.1f}s, {card}",
          flush=True)
    print(json.dumps({"lm_moe_encdec_training": rows, "gate1": gate1,
                      "card": card, "wall_s": wall}), flush=True)
    return rows


def mesh_train_arch(torch, mesh, arch: str) -> dict:
    """Phase 15d for one model at LM_MESH_TRAIN_CUT: the float32 step on
    the mesh against the unsharded one (and, for LM_MESH_TRAIN_WITNESS,
    the unsharded one on the card against the CPU), the bfloat16 steps
    sharded and unsharded, and each member's bytes against the
    dry-run's."""
    from repro_torch import tree as ttree
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.engine.base import nearest_rank
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    from repro_torch.train.step import (TrainHParams, init_train_state,
                                        make_train_step)
    cfg = cut_config(arch, LM_MESH_TRAIN_CUT[arch])
    tp = mesh.shape["model"]
    n = n_params(torch, cfg)
    print(f"lm mesh train {arch} ({LM_MESH_TRAIN_CUT[arch] or 'whole'}): "
          f"{n:,} parameters, {16 * n:,} bytes of training state a copy; "
          f"unsharded then mesh, one after the other (the first freed)",
          flush=True)

    def ref_make():
        return LM(cfg, tp=tp, device="cuda", dtype=torch.float32,
                  trainable=True).init(
                      torch.Generator(device="cuda").manual_seed(1))

    def dev_make():
        return LM(cfg, tp=tp, mesh=mesh, dtype=torch.float32,
                  trainable=True)

    def cpu_make():
        """The unsharded model on the CPU, holding ref_make()'s weights."""
        from repro_torch.models.common import flatten_defs
        card = ref_make()
        lm = LM(cfg, tp=tp, device="cpu", dtype=torch.float32,
                trainable=True)
        for (path, _), t in zip(flatten_defs(lm.param_defs()),
                                ttree.leaves(card.params)):
            lm.load_leaf(path, _host(t))
        del card
        torch.cuda.empty_cache()
        return lm
    tol = LM_MESH_TRAIN_TOL.get(arch, LM_TRAIN_GRAD_TOL)
    row = {"arch": arch, "cut": LM_MESH_TRAIN_CUT[arch], "params": n,
           "f32_step": train_step_compare(
               torch, ref_make, dev_make, f32_batch(cfg), gate_control=True,
               tol=tol)}
    if arch in LM_MESH_TRAIN_WITNESS:
        wit = row["f32_witness"] = train_step_compare(
            torch, cpu_make, ref_make, f32_batch(cfg), gate_control=False,
            tol=tol)
        got = row["f32_step"]["grad_max_rel_err"]
        if got > max(LM_MESH_WITNESS_RATIO * wit["grad_max_rel_err"],
                     LM_TRAIN_GRAD_TOL):
            raise AssertionError(
                f"{arch}: the mesh's gradients lie {got:.3g} from the "
                f"unsharded step's, past {LM_TRAIN_GRAD_TOL} and "
                f"{LM_MESH_WITNESS_RATIO}x the card-vs-CPU witness's "
                f"{wit['grad_max_rel_err']:.3g}")
        row["f32_perturbed"] = perturbation_spread(
            torch, ref_make, f32_batch(cfg), LM_MESH_WITNESS_DRAWS)
    batches = train_batches(cfg, LM_MESH_TRAIN_STEPS, LM_TRAIN_BATCH,
                            LM_TRAIN_SEQ)
    for which in ("mesh", "unsharded"):
        lm = LM(cfg, tp=tp, device="cuda", dtype=torch.bfloat16, trainable=True,
                mesh=mesh if which == "mesh" else None)
        lm.init(torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(lm, TrainHParams(total_steps=10))
        state = init_train_state(lm.params)
        times, losses = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{arch} {which} train losses {losses}")
        times.sort()
        row[f"{which}_step_p50_ms"] = nearest_rank(times, 0.5) * 1e3
        row[f"{which}_losses"] = losses
        if which == "mesh":
            shape = ShapeSpec("train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
            rows = lm._mesh_exec()._rows(LM_TRAIN_BATCH)
            stored = []
            for k in range(mesh.size):
                b_k = len(range(LM_TRAIN_BATCH)[rows[k]])
                nb = sum(t.nbytes(k) for t in ttree.leaves(
                    (lm.params, lm.grads, state.opt.mu, state.opt.nu)))
                nb += 4 + b_k * LM_TRAIN_SEQ * 4 * 2
                if cfg.family == "encdec":
                    nb += b_k * (LM_TRAIN_SEQ // cfg.enc_len_ratio) * \
                        cfg.d_model * torch.empty((), dtype=lm.dtype) \
                        .element_size()
                stored.append(nb)
            meta = Mesh((torch.device("meta"),) * mesh.size,
                        mesh.axis_names, mesh.dims)
            rec = dryrun.run_cell(arch, "train", False, cfg=cfg, shape=shape,
                                  mesh=meta, roofline=False)
            mem = rec["memory"]["bytes"]
            want = mem["argument"] + mem["grads"]
            row.update(member_bytes=stored, dryrun_bytes=want,
                       dryrun_collective_bytes=rec["per_device"]
                       ["collective_bytes"])
            if any(nb != want for nb in stored):
                raise AssertionError(f"{arch} mesh members hold {stored} "
                                     f"bytes, the dry-run's argument + "
                                     f"gradients {want}")
        del lm, step, state
        torch.cuda.empty_cache()
    return row


def lm_mesh_train_phase(torch, card: str) -> dict:
    """Phase 15d: the non-dense families training on the LM mesh
    (LM_MESH_TRAIN's comment).  K1–K6's counters are zeroed before and
    must read 0 after."""
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import mesh_from_flag
    launch0 = launch_counts(COUNTED)
    t0 = time.perf_counter()
    mesh = mesh_from_flag(LM_MESH, "cuda")
    where = mesh_members(torch, mesh)
    rows = {}
    for arch in LM_MESH_TRAIN:
        t1 = time.perf_counter()
        row = rows[arch] = mesh_train_arch(torch, mesh, arch)
        witness = ""
        if "f32_witness" in row:
            wit, worst = row["f32_witness"], row["f32_step"]["grad_worst_leaf"]
            spread = row["f32_perturbed"]
            top = max(spread, key=spread.get)
            witness = (f"witness, unsharded card vs CPU: "
                       f"{train_step_line(wit)} (at the mesh's worst leaf "
                       f"{worst}: {wit['grad_rel_err_by_leaf'][worst]:.3g}; "
                       f"mesh <= {LM_TRAIN_GRAD_TOL} or "
                       f"{LM_MESH_WITNESS_RATIO}x witness); "
                       f"{LM_MESH_WITNESS_DRAWS} 1e-7 parameter "
                       f"perturbations move the unsharded gradients up to "
                       f"{spread[top]:.3g} ({top}), {spread[worst]:.3g} at "
                       f"{worst} (printed, not gated); ")
        print(f"lm mesh train {arch} ({row['cut'] or 'whole'}, {row['params']:,}"
              f" params), {card}: {mesh.dims} mesh of {where}; float32 step "
              f"mesh vs unsharded: {train_step_line(row['f32_step'])}; "
              f"{witness}"
              f"{LM_MESH_TRAIN_STEPS} bfloat16 steps at ({LM_TRAIN_BATCH}, "
              f"{LM_TRAIN_SEQ}) p50 {row['mesh_step_p50_ms']:.1f} ms on the "
              f"mesh, {row['unsharded_step_p50_ms']:.1f} ms unsharded "
              f"(losses {[round(x, 4) for x in row['mesh_losses']]} / "
              f"{[round(x, 4) for x in row['unsharded_losses']]}); each "
              f"member stores {row['member_bytes'][0]:,} bytes == the "
              f"dry-run's argument + gradient bytes (collective "
              f"{row['dryrun_collective_bytes']:,.0f} bytes a step by its "
              f"count); {time.perf_counter() - t1:.1f}s", flush=True)
    launcher = {}
    for arch in LM_MESH_TRAIN_LAUNCH:
        with tempfile.TemporaryDirectory() as tmp:
            got = train_launch.run(arch, steps=2, device="cuda", mesh=LM_MESH,
                                   ckpt_dir=tmp, ckpt_every=1)
        if int(got["state"].step) != 2 or not all(np.isfinite(got["losses"])):
            raise AssertionError(f"{arch} launch.train --mesh {LM_MESH}: "
                                 f"{got['losses']}")
        launcher[arch] = got["losses"]
    print(f"lm mesh train launch.train --mesh {LM_MESH} at reduced width, "
          f"{card}: losses {launcher}", flush=True)
    launched = {k: v for k, v in launch_counts(COUNTED, launch0).items()
                if v}
    if launched:
        raise AssertionError(f"the LM mesh training path launched TM "
                             f"kernels: {launched}")
    wall = time.perf_counter() - t0
    print(f"phase 15d (non-dense training on the LM mesh) wall {wall:.1f}s,"
          f" {card}", flush=True)
    print(json.dumps({"lm_mesh_train": rows, "launcher_losses": launcher,
                      "members": where, "card": card, "wall_s": wall}),
          flush=True)
    return rows


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


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
    from repro_torch.distributed import data_mesh
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
          "binary_matmul_plain": binary_matmul_plain,
          "data_mesh": data_mesh}

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
    kernels["train_deltas"] = check_train_deltas(torch, rt)
    per_call = profile_launches(torch, rt)
    check_class_tiles(torch, rt)
    fleet_shape = check_fleet_shape(torch, rt)
    kernels["popcount_words"] = check_popcount(torch, rt)
    kernels["binary_matmul"] = check_binary_matmul(torch, rt)
    kernels["pdl_race"] = check_pdl_race(torch, rt)
    print(f"clocks/power after timing: "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}", flush=True)

    ta = make_ta(np.random.default_rng(SEED), DENSITY)
    runs = {backend: asyncio.run(serve(torch, backend, ta))
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
    default = asyncio.run(serve(torch, None, ta))
    if default["routes"] != {"sparse_csr"} or any(
            default["launches"].values()):
        raise AssertionError(f"default routing: routes "
                             f"{default['routes']}, launches "
                             f"{default['launches']}")
    learn = asyncio.run(serve_and_learn(
        torch, rt, ta, backend="mxu_fused", train_backend="fused",
        expect=lambda st: {"train_deltas": N_UPDATES,
                           "swar_fused_votes": N_UPDATES,
                           "clause_votes": st["batches"]}))
    # default routing: a trained-density state routes every bucket to
    # sparse_csr (no kernel of its own: the ELL gather is torch ops), and
    # the sparse train engine's deltas go through K2 alone
    sparse = asyncio.run(serve_and_learn(
        torch, rt, ta, backend=None, train_backend="sparse",
        expect=lambda st: {"train_deltas": N_UPDATES,
                           "swar_fused_votes": 0, "clause_votes": 0}))
    if sparse["routes"] != {"sparse_csr"} or \
            sparse["stats"]["sparse_layout"] is None:
        raise AssertionError(f"default routing chose {sparse['routes']}, "
                             f"layout {sparse['stats']['sparse_layout']}")
    asyncio.run(serve(torch, "time_domain",
                      learn["state"].ta.cpu().numpy()))
    slice_run = time_domain_popcount(torch, rt, learn["state"])
    bnn = bnn_phase(torch)
    with tempfile.TemporaryDirectory() as tmp:
        life = asyncio.run(lifecycle(torch, rt, ta, tmp))
    shed = asyncio.run(shed_tier(torch, rt, learn["state"].ta.cpu().numpy()))
    fleet = fleet_phase(torch, rt)
    mesh = mesh_phase(torch, rt, ta, learn, card)
    lm_phase(torch, card)
    train_phase(torch, card)
    train_moe_phase(torch, card)
    lm_mesh_phase(torch, card)
    lm_moe_mesh_phase(torch, card)
    lm_ssm_mesh_phase(torch, card)
    lm_mesh_train_phase(torch, card)

    meta = {
        "swar_fused_votes": ("src/repro_torch/csrc/swar_fused.cu",
                             "src/repro/kernels/swar_fused.py:62",
                             "swar_fused_votes_pallas"),
        "clause_votes": ("src/repro_torch/csrc/clause_votes.cu",
                         "src/repro/kernels/clause_eval.py:64",
                         "clause_votes_pallas"),
        "train_deltas": ("src/repro_torch/csrc/train_deltas.cu",
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
    launches["train_deltas"] = learn["launches"]["train_deltas"]
    launches.update(slice_run["launches"])
    launches.update(bnn["launches"])
    shape_of = {"swar_fused_votes": f"B={SERVE_BATCH}",
                "clause_votes": f"B={SERVE_BATCH}",
                "train_deltas": f"B={LABEL_BATCH}",
                "popcount_words": "{}x{}".format(*K4_SHAPES[-1]),
                "pdl_race": "B={} C={} M={}".format(*K5_SHAPES[-1]),
                "binary_matmul": "{}x{}x{}".format(*K6_MAIN)}
    # launches in the later paths, each counted from 0 around its traffic:
    # phase 9 (lifecycle), phase 10 (shed tier), phase 11 (the packed
    # fleet) and phase 12 (the mesh, its three runs summed)
    by_phase = {name: {ph: run["launches"][name]
                       for ph, run in (("9", life), ("10", shed),
                                       ("11", fleet), ("12", mesh))
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
