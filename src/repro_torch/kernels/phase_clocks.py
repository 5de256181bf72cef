"""Where a block's time goes in kernels K1, K2, K3 and K5, on the card.

    python -m repro_torch.kernels.phase_clocks [--out FILE]

``ncu`` and ``nsys`` may be missing where the card is, and CUDA events
time a launch only as a whole.  This probe builds the kernel libraries
with ``-DREPRO_PHASE_CLOCKS`` (``csrc/phase_clocks.cuh``) into
``build/repro_torch/phase_clocks/`` — never the libraries the port loads
— and runs K1, K2 and K5 at the shapes ``chip_smoke.py`` times: K1 at B
in (1, 64, 4096) at tm-mnist-50 widths, K2 at B in (32, 64, 512) on a
``fused`` step's inputs, K5 at B in (1, 1024) with C = 10, M = 100 (its
marks time each block's first row, on warp 0); and K3 at the bulk
benchmark's call: 65,536 rows at tm-mnist-50 widths on a state of 0.2 %
include density whose clause counts are quantiles of Binomial(784,
0.004), as the benchmark draws it (its 8,192 blocks fill the probe's
tables; its marks are thread 0's, in group 0).  For each it
prints the median per-call device time (CUDA events) and, for one call,
the median and maximum over blocks of the SM clocks each phase took
(between the ``PHASE`` marks of the source), the clock rate, the span
from the first block's start to the last block's end and the spread of
the blocks' starts (global timer).  The kernel time less that span is
what the launch and the grid's drain cost.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import ops

__all__ = ["K1_PHASES", "K2_PHASES", "K3_PHASES", "K5_PHASES",
           "include_counts", "summarize", "main"]

# what each kernel does between PHASE(i) and PHASE(i + 1)
K1_PHASES = ("stage rows, clauses and vote rows", "first tile's logic ops",
             "fire bits, fold, later tiles", "push partials, cluster barrier",
             "sum and store")
K2_PHASES = ("stage scalars and bit tiles", "clause pass, cluster barrier",
             "list items", "deltas (all chunks)", "store")
K3_PHASES = ("stage the first chunk (cp.async)",
             "mma.sync violation tiles, depth reduction",
             "fire masks (== 0 test, shuffles)", "first vote fold",
             "atomics, later vote folds")
K5_PHASES = ("stage tables, first row's loads", "first row into shared",
             "first row's class sums", "arbiter shuffles, store",
             "later rows")
_MARKS, _BLOCKS = 8, 8192           # csrc/phase_clocks.cuh


def summarize(clk: np.ndarray, ns: np.ndarray, n_phases: int) -> dict:
    """Phase clocks → summary.

    clk, ns: (blocks, marks) uint64 tables of clock64 and global-timer
    readings (0 where a block never reached a mark).  Over the blocks
    that reached marks 0..n_phases: per phase the median and maximum
    clocks, the clock rate (clocks per ns, median over blocks of a
    block's clock span over its timer span), the span from the first
    block's first mark to the last block's last mark (ns) and the spread
    of the first marks (ns)."""
    clk = clk[:, :n_phases + 1].astype(np.int64)
    ns = ns[:, :n_phases + 1].astype(np.int64)
    ok = (clk > 0).all(1) & (ns > 0).all(1)
    if not ok.any():
        raise ValueError("no block reached every mark")
    clk, ns = clk[ok], ns[ok]
    d = np.diff(clk, axis=1)
    spans = ns[:, -1] - ns[:, 0]
    rate = float(np.median((clk[:, -1] - clk[:, 0])[spans > 0]
                           / spans[spans > 0])) if (spans > 0).any() else 0.0
    return {"blocks": int(ok.sum()),
            "median_clk": [int(v) for v in np.median(d, 0)],
            "max_clk": [int(v) for v in d.max(0)],
            "clk_per_ns": rate,
            "span_ns": int(ns[:, -1].max() - ns[:, 0].min()),
            "start_spread_ns": int(ns[:, 0].max() - ns[:, 0].min())}


def _load(name: str) -> ctypes.CDLL:
    """Kernel ``name`` built with the marks, through the port's own build
    route, into ``build/repro_torch/phase_clocks/``."""
    lib = ops.load_library(name, ("-DREPRO_PHASE_CLOCKS",), "phase_clocks")
    lib.phase_clocks_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _probe(lib, name: str, tensors, scalars, n_phases: int) -> dict:
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in tensors]

    def call():
        rc = getattr(lib, name)(*ptrs, *scalars, torch.cuda.current_device(),
                                stream)
        if rc != 0:
            raise RuntimeError(f"{name} failed to launch: error {rc}")

    ms = ops.device_ms(call)
    torch.cuda.synchronize()
    if lib.phase_clocks_clear() != 0:
        raise RuntimeError("phase_clocks_clear failed")
    call()
    torch.cuda.synchronize()
    clk = np.zeros((_BLOCKS, _MARKS), np.uint64)
    ns = np.zeros((_BLOCKS, _MARKS), np.uint64)
    if lib.phase_clocks_read(clk.ctypes.data, ns.ctypes.data) != 0:
        raise RuntimeError("phase_clocks_read failed")
    return {"us": ms * 1e3, **summarize(clk, ns, n_phases)}


def _k1_cases(seed: int):
    from repro_torch.core.popcount import pack_bits
    from .clause_eval import make_vote_matrix
    c, m, lit = 10, 50, 1568
    rng = np.random.default_rng(seed)
    inc = torch.as_tensor((rng.random((c * m, lit)) < 0.05).astype(np.int8),
                          device="cuda")
    vm = make_vote_matrix(c, m, "cuda")
    for b in (1, 64, 4096):
        x = torch.as_tensor(rng.integers(0, 2, (b, lit), dtype=np.int8),
                            device="cuda")
        nw, iw = pack_bits(1 - x), pack_bits(inc)
        out = torch.empty((b, c), dtype=torch.int32, device="cuda")
        yield f"B={b}", (nw, iw, vm, out), (b, c * m, nw.shape[1], c)


def _k2_cases(seed: int):
    from repro_torch.core import prng
    from repro_torch.core.popcount import pack_bits
    from repro_torch.core.tm import TMConfig, clause_polarity
    from repro_torch.core.tm_train import feedback_masks
    from .clause_eval import make_vote_matrix
    from .ref import ref_swar_fused_votes
    from .train_fused import feedback_polarity_masks, uniform_threshold
    c, m, f = 10, 50, 784
    cfg = TMConfig(n_classes=c, n_clauses=m, n_features=f, T=5, s=7.0)
    rng = np.random.default_rng(seed)
    inc8 = torch.as_tensor((rng.random((c, m, 2 * f)) < 0.05)
                           .astype(np.int8), device="cuda")
    vm = make_vote_matrix(c, m, "cuda")
    pos = (clause_polarity(m, "cuda") > 0)[None, :]
    for b in (32, 64, 512):
        x = torch.as_tensor(rng.integers(0, 2, (b, 2 * f), dtype=np.int8),
                            device="cuda")
        y = torch.as_tensor(rng.integers(0, c, (b,)), device="cuda")
        votes = ref_swar_fused_votes(pack_bits(1 - x),
                                     pack_bits(inc8.reshape(c * m, -1)), vm)
        y_neg, fb_t, fb_n, k1s, k2s = feedback_masks(cfg, prng.key(b), votes,
                                                     y)
        masks = feedback_polarity_masks(fb_t, fb_n, pos)
        out = torch.empty((c, m, 2 * f), dtype=torch.int32, device="cuda")
        words = int(masks[0].sum() + masks[2].sum()) * 2 * f
        yield (f"B={b} ({words} Type I words)",
               (x, k1s, k2s, inc8, *masks, y, y_neg.to(y.dtype), out),
               (b, c, m, 2 * f, y.element_size(), uniform_threshold(1.0),
                uniform_threshold(1 / 7)))


def include_counts(n_clauses: int, n_literals: int, density: float
                   ) -> list[int]:
    """Included literals of each of ``n_clauses`` clauses: the quantiles
    of Binomial(``n_literals / 2``, ``2 · density``) at ``(r + ½) /
    n_clauses`` (a clause holds ``x`` or ``¬x`` of a feature, never
    both)."""
    n, p = n_literals // 2, 2 * density
    counts, cdf, k = [], 0.0, 0
    pmf = (1 - p) ** n
    for r in range(n_clauses):
        q = (r + 0.5) / n_clauses
        while cdf + pmf < q and k < n:
            cdf += pmf
            pmf *= (n - k) / (k + 1) * p / (1 - p)
            k += 1
        counts.append(k)
    return counts


def _k3_cases(seed: int):
    from .clause_eval import make_vote_matrix
    c, m, f, b = 10, 50, 784, 65536
    rng = np.random.default_rng(seed)
    counts = np.array(include_counts(c * m, 2 * f, 0.002))
    # the counts dealt in ascending order over the classes in turn
    counts = counts.reshape(m, c).T.reshape(-1)
    rank = rng.random((c * m, f)).argsort(-1).argsort(-1)
    chosen = rank < counts[:, None]
    negated = rng.integers(0, 2, (c * m, f)).astype(bool)
    inc = np.concatenate([chosen & ~negated, chosen & negated], -1)
    inc = torch.as_tensor(inc.astype(np.int8), device="cuda")
    vm = make_vote_matrix(c, m, "cuda")
    x = torch.as_tensor(rng.integers(0, 2, (b, f), dtype=np.int8),
                        device="cuda")
    lits = torch.cat([x, 1 - x], dim=-1)
    out = torch.empty((b, c), dtype=torch.int32, device="cuda")
    yield f"B={b} (tm-mnist-50.bulk)", (lits, inc, vm, out), \
        (b, c * m, 2 * f, c)


def _k5_cases(seed: int):
    c, m = 10, 100
    rng = np.random.default_rng(seed)
    ed = torch.as_tensor(rng.normal(500.0, 50.0, (c, m, 2))
                         .astype(np.float32), device="cuda")
    skew = torch.as_tensor(rng.normal(0.0, 1.0, (c,)).astype(np.float32),
                           device="cuda")
    for b in (1, 1024):
        sel = torch.as_tensor(rng.integers(0, 2, (b, c, m), dtype=np.int8),
                              device="cuda")
        outs = (torch.empty((b,), dtype=torch.int32, device="cuda"),
                torch.empty((b,), dtype=torch.float32, device="cuda"),
                torch.empty((b,), dtype=torch.bool, device="cuda"))
        yield f"B={b} C={c} M={m}", (sel, ed, skew, *outs), (b, c, m, 10.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_clocks: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    results = {"card": card}
    for name, phases, cases in (
            ("swar_fused_votes", K1_PHASES, _k1_cases(0)),
            ("train_deltas", K2_PHASES, _k2_cases(1)),
            ("clause_votes", K3_PHASES, _k3_cases(3)),
            ("pdl_race", K5_PHASES, _k5_cases(2))):
        lib = _load(name)
        for label, tensors, scalars in cases:
            r = _probe(lib, name, tensors, scalars, len(phases))
            results[f"{name} {label}"] = r
            rate = r["clk_per_ns"] or 1.0
            print(f"{name} {label}: {r['us']:.3f} us per call; blocks "
                  f"{r['blocks']}, span {r['span_ns'] / 1e3:.3f} us, start "
                  f"spread {r['start_spread_ns'] / 1e3:.3f} us, "
                  f"{rate:.2f} clk/ns", flush=True)
            for ph, med, mx in zip(phases, r["median_clk"], r["max_clk"]):
                print(f"    {ph:34s} median {med / rate / 1e3:7.3f} us  "
                      f"max {mx / rate / 1e3:7.3f} us", flush=True)
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
