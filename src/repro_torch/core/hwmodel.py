"""Analytic FPGA cost model for TM popcount/argmax implementations (paper §IV).

A copy of ``repro.core.hwmodel`` (pure stdlib; the port cannot import it,
since ``repro/core/__init__.py`` imports JAX), held equal to it by
``tests/test_torch_hwmodel.py``.

The container has no FPGA; latency / dynamic power / resource utilization are
reproduced with a structural model of each design evaluated in the paper:

- ``generic``    — synchronous TM, adder-*tree* popcount + compare-select
                   argmax chain (Vivado generic flow).
- ``fpt18``      — synchronous TM, ripple LUT-chain popcount [Kim FPT'18]
                   (linear latency, fewer LUTs than the tree).
- ``async21``    — dual-rail asynchronous popcount [Wheeldon ASYNC'21];
                   paper compares resources only (we do the same).
- ``timedomain`` — the paper: PDL pop-counters + arbiter-tree argmax in a
                   single-rail 2-phase MOUSETRAP pipeline.

Structural facts encoded (not fitted):
- trained TM clauses are sparse → synthesis prunes excluded literals, so
  clause logic is small and popcount+argmax dominate (paper Fig. 9);
- adder tree depth ``ceil(log2 M)`` vs PDL/ripple linear-in-``M`` delay
  (Fig. 10a); compare-select chain linear in classes vs arbiter-tree
  ``log2 C`` (Fig. 10b);
- 2-phase protocol needs rising- *and* falling-transition arbiter trees;
- sync designs pay clock-tree power on every FF; the async TD design pays
  one deterministic transition per delay element per token (Fig. 12);
- per-model PDL net delays from Table I.

A handful of technology constants (level delay, per-bit compare cost, async
fixed overhead, clock-power coefficient) are calibrated so the model lands
on the paper's reported endpoints:

    MNIST-50  : TD latency ≈ −38 % vs generic     (paper "up to 38 %")
    MNIST     : TD dynamic power ≈ −43.1 %        (paper "up to 43.1 %")
    MNIST     : TD resources ≈ −11..15 %          (paper "up to 15 %")
    Iris      : TD latency *higher*; Iris-10 TD resources *higher*

Tests assert those ratios; ``benchmarks/fig9..12*`` print model vs paper.
All times ns, power in relative units, resources in LUT/FF counts.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["HWConstants", "TMShape", "cost", "popcount_only_power", "IMPLS",
           "paper_models"]

IMPLS = ("generic", "fpt18", "async21", "timedomain")


@dataclasses.dataclass(frozen=True)
class HWConstants:
    # synchronous logic (Zynq XC7Z020, 28 nm; routing-dominated levels)
    t_level: float = 1.5        # LUT + net delay per logic level (ns)
    t_cmp_bit: float = 0.50     # compare-select cost per operand bit (ns)
    t_rc_bit: float = 0.35      # FPT'18 LUT-chain cost per popcount bit (ns)
    t_margin: float = 1.0       # setup margin added to sync critical path (ns)
    clk_overhead: float = 1.05  # sync period guard band (jitter/skew)
    # time-domain PDL (per-element, ns — Table I averages; per-model override)
    d_low: float = 0.3845
    d_high: float = 0.6176
    t_arb: float = 0.15         # per arbiter level (ns)
    t_async_fixed: float = 10.0 # FF start-sync + completion + handshake (ns)
    bundle_margin: float = 1.4  # bundled-data margin on clause stage
    # async TD infrastructure (controller, completion, wait/join)
    ctrl_luts: int = 60
    ctrl_ffs: int = 30
    # power model (relative units)
    p_lut: float = 1.0          # per-LUT toggle energy coefficient
    p_clk_ff: float = 1.8       # per-FF clock-tree power coefficient (sync)
    p_latch: float = 0.30       # per-latch async local-clock coefficient
    glitch: float = 4.0         # adder-tree glitch multiplier slope vs activity
    # resource coefficients
    lut_per_fa: float = 1.06    # generic tree LUTs per input bit
    lut_fpt18: float = 0.80     # FPT'18 LUTs per input bit
    lut_async21: float = 2.60   # ASYNC'21 dual-rail LUTs per input bit
    lut_cd_async21: float = 0.40  # completion detection per bit


@dataclasses.dataclass(frozen=True)
class TMShape:
    n_classes: int
    n_clauses: int              # per class
    n_features: int             # Boolean features (literals = 2F)
    name: str = ""
    d_low: float | None = None  # per-model PDL tuning (Table I), else defaults
    d_high: float | None = None
    # avg literals *included* per clause after training (synthesis prunes
    # excluded literals — measured from trained TMs in benchmarks)
    included_literals: int = 24
    # expected fraction of delay elements selecting the low-latency net on
    # the *winning* class (data-dependent; measured in benchmarks)
    low_frac_winner: float = 0.80


def _clause_stage(shape: TMShape, k: HWConstants) -> tuple[float, int]:
    """Delay (ns) and LUTs of the (pruned) propositional clause logic."""
    lits = max(2, min(shape.included_literals, 2 * shape.n_features))
    depth = max(1, math.ceil(math.log(lits, 6)))
    luts = shape.n_classes * shape.n_clauses * math.ceil((lits - 1) / 5)
    return depth * k.t_level, luts


def _popcount_width(n_clauses: int) -> int:
    return int(math.ceil(math.log2(max(2, n_clauses)))) + 1


def _sync_compare(shape: TMShape, k: HWConstants) -> tuple[float, int]:
    """Sequential compare-select argmax chain (paper: linear in classes)."""
    w = _popcount_width(shape.n_clauses)
    t = (shape.n_classes - 1) * (k.t_level + w * k.t_cmp_bit)
    luts = (shape.n_classes - 1) * int(1.5 * w + 4)
    return t, luts


def cost(impl: str, shape: TMShape, k: HWConstants = HWConstants(),
         activity: float = 0.25) -> dict:
    """Return dict(latency_ns, power, luts, ffs, resources, parts...).

    ``activity``: input switching-activity factor α (paper Fig. 12 uses
    0.1 / 0.5). For ``timedomain``, latency is the *average* inference
    time (async, data-dependent); for sync designs it is the minimal clock
    period × guard band (single-cycle datapath, per paper §IV-C).
    """
    C, M = shape.n_classes, shape.n_clauses
    w = _popcount_width(M)
    t_clause, luts_clause = _clause_stage(shape, k)
    lits = 2 * shape.n_features
    d_low = shape.d_low if shape.d_low is not None else k.d_low
    d_high = shape.d_high if shape.d_high is not None else k.d_high
    delta = d_high - d_low

    if impl in ("generic", "fpt18"):
        if impl == "generic":
            t_pop = max(1, math.ceil(math.log2(max(2, M)))) * k.t_level
            luts_pop = int(C * k.lut_per_fa * M)
            glitch = 1.0 + k.glitch * activity       # trees glitch with α
        else:
            t_pop = k.t_level + M * k.t_rc_bit       # linear LUT chain
            luts_pop = int(C * k.lut_fpt18 * M)
            glitch = 1.0 + 0.75 * k.glitch * activity  # chains glitch less
        t_cmp, luts_cmp = _sync_compare(shape, k)
        latency = (t_clause + t_pop + t_cmp + k.t_margin) * k.clk_overhead
        ffs = lits + C * M + C * w + 16              # in/clause/sum regs + ctrl
        luts = luts_clause + luts_pop + luts_cmp
        f = 1.0 / latency
        power = f * (activity * glitch * k.p_lut * (luts_pop + luts_cmp)
                     + activity * k.p_lut * luts_clause + k.p_clk_ff * ffs)
        parts = {"popcount_ns": t_pop, "compare_ns": t_cmp, "clause_ns": t_clause}

    elif impl == "async21":
        # paper compares resources only (dual-rail pop counters, eq. LUTs)
        luts_pop = int(C * (k.lut_async21 + k.lut_cd_async21) * M)
        t_cmp, luts_cmp = _sync_compare(shape, k)
        luts = luts_clause + luts_pop + luts_cmp
        ffs = 2 * lits + 2 * C * M + C * w + 24      # dual-rail latching
        latency = float("nan")
        power = float("nan")
        parts = {"popcount_ns": float("nan"), "compare_ns": t_cmp,
                 "clause_ns": t_clause}

    elif impl == "timedomain":
        levels = max(1, math.ceil(math.log2(max(2, C))))
        # winning-class average PDL delay: all-high baseline minus Δ per
        # low-selected element (paper §IV-A: completion = first arrival)
        low_cnt = shape.low_frac_winner * M
        t_pdl_avg = M * d_high - delta * low_cnt
        t_pdl_worst = M * d_high
        t_cmp = levels * k.t_arb
        latency = (t_clause * k.bundle_margin + t_pdl_avg + t_cmp
                   + k.t_async_fixed)
        latency_worst = (t_clause * k.bundle_margin + t_pdl_worst + t_cmp
                         + k.t_async_fixed)
        luts_pop = C * M                             # 1 LUT per delay element
        # rising + falling arbiter trees (2-phase) + completion merge
        luts_arb = (C - 1) * 2 * 3 + 2 * C
        luts = luts_clause + luts_pop + luts_arb + k.ctrl_luts
        ffs = lits + C + k.ctrl_ffs                  # MOUSETRAP latches + sync
        f = 1.0 / latency
        # each delay element toggles exactly once per token; no clock tree —
        # latches see only the local handshake "clock"
        power = f * (k.p_lut * (luts_pop + luts_arb)
                     + activity * k.p_lut * luts_clause
                     + k.p_latch * k.p_clk_ff * ffs)
        parts = {"popcount_ns": t_pdl_avg, "compare_ns": t_cmp,
                 "clause_ns": t_clause * k.bundle_margin,
                 "latency_worst_ns": latency_worst}

    else:
        raise ValueError(f"unknown impl {impl!r}")

    return {"impl": impl, "latency_ns": latency, "power": power,
            "luts": luts, "ffs": ffs, "resources": luts + ffs, **parts}


def popcount_only_power(impl: str, shape: TMShape,
                        k: HWConstants = HWConstants(),
                        activity: float = 0.25) -> float:
    """Dynamic power of the popcount circuit alone (paper Fig. 12).

    Energy per token of the popcount stage, normalized by a *common* token
    period (the generic design's latency), so circuits are compared at the
    same throughput.  Captures the paper's finding: at α=0.1 the adder is
    cheaper (few nodes toggle) while every TD delay element toggles every
    token; at α=0.5 adder glitching dominates and TD wins.
    """
    C, M = shape.n_classes, shape.n_clauses
    w = _popcount_width(M)
    t_ref = cost("generic", shape, k, activity)["latency_ns"]
    if impl == "generic":
        luts_pop = int(C * k.lut_per_fa * M)
        glitch = 1.0 + k.glitch * activity
        energy = activity * glitch * k.p_lut * luts_pop + k.p_clk_ff * C * w
    elif impl == "fpt18":
        luts_pop = int(C * k.lut_fpt18 * M)
        glitch = 1.0 + 0.75 * k.glitch * activity
        energy = activity * glitch * k.p_lut * luts_pop + k.p_clk_ff * C * w
    elif impl == "timedomain":
        luts_pop = C * M
        luts_arb = (C - 1) * 2 * 3 + 2 * C
        energy = (k.p_lut * (luts_pop + luts_arb)
                  + k.p_latch * k.p_clk_ff * (C + k.ctrl_ffs))
    else:
        raise ValueError(f"no popcount-only power model for {impl!r}")
    return energy / t_ref


def paper_models() -> list[TMShape]:
    """The four TMs of Table I, with their per-model PDL net delays (ps→ns)."""
    return [
        TMShape(3, 10, 12, name="iris-10", d_low=0.3754, d_high=0.6419,
                included_literals=8, low_frac_winner=0.70),
        TMShape(3, 50, 12, name="iris-50", d_low=0.3886, d_high=0.5930,
                included_literals=8, low_frac_winner=0.70),
        TMShape(10, 50, 784, name="mnist-50", d_low=0.4028, d_high=0.6033,
                included_literals=30, low_frac_winner=0.82),
        TMShape(10, 100, 784, name="mnist-100", d_low=0.3711, d_high=0.6321,
                included_literals=30, low_frac_winner=0.70),
    ]
