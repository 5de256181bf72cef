"""Time-domain popcount and comparison: the PDL race simulator of the
paper's §III (port of ``repro.core.time_domain``).

A programmable delay line (PDL) for class ``c`` is a chain of ``M``
delay elements, one per clause; element ``j`` costs ``d_low`` when its
select bit routes through the low-latency net and ``d_high`` otherwise.
A positive clause selects the low net when it fires, a negative clause
when it does not, so the chain delay falls as the signed class sum
rises.  A tournament of SR-latch arbiters takes the earliest arrival;
two arrivals closer than ``t_res`` at any arbiter may leave a latch
metastable, which is flagged and resolved to the lower index.

Physical non-idealities, as in the JAX package: per-element process
variation fixed per device (``PDLDevice``), per-event jitter
(``key=``), and a per-PDL placement skew.  Keys are the port's threefry
keys (:mod:`repro_torch.core.prng`), so ``make_device`` and the jitter
draw the same normals as ``jax.random`` from the same key, to a few
float32 ulps.

Float32 sums over the ``M`` elements run in torch's order, not XLA's,
so delays agree with the JAX package to a tolerance (rtol 1e-6 in the
tests); ``race`` on identical delays agrees bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import prng

__all__ = ["PDLConfig", "PDLDevice", "make_device", "pdl_delays", "race",
           "RaceResult", "time_domain_argmax", "async_latency",
           "spearman_rho", "low_select", "ideal_delays"]


@dataclasses.dataclass(frozen=True)
class PDLConfig:
    """Delay constants in picoseconds (defaults = paper Table I averages)."""

    d_low: float = 384.5        # low-latency net delay / element (ps)
    d_high: float = 617.6       # high-latency net delay / element (ps)
    sigma_elem: float = 5.0     # per-element process variation (ps, device-fixed)
    sigma_noise: float = 1.0    # per-event jitter (ps)
    t_res: float = 10.0         # arbiter resolution window (ps)
    t_arb: float = 150.0        # per-arbiter-level delay (ps)
    t_ctrl: float = 500.0       # MOUSETRAP / controller overhead per token (ps)

    @property
    def delta(self) -> float:
        return self.d_high - self.d_low


class PDLDevice(NamedTuple):
    """Per-chip fixed variation: element offsets (C, M, 2) float32 ps
    (``[..., 0]`` low net, ``[..., 1]`` high net) and skew (C,) ps."""

    elem_offset: torch.Tensor
    skew: torch.Tensor


def make_device(cfg: PDLConfig, n_classes: int, n_clauses: int,
                key: torch.Tensor, *, skew_ps: float = 0.0) -> PDLDevice:
    """Sample one device's process variation from a threefry ``key`` on
    the key's device; ``skew_ps`` models a bad (non-symmetric) placement
    — the paper's design flow drives it to about 0."""
    k1, k2 = prng.split(key)
    elem = float(np.float32(cfg.sigma_elem)) * prng.normal(
        k1, (n_classes, n_clauses, 2))
    skew = float(np.float32(skew_ps)) * prng.normal(k2, (n_classes,))
    return PDLDevice(elem_offset=elem, skew=skew)


def low_select(clause_bits: torch.Tensor, polarity: torch.Tensor
               ) -> torch.Tensor:
    """(B, C, M) {0,1} clause outputs, (M,) ±1 polarity → (B, C, M)
    int32: 1 where the element takes the low-latency net (a positive
    clause that fires, a negative clause that does not)."""
    bits = clause_bits.to(torch.int32)
    pos = (polarity > 0)[None, None, :]
    return torch.where(pos, bits, 1 - bits)


def ideal_delays(cfg: PDLConfig, low_count: torch.Tensor, n_clauses: int
                 ) -> torch.Tensor:
    """Chain delays of the ideal device (no variation, no skew), (B, C)
    int low-net counts → (B, C) float32 ps: ``M·d_high − Δ·low_count``
    rounded once to float32, as XLA's fused multiply-add rounds the JAX
    package's expression.  The constants are float32 (JAX's weak types);
    float64 holds their product with the count and the sum exactly, so
    the one rounding left is the final one."""
    slope = float(np.float32(-cfg.delta))
    base = float(np.float32(n_clauses * cfg.d_high))
    return (slope * low_count.to(torch.float64) + base).to(torch.float32)


def pdl_delays(cfg: PDLConfig, device: PDLDevice, clause_bits: torch.Tensor,
               polarity: torch.Tensor, *, key: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Chain propagation delay per class.

    clause_bits (B, C, M) {0,1}; polarity (M,) ±1 → (B, C) float32 ps.
    ``key`` adds per-event jitter ``sigma_noise · normal(key, (B, C))``.
    """
    low_sel = low_select(clause_bits, polarity)
    d_low = float(np.float32(cfg.d_low)) + device.elem_offset[None, :, :, 0]
    d_high = float(np.float32(cfg.d_high)) + device.elem_offset[None, :, :, 1]
    per_elem = torch.where(low_sel == 1, d_low, d_high)          # (B, C, M)
    total = per_elem.sum(-1) + device.skew[None, :]
    if key is not None and cfg.sigma_noise > 0:
        total = total + float(np.float32(cfg.sigma_noise)) * prng.normal(
            key, tuple(total.shape))
    return total


class RaceResult(NamedTuple):
    winner: torch.Tensor       # (B,) int32 — class whose transition arrived first
    latency: torch.Tensor      # (B,) float32 ps — winning arrival time
    metastable: torch.Tensor   # (B,) bool — any arbiter saw |Δt| < t_res


def race(cfg: PDLConfig, delays: torch.Tensor) -> RaceResult:
    """Tournament arbiter tree over per-class arrival times (B, C):
    pairs of neighbours race level by level, the earlier (ties → lower
    index) goes on, and a pair of finite arrivals closer than ``t_res``
    at any arbiter flags the row."""
    b, c = delays.shape
    size = 1 << max(0, c - 1).bit_length() if c > 1 else 1
    if size != c:
        delays = torch.nn.functional.pad(delays, (0, size - c),
                                         value=float("inf"))
    idx = torch.arange(size, dtype=torch.int32,
                       device=delays.device).expand(b, size)
    meta = torch.zeros((b,), dtype=torch.bool, device=delays.device)
    while delays.shape[-1] > 1:
        a, bb = delays[..., 0::2], delays[..., 1::2]
        ia, ib = idx[..., 0::2], idx[..., 1::2]
        close = (a - bb).abs() < cfg.t_res
        meta = meta | (close & torch.isfinite(a) & torch.isfinite(bb)) \
            .any(-1)
        take_a = a <= bb                      # tie → lower index
        delays = torch.where(take_a, a, bb)
        idx = torch.where(take_a, ia, ib)
    return RaceResult(winner=idx[..., 0], latency=delays[..., 0],
                      metastable=meta)


def time_domain_argmax(cfg: PDLConfig, device: PDLDevice,
                       clause_bits: torch.Tensor, polarity: torch.Tensor, *,
                       key: torch.Tensor | None = None) -> RaceResult:
    """Full paper §III pipeline: PDL conversion + arbiter race."""
    return race(cfg, pdl_delays(cfg, device, clause_bits, polarity, key=key))


def async_latency(cfg: PDLConfig, result: RaceResult, n_classes: int,
                  t_clause_bundle_ps: float) -> torch.Tensor:
    """Per-inference latency of the asynchronous TM (paper §IV-A): the
    clause bundle, the winning arrival, one ``t_arb`` per arbiter level
    and the controller overhead, each added in float32 in JAX's order."""
    levels = max(1, int(np.ceil(np.log2(max(2, n_classes)))))
    return (float(np.float32(t_clause_bundle_ps)) + result.latency
            + float(np.float32(levels * cfg.t_arb))
            + float(np.float32(cfg.t_ctrl)))


def spearman_rho(x: np.ndarray, y: np.ndarray) -> float:
    """Spearman rank correlation (paper Fig. 6 metric), ties averaged."""
    def rank(v):
        order = np.argsort(v, kind="stable")
        r = np.empty_like(order, dtype=np.float64)
        r[order] = np.arange(len(v))
        vv = np.asarray(v)
        for val in np.unique(vv):
            m = vv == val
            r[m] = r[m].mean()
        return r
    rx, ry = rank(np.asarray(x)), rank(np.asarray(y))
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx ** 2).sum() * (ry ** 2).sum())
    return float((rx * ry).sum() / denom) if denom else 0.0
