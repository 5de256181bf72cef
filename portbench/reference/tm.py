"""Plain reference of the Tsetlin machine (TM) that the benchmark judges the
port against: clause evaluation, class sums and the arg-max, and the ideal
programmable-delay-line (PDL) race.

Nothing here imports the program.  The race (``ideal_delays``, ``race``)
is a frozen copy of ``src/repro_torch/core/time_domain.py`` at commit
0b0ab71f059163ae9965ca32cf2dcd973d378fb7, the rules the paper states
(TM: Granmo 2018; the race: arXiv 2505.02181 §III).

Semantics.  Literals are ``[x, ¬x]`` rows of {0,1}; a literal is included
in a clause iff its automaton state exceeds ``n_states``; a clause fires
iff no included literal is 0 (an empty clause fires); even clauses vote
+1, odd ones −1; the prediction is the lowest class of largest sum.

Each function takes a ``precision``: the stated one (``"int32"`` for
counts, ``"float32"`` for delays) or the one below it that a control
computes in (``"int4"``: counts held in 4-bit two's complement, so they
wrap; ``"bfloat16"``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

BLOCK_ROWS = 16384


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32: the sums of {0,1} products here stay
    below 2**24 and are then exact."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _wrap4(x: torch.Tensor) -> torch.Tensor:
    """Values held in a 4-bit two's-complement accumulator."""
    return torch.remainder(x + 8, 16) - 8


def include_rows(ta: torch.Tensor, n_states: int) -> torch.Tensor:
    """(C, M, L) automaton states → (C·M, L) float32 {0,1} include mask."""
    c, m, lit = ta.shape
    return (ta > n_states).reshape(c * m, lit).to(torch.float32)


def clause_fires(literals: torch.Tensor, inc: torch.Tensor, *,
                 precision: str = "int32") -> torch.Tensor:
    """(B, L) {0,1} literals, (C·M, L) float32 include → (B, C·M) bool."""
    with exact_float32():
        viol = (1 - literals.to(torch.float32)) @ inc.T
    viol = viol.to(torch.int32)
    if precision == "int4":
        viol = torch.remainder(viol, 16)
    return viol == 0


def class_sums(fires: torch.Tensor, n_classes: int, *,
               precision: str = "int32") -> torch.Tensor:
    """(B, C·M) clause outputs → (B, C) int32 signed votes."""
    f = fires.reshape(fires.shape[0], n_classes, -1).to(torch.int32)
    sums = f[..., 0::2].sum(-1, dtype=torch.int32) \
        - f[..., 1::2].sum(-1, dtype=torch.int32)
    return _wrap4(sums) if precision == "int4" else sums


def first_argmax(scores: torch.Tensor) -> torch.Tensor:
    """Lowest index of the largest score on each row → int32."""
    c = scores.shape[-1]
    idx = torch.arange(c, device=scores.device).expand(scores.shape)
    top = scores.max(-1, keepdim=True).values
    return torch.where(scores == top, idx, c).min(-1).values.to(torch.int32)


def infer(ta: torch.Tensor, literals: torch.Tensor, n_states: int, *,
          precision: str = "int32") -> tuple[torch.Tensor, torch.Tensor]:
    """Prediction (B,) and class sums (B, C) of a whole batch, computed in
    blocks of rows on the literals' device."""
    c = ta.shape[0]
    inc = include_rows(ta.to(literals.device), n_states)
    preds, sums = [], []
    for r0 in range(0, literals.shape[0], BLOCK_ROWS):
        fires = clause_fires(literals[r0:r0 + BLOCK_ROWS], inc,
                             precision=precision)
        s = class_sums(fires, c, precision=precision)
        preds.append(first_argmax(s))
        sums.append(s)
    return torch.cat(preds), torch.cat(sums)


# -- the ideal PDL race (time_domain.py: ideal_delays, race) ----------

def low_counts(fires: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Elements on the low-latency net per class: positive clauses that
    fire, negative clauses that do not → (B, C) int32."""
    f = fires.reshape(fires.shape[0], n_classes, -1).to(torch.int32)
    return f[..., 0::2].sum(-1, dtype=torch.int32) \
        + (1 - f[..., 1::2]).sum(-1, dtype=torch.int32)


def ideal_delays(low_count: torch.Tensor, n_clauses: int, d_low: float,
                 d_high: float, *, precision: str = "float32"
                 ) -> torch.Tensor:
    """``M·d_high − Δ·low_count`` rounded once to float32 (float32
    constants; float64 holds the product and the sum exactly)."""
    slope = float(np.float32(-(d_high - d_low)))
    base = float(np.float32(n_clauses * d_high))
    if precision == "bfloat16":
        lc = low_count.to(torch.bfloat16)
        return (lc * slope + base).to(torch.float32)
    return (slope * low_count.to(torch.float64) + base).to(torch.float32)


def race(delays: torch.Tensor, t_res: float) -> tuple:
    """Tournament arbiter tree over (B, C) arrivals → (winner int32,
    latency float32, metastable bool); ties go to the lower index, and a
    pair of finite arrivals closer than ``t_res`` flags the row."""
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
        close = (a - bb).abs() < t_res
        meta = meta | (close & torch.isfinite(a) & torch.isfinite(bb)) \
            .any(-1)
        take_a = a <= bb
        delays = torch.where(take_a, a, bb)
        idx = torch.where(take_a, ia, ib)
    return idx[..., 0], delays[..., 0], meta


def infer_race(ta: torch.Tensor, literals: torch.Tensor, n_states: int,
               pdl: dict, *, precision: str = "float32") -> tuple:
    """The ideal device's race over a whole batch → (winner, class sums,
    latency_ps, metastable), in blocks of rows."""
    c, m, _ = ta.shape
    inc = include_rows(ta.to(literals.device), n_states)
    out = [], [], [], []
    for r0 in range(0, literals.shape[0], BLOCK_ROWS):
        fires = clause_fires(literals[r0:r0 + BLOCK_ROWS], inc)
        low = low_counts(fires, c)
        delays = ideal_delays(low, m, pdl["d_low"], pdl["d_high"],
                              precision=precision)
        winner, latency, meta = race(delays, pdl["t_res"])
        for acc, v in zip(out, (winner, low - m // 2, latency, meta)):
            acc.append(v)
    return tuple(torch.cat(v) for v in out)
