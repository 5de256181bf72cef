"""Cascade backend: exact early-exit voting via a stage-1 margin bound
(port of ``repro.engine.cascade``).

- **Stage 1** evaluates a deterministic, evenly spread subsample ``S`` of
  ``round(stage1_fraction · M)`` clause indices per class.  It computes
  votes only, the function of kernel K1: the subsampled include words go
  through :func:`~repro_torch.kernels.swar_fused.swar_fused_votes` with a
  ``(C·M₁, C)`` int8 vote matrix (polarity × one-hot, as
  :func:`~repro_torch.kernels.clause_eval.make_vote_matrix` builds the
  full one) — one K1 launch on the card, K1's plain version on the CPU.
- **Exact margin bound.**  The full class sum is ``F(c) = P(c) + base(c)
  + r(c)``: ``P`` the stage-1 partial sum, ``base`` the build-time votes
  of *empty* remainder clauses (an empty clause always fires) and ``r``
  the unknown votes of the non-empty remainder clauses, so ``F(c) ∈
  [mid(c) − neg_rem(c), mid(c) + pos_rem(c)]`` with ``mid = P + base``.
  With ``l`` the tournament leader of ``mid``, a row *exits* iff ``lo(l)
  ≥ hi(c) + [c < l]`` for every rival ``c``: the strict inequality
  against lower-indexed rivals reproduces ties → lowest, so an exit
  provably gives the full backend's prediction.  The test runs in torch
  ops on the engine's device.
- **Stage 2** escalates only the unsettled rows to ``full_backend``:
  their indices are compacted on the host (the one device-to-host copy
  of the exit mask), the rows gathered on the device and run through
  ``infer_padded(full, rows, _next_pow2(n))``.

``exact_sums=True`` (the default) completes the class sums of exited
rows with one more K1 pass over the *remainder* clauses, so the result
equals the full backend's in both fields; ``exact_sums=False`` (the
serving shed tier) skips it and reports ``mid`` for exited rows.
``aux["escalated"]`` is a ``(B,)`` bool marking rows that took stage 2.

The JAX engine's ``_infer_traced`` fallback (stage 1 and the full
backend on every row under a tracer) has no counterpart: torch has no
tracer, so ``infer`` always compacts on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.popcount import argmax_tournament, pack_bits
from repro_torch.core.tm import TMConfig, TMState, include_mask
from repro_torch.kernels.swar_fused import swar_fused_votes

from .base import EngineResult, as_literals, infer_padded, register_backend

__all__ = ["CascadeEngine", "subsample_mask"]


def subsample_mask(m: int, fraction: float) -> np.ndarray:
    """Deterministic evenly spread boolean mask over ``m`` clause indices:
    exactly ``k = clip(round(fraction·m), 1, m)`` indices by the
    Bresenham spread ``(i·k) mod m < k``."""
    k = int(np.clip(round(fraction * m), 1, m))
    return (np.arange(m) * k) % m < k


def _next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (1 for ``n ≤ 1``)."""
    return 1 << max(0, n - 1).bit_length()


def _layout(inc: torch.Tensor, pol: np.ndarray, mask: np.ndarray) -> tuple:
    """K1's operands for the clauses ``mask`` selects: packed include words
    ``(C·M', Wl)`` int32 and the vote matrix ``(C·M', C)`` int8 —
    ``polarity(m) · onehot(c)`` over the selected clause indices."""
    c, _, lit = inc.shape
    sel = torch.as_tensor(np.nonzero(mask)[0], device=inc.device)
    words = pack_bits(inc[:, sel, :].reshape(-1, lit))
    sign = torch.as_tensor(pol[mask], dtype=torch.int8, device=inc.device)
    eye = torch.eye(c, dtype=torch.int8, device=inc.device)
    vm = (eye[:, None, :] * sign[None, :, None]).reshape(-1, c)
    return words, vm


@register_backend("cascade")
class CascadeEngine:
    """Two-stage exact cascade: subsample + margin bound, escalate ties.

    Options: ``stage1_fraction`` (clause fraction evaluated in stage 1;
    fractions below ~0.5 escalate everything — still exact, never
    faster), ``full_backend`` (stage-2 backend name; any registered
    backend except ``cascade``), ``exact_sums`` (see the module
    docstring), and further opts forwarded to the full backend.

    ``aux`` carries ``escalated`` only; the full backend's own aux is not
    propagated.  ``passes`` counts this engine's stage-1 passes,
    ``exact_sums`` completion passes and escalated sub-batches (each of
    the first two is one K1 call).
    """

    def __init__(self, cfg: TMConfig, state: TMState, *,
                 stage1_fraction: float = 0.625,
                 full_backend: str = "swar_packed",
                 exact_sums: bool = True, **full_opts):
        if not 0.0 < stage1_fraction <= 1.0:
            raise ValueError(f"stage1_fraction must be in (0, 1], "
                             f"got {stage1_fraction}")
        if full_backend == "cascade":
            raise ValueError("cascade cannot escalate to itself")
        self.cfg = cfg
        self.device = state.ta.device
        self.stage1_fraction = float(stage1_fraction)
        self.full_backend = full_backend
        self.exact_sums = bool(exact_sums)
        m = cfg.n_clauses
        inc = include_mask(cfg, state)                           # (C, M, L)
        pol = np.where(np.arange(m) % 2 == 0, 1, -1)             # (M,) ±1
        sel = subsample_mask(m, stage1_fraction)
        rem = ~sel
        self._m1 = int(sel.sum())
        self._s1 = _layout(inc, pol, sel)
        # remainder bound terms: empty clauses fire unconditionally, so
        # their votes are a build-time constant (base); only the non-empty
        # remainder clauses are uncertain, by polarity
        nonempty = (inc.sum(-1) > 0).cpu().numpy()               # (C, M)
        rem_ne, rem_pol = nonempty[:, rem], pol[rem]

        def per_class(a):
            return torch.as_tensor(a.sum(-1), dtype=torch.int32,
                                   device=self.device)

        self._base = per_class((~rem_ne) * rem_pol[None, :])     # (C,)
        self._pos_rem = per_class(rem_ne & (rem_pol > 0))
        self._neg_rem = per_class(rem_ne & (rem_pol < 0))
        self._m_rem = int(rem.sum())
        self._rem = _layout(inc, pol, rem) \
            if (self.exact_sums and self._m_rem) else None
        self.passes = {"stage1": 0, "completion": 0, "escalation": 0}
        from .base import get_engine
        self._full = get_engine(full_backend, cfg, state, **full_opts)

    def _stage1(self, not_words: torch.Tensor) -> tuple:
        """Subsample votes (one K1 call) + the exact exit test →
        ``(partial, mid, leader, settled)``; ``settled[b]`` ⇒
        ``leader[b]`` is the full backend's prediction for row ``b``."""
        self.passes["stage1"] += 1
        partial = swar_fused_votes(not_words, *self._s1)
        mid = partial + self._base[None, :]
        lo = mid - self._neg_rem[None, :]
        hi = mid + self._pos_rem[None, :]
        leader = argmax_tournament(mid)
        lead = leader[:, None].to(torch.int64)
        lo_l = torch.gather(lo, 1, lead)                         # (B, 1)
        cls = torch.arange(self.cfg.n_classes, device=self.device)[None, :]
        strict = (cls < lead).to(lo.dtype)                       # ties→lowest
        settled = ((lo_l >= hi + strict) | (cls == lead)).all(dim=1)
        return partial, mid, leader, settled

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult`, tensors on the
        engine's device: stage 1 on the whole batch, the unsettled rows
        through the full backend padded to a power-of-two sub-bucket,
        scattered back."""
        lits = as_literals(literals, self.device)
        not_words = pack_bits(1 - lits)                          # (B, Wl)
        partial, mid, leader, settled = self._stage1(not_words)
        settled_np = settled.cpu().numpy()
        pred = leader.clone()
        sums = self._complete_sums(not_words, partial, settled_np) \
            if self.exact_sums else mid
        esc_idx = np.nonzero(~settled_np)[0]
        if esc_idx.size:
            self.passes["escalation"] += 1
            rows = lits
            idx = torch.as_tensor(esc_idx, device=self.device)
            if esc_idx.size < settled_np.size:
                rows = lits[idx]
            full = infer_padded(self._full, rows, _next_pow2(esc_idx.size))
            pred[idx] = full.prediction
            sums[idx] = full.class_sums
        return EngineResult(pred, sums, {"escalated": ~settled})

    def _complete_sums(self, not_words, partial, settled_np) -> torch.Tensor:
        """Exact class sums: a remainder K1 pass on the settled rows.
        Escalated rows keep their stage-1 partials here — ``infer``
        overwrites them with the full backend's sums."""
        sums = partial.clone()
        if self._rem is None:           # fraction 1.0 or all-empty remainder
            return sums + self._base[None, :]
        set_idx = np.nonzero(settled_np)[0]
        if set_idx.size == 0:
            return sums
        self.passes["completion"] += 1
        if set_idx.size == settled_np.size:
            return sums + swar_fused_votes(not_words, *self._rem)
        idx = torch.as_tensor(set_idx, device=self.device)
        sums[idx] += swar_fused_votes(not_words[idx], *self._rem)
        return sums
