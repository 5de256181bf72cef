"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each ``ref_*`` computes what the matching CUDA kernel computes, with
stock tensor ops — except :func:`ref_pdl_race`, the JAX package's race
oracle, whose tie rule differs from kernel K5's (K5's plain version is
``kernels.pdl_race.pdl_race_plain``).  A kernel wrapper runs its plain version when it is
handed CPU tensors (the tests), and ``chip_smoke.py`` holds every kernel
bitwise against its plain version on the card.  Every function here runs on
any device; all but :func:`ref_pdl_race` are exact integer arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.popcount import _swar_word, int_matmul

__all__ = ["ref_popcount_words", "ref_clause_votes", "ref_swar_fused_votes",
           "ref_binary_matmul", "ref_pdl_race"]

# rows per chunk of the (rows, CM, Wl) hit tensor in ref_swar_fused_votes:
# bounds its temporaries at ~2^24 words whatever the batch
_HIT_ELEMS = 1 << 24


def ref_popcount_words(words: torch.Tensor) -> torch.Tensor:
    """(R, W) int32 bit-packed rows → (R,) int32 Hamming weights."""
    return _swar_word(words).sum(-1, dtype=torch.int32)


def ref_clause_votes(literals: torch.Tensor, include: torch.Tensor,
                     vote_matrix: torch.Tensor) -> torch.Tensor:
    """Fused TM inference, plain (kernel K3's arithmetic).

    literals (B, L) {0,1} int8 — [x, ¬x]; include (CM, L) {0,1} int8 —
    flattened (class·clauses) include masks; vote_matrix (CM, C) int8 —
    ``polarity[cm] · onehot(class(cm))`` → votes (B, C) int32.
    """
    viol = int_matmul(1 - literals.to(torch.int32), include.T)   # (B, CM)
    return int_matmul((viol == 0).to(torch.int32), vote_matrix)  # (B, C)


def ref_swar_fused_votes(not_words: torch.Tensor, inc_words: torch.Tensor,
                         vote_matrix: torch.Tensor) -> torch.Tensor:
    """Fused bit-packed TM inference, plain (kernel K1's arithmetic).

    not_words (B, Wl) int32 — packed ¬literals; inc_words (CM, Wl) int32
    — packed include masks; vote_matrix (CM, C) int8 → votes (B, C)
    int32.  A clause fires iff ``popcount(inc & ¬lit)`` is 0 over all
    words.  Rows go through in chunks so the ``(rows, CM, Wl)`` hit
    tensor stays bounded.
    """
    b, wl = not_words.shape
    cm = inc_words.shape[0]
    step = max(1, _HIT_ELEMS // max(1, cm * wl))
    fired = []
    for r0 in range(0, b, step):
        hit = inc_words[None, :, :] & not_words[r0:r0 + step, None, :]
        fired.append(_swar_word(hit).sum(-1, dtype=torch.int32) == 0)
    clause = torch.cat(fired) if fired else \
        torch.zeros((0, cm), dtype=torch.bool, device=not_words.device)
    return int_matmul(clause.to(torch.int32), vote_matrix)


def ref_binary_matmul(x_pm1: torch.Tensor, w_pm1: torch.Tensor
                      ) -> torch.Tensor:
    """±1 GEMM, plain (kernel K6's arithmetic): (M, K) int8 × (K, N) int8
    → (M, N) int32, equal to ``2·popcount(xnor(x_bits, w_bits)) − K`` for
    the bit encodings — the BNN xnor-popcount accumulation (paper
    Fig. 1(b))."""
    return int_matmul(x_pm1, w_pm1)


def ref_pdl_race(low_sel: torch.Tensor, elem_delays: torch.Tensor,
                 skew: torch.Tensor, t_res: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's PDL race oracle (``repro.kernels.ref.
    ref_pdl_race``).

    low_sel (B, C, M) {0,1} int8; elem_delays (C, M, 2) float32 ps;
    skew (C,) float32 ps → (winner (B,) int32, latency (B,) float32,
    metastable (B,) bool).  Metastable iff the two smallest arrivals
    (``top_k``, so a duplicate minimum gives gap 0) are closer than
    ``t_res``; needs C ≥ 2, as ``top_k(2)`` does.  Kernel K5 measures the
    gap to the next *distinct* arrival instead (see
    :mod:`repro_torch.kernels.pdl_race`).
    """
    per = torch.where(low_sel == 1, elem_delays[..., 0], elem_delays[..., 1])
    delays = per.sum(-1) + skew[None, :]                          # (B, C)
    winner = torch.argmin(delays, -1).to(torch.int32)
    latency = delays.min(-1).values
    top2 = torch.topk(delays, 2, dim=-1, largest=False).values
    meta = (top2[:, 1] - top2[:, 0]) < float(np.float32(t_res))
    return winner, latency, meta
