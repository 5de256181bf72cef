"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each ``ref_*`` computes what the matching CUDA kernel computes, with
stock tensor ops.  A kernel wrapper runs its plain version when it is
handed CPU tensors (the tests), and ``chip_smoke.py`` holds every kernel
bitwise against its plain version on the card.  Every function here is
exact integer arithmetic and runs on any device.
"""

from __future__ import annotations

import torch

from repro_torch.core.popcount import _swar_word, int_matmul

__all__ = ["ref_popcount_words", "ref_clause_votes", "ref_swar_fused_votes"]

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
