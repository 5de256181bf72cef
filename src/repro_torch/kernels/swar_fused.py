"""Kernel K1: fused bit-packed clause evaluation + SWAR popcount + class
vote (port of ``repro.kernels.swar_fused``).

    hit[b,i,w]  = inc_words[i,w] & not_words[b,w]
    viol[b,i]   = Σ_w popcount(hit[b,i,w])
    votes[b,c]  = Σ_i (viol[b,i] == 0) · vote_matrix[i,c]

Replaces the Pallas kernel ``repro/kernels/swar_fused.py:
swar_fused_votes_pallas`` (body ``_swar_fused_kernel``), the
``swar_fused`` backend.  On a CUDA tensor :func:`swar_fused_votes`
launches the hand-written kernel in ``csrc/swar_fused.cu`` (``__popc``
on word ANDs in registers, so the (B, C·M, Wl) hit tensor never reaches
device memory); on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.ref_swar_fused_votes`.  Nothing falls
back: a CUDA build or launch failure raises.

Words are int32 tensors holding the JAX package's uint32 bits (see
:mod:`repro_torch.core.popcount`); the kernel reads them as uint32.

Bound on an H100 at tm-mnist-50 widths (Wl = 49, CM = 500, C = 10):
its B·CM·Wl popcounts at 4.19 T/s (16 ``__popc`` per clock per SM on
compute capability 9.0) outweigh the bytes it moves — at a served bucket
of 64 rows about 118 KB (0.035 µs at 3.35 TB/s) against 0.37 µs of
popcounts, far below the cost of a launch, so serving is launch-bound;
at 4096 rows 24 µs.
"""

from __future__ import annotations

import torch

from .ref import ref_swar_fused_votes

__all__ = ["swar_fused_votes", "swar_fused_votes_plain"]

swar_fused_votes_plain = ref_swar_fused_votes


def _check(not_words, inc_words, vote_matrix):
    for name, t, dtype in (("not_words", not_words, torch.int32),
                           ("inc_words", inc_words, torch.int32),
                           ("vote_matrix", vote_matrix, torch.int8)):
        if t.dtype != dtype or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D {dtype} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != not_words.device:
            raise ValueError(f"{name} is on {t.device}, not_words on "
                             f"{not_words.device}")
    if inc_words.shape[1] != not_words.shape[1] or \
            vote_matrix.shape[0] != inc_words.shape[0]:
        raise ValueError(
            f"shapes do not chain: not_words {tuple(not_words.shape)}, "
            f"inc_words {tuple(inc_words.shape)}, vote_matrix "
            f"{tuple(vote_matrix.shape)}")


def swar_fused_votes(not_words: torch.Tensor, inc_words: torch.Tensor,
                     vote_matrix: torch.Tensor) -> torch.Tensor:
    """not_words (B, Wl) int32 — packed ¬literals; inc_words (CM, Wl)
    int32 — packed include masks; vote_matrix (CM, C) int8 → votes
    (B, C) int32.

    CPU tensors: the plain version.  CUDA tensors: kernel K1, counted in
    ``swar_fused_votes.launches``."""
    _check(not_words, inc_words, vote_matrix)
    if not_words.device.type == "cpu":
        return swar_fused_votes_plain(not_words, inc_words, vote_matrix)
    if not_words.device.type != "cuda":
        raise ValueError(f"swar_fused_votes runs on cpu or cuda, not "
                         f"{not_words.device}")
    for name, t in (("not_words", not_words), ("inc_words", inc_words),
                    ("vote_matrix", vote_matrix)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .ops import launch
    (b, wl), (cm, c) = not_words.shape, vote_matrix.shape
    out = torch.empty((b, c), dtype=torch.int32, device=not_words.device)
    if b == 0 or c == 0:
        return out
    launch("swar_fused_votes", (not_words, inc_words, vote_matrix, out),
           (b, cm, wl, c))
    swar_fused_votes.launches += 1
    return out


swar_fused_votes.launches = 0
