"""Kernel K3: fused TM clause evaluation + class votes, dense int8 form
(port of ``repro.kernels.clause_eval``).

    viol[b,cm]  = Σ_l (1 − lit[b,l]) · inc[cm,l]
    clause      = (viol == 0)
    votes[b,c]  = Σ_cm clause[b,cm] · vote_matrix[cm,c]

Replaces the Pallas kernel ``repro/kernels/clause_eval.py:
clause_votes_pallas`` (body ``_clause_votes_kernel``), the
``mxu_fused`` backend and tm-mnist-50's default.  On a CUDA tensor
:func:`clause_votes` launches the hand-written kernel in
``csrc/clause_votes.cu`` (int8 dot products with ``__dp4a``, the clause
tile folded straight into the vote product, so the (B, C·M) clause
matrix never reaches device memory); on a CPU tensor it runs the plain
version :func:`repro_torch.kernels.ref.ref_clause_votes`.  Nothing falls
back: a CUDA build or launch failure raises.

Bound on an H100 (3.35 TB/s, 1,979 TOP/s int8) at tm-mnist-50 widths
(L = 1568, CM = 500, C = 10): at a served bucket of 64 rows it moves
about 0.89 MB (0.27 µs), far below the cost of a launch, so serving is
launch-bound; at 4096 rows its 6.4 G int8 operations (3.2 µs at the
tensor-core rate) bound it.
"""

from __future__ import annotations

import torch

from .ref import ref_clause_votes

__all__ = ["clause_votes", "clause_votes_plain", "make_vote_matrix"]

clause_votes_plain = ref_clause_votes


def make_vote_matrix(n_classes: int, n_clauses: int,
                     device=None) -> torch.Tensor:
    """(C·M, C) int8: ``polarity(m) · onehot(c)`` — even clause index +1."""
    idx = torch.arange(n_clauses, device=device)
    pol = torch.where(idx % 2 == 0, 1, -1).to(torch.int8)
    eye = torch.eye(n_classes, dtype=torch.int8, device=device)
    vm = eye[:, None, :] * pol[None, :, None]                # (C, M, C)
    return vm.reshape(n_classes * n_clauses, n_classes)


def _check(literals, include, vote_matrix):
    for name, t in (("literals", literals), ("include", include),
                    ("vote_matrix", vote_matrix)):
        if t.dtype != torch.int8 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int8 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != literals.device:
            raise ValueError(f"{name} is on {t.device}, literals on "
                             f"{literals.device}")
    if include.shape[1] != literals.shape[1] or \
            vote_matrix.shape[0] != include.shape[0]:
        raise ValueError(
            f"shapes do not chain: literals {tuple(literals.shape)}, "
            f"include {tuple(include.shape)}, vote_matrix "
            f"{tuple(vote_matrix.shape)}")


def clause_votes(literals: torch.Tensor, include: torch.Tensor,
                 vote_matrix: torch.Tensor) -> torch.Tensor:
    """literals (B, L) {0,1} int8; include (CM, L) {0,1} int8;
    vote_matrix (CM, C) int8 → votes (B, C) int32.

    CPU tensors: the plain version.  CUDA tensors: kernel K3, counted in
    ``clause_votes.launches``."""
    _check(literals, include, vote_matrix)
    if literals.device.type == "cpu":
        return clause_votes_plain(literals, include, vote_matrix)
    if literals.device.type != "cuda":
        raise ValueError(f"clause_votes runs on cpu or cuda, not "
                         f"{literals.device}")
    for name, t in (("literals", literals), ("include", include),
                    ("vote_matrix", vote_matrix)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .ops import launch
    (b, lit), (cm, c) = literals.shape, vote_matrix.shape
    out = torch.empty((b, c), dtype=torch.int32, device=literals.device)
    if b == 0 or c == 0:
        return out
    launch("clause_votes", (literals, include, vote_matrix, out),
           (b, cm, lit, c))
    clause_votes.launches += 1
    return out


clause_votes.launches = 0
