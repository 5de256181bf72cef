"""Peaks of one NVIDIA H100 and the work of the TM's products, from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
:func:`k3_bound_s` is ``chip_smoke.py:bound("clause_votes", ...)`` at
commit 0b0ab71f059163ae9965ca32cf2dcd973d378fb7, with the vote-matrix
rows of fired clauses counted as none read: at most C·M·C bytes (5 kB at
tm-mnist-50), so the bound stays a lower one and loses nothing that
shows.
"""

from __future__ import annotations

HBM_BPS = 3.35e12          # bytes/s
INT8_OPS = 1979e12         # dense int8 tensor-core operations/s


def tm_ops_per_row(n_classes: int, n_clauses: int, n_features: int) -> int:
    """int8 operations of one row: the violation product (2·L·C·M) and the
    vote product (2·C·M·C), counted the same whatever computes them."""
    lit, cm = 2 * n_features, n_classes * n_clauses
    return 2 * lit * cm + 2 * cm * n_classes


def k3_bound_s(rows: int, n_classes: int, n_clauses: int,
               n_features: int) -> tuple[float, str]:
    """Least time (s) kernel K3 could take for ``rows`` rows: literals and
    include read once, votes written once, against its violation product
    on the int8 tensor cores → (seconds, what bounds it)."""
    lit, cm = 2 * n_features, n_classes * n_clauses
    nbytes = rows * lit + cm * lit + 4 * rows * n_classes
    t_bytes = nbytes / HBM_BPS
    t_ops = 2 * rows * cm * lit / INT8_OPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
