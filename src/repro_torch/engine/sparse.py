"""Clause-indexed sparse layout (port of ``repro.engine.sparse``).

Trained Tsetlin machines include only ~5% of literals per clause, yet the
dense backends do O(C·M·L) clause-eval work per sample.  Iterating only
the *included* literal indices (Gorji et al., arXiv:2004.03188) is the
biggest single inference lever for TMs.  This module owns the
**layout**; the gather/AND bodies live in
:mod:`repro_torch.kernels.ell_gather`:

- :func:`ell_from_include` compresses an include mask into a padded
  CSR-style layout (ELLPACK): one ``(C·M, K)`` int32 index matrix with
  ``K ≥ max_r nnz(r)``, padding slots pointing at the sentinel literal
  ``L`` (a constant-1 column, a no-op for the clause conjunction).  The
  build is vectorized numpy (argsort over the mask).
- :func:`ell_apply_deltas` patches only the index rows whose include
  bits flipped: O(changed rows) instead of O(R).
- :class:`IncrementalEll` is the maintenance policy: patch on small
  drift, full rebuild only when a row overflows the padded width K or
  cumulative drift crosses ``rebuild_threshold``.  The ``sparse`` train
  engine and the ``TMServer`` publish path each keep one.

The layout is host logic, so it is the JAX package's numpy code, copied:
indices and ``nnz`` equal the JAX package's element for element.  Only
the finished index matrix goes to the engine's device.

Bit-exactness: a clause fires iff every included literal is 1 (an
all-padding row fires, the oracle's ``viol == 0`` convention), and a
patched layout is identical to a from-scratch build at the same K.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["EllLayout", "ell_from_include", "ell_apply_deltas",
           "IncrementalEll", "DEFAULT_K_SLACK", "DEFAULT_REBUILD_THRESHOLD"]

# shared refresh-policy defaults (the `sparse` train engine and the
# TMServer publish path both construct IncrementalEll with these)
DEFAULT_K_SLACK = 8
DEFAULT_REBUILD_THRESHOLD = 0.25


class EllLayout(NamedTuple):
    """Padded CSR (ELLPACK) clause-index layout.

    ``indices[r, k]`` is the k-th included literal of clause row ``r``;
    padding slots hold ``n_literals`` (the sentinel constant-1 column).
    ``indices`` lies on the engine's device; ``nnz`` is host bookkeeping
    and stays on the CPU.
    """

    indices: torch.Tensor   # (R, K) int32 — included literal ids, padded
    nnz: torch.Tensor       # (R,) int32 — true include count per row
    n_literals: int         # L: valid ids are [0, L); L is the sentinel

    @property
    def k_max(self) -> int:
        """Padded row width K."""
        return self.indices.shape[1]

    @property
    def density(self) -> float:
        """Mean include fraction (≈0.05 for trained machines)."""
        if self.n_literals == 0:
            return 0.0
        return float(self.nnz.numpy().mean()) / self.n_literals


def _host_mask(include) -> np.ndarray:
    """An include mask (numpy array or tensor on any device) → numpy
    bool."""
    if isinstance(include, torch.Tensor):
        include = include.detach().cpu().numpy()
    return np.asarray(include).astype(bool)


def _device_of(include, device):
    if device is not None:
        return torch.device(device)
    if isinstance(include, torch.Tensor):
        return include.device
    return torch.device("cpu")


def _layout(idx: np.ndarray, nnz: np.ndarray, n_literals: int,
            device) -> EllLayout:
    # copies: the host arrays are patched in place later, and a layout
    # already handed out (an engine pinned to an older state) must not move
    return EllLayout(indices=torch.tensor(idx, device=device),
                     nnz=torch.from_numpy(nnz.copy()),
                     n_literals=n_literals)


def _ell_rows(inc: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(R', L) bool include rows → ((R', k) int32 padded indices, nnz).

    ``argsort(~inc)`` (stable) lists each row's included columns first in
    ascending order; slots past ``nnz`` are the sentinel ``L``.
    """
    r, l = inc.shape
    nnz = inc.sum(axis=1).astype(np.int32)
    idx = np.full((r, k), l, dtype=np.int32)
    kk = min(k, l)
    if r and kk:
        order = np.argsort(~inc, axis=1, kind="stable")[:, :kk]
        valid = np.arange(kk)[None, :] < nnz[:, None]
        idx[:, :kk] = np.where(valid, order, l)
    return idx, nnz


def ell_from_include(include, *, k: int | None = None,
                     device=None) -> EllLayout:
    """Compress a ``(R, L)`` {0,1} include mask (numpy or tensor) into an
    :class:`EllLayout` whose indices lie on ``device`` (default: the
    mask's device, the CPU for numpy).

    ``k`` overrides the padded row width (at least the max per-row
    include count; defaults to exactly that max).
    """
    dev = _device_of(include, device)
    inc = _host_mask(include)
    r, l = inc.shape
    k_min = int(inc.sum(axis=1).max()) if r else 0
    if k is None:
        k = k_min
    elif k < k_min:
        raise ValueError(f"k={k} is below the max per-row include count "
                         f"{k_min}")
    idx, nnz = _ell_rows(inc, k)
    return _layout(idx, nnz, l, dev)


def ell_apply_deltas(indices: np.ndarray, nnz: np.ndarray,
                     include: np.ndarray, rows: np.ndarray) -> bool:
    """Patch the host ELL arrays in place for the rows whose include bits
    flipped → ``True``, or ``False`` (nothing written) when a patched row
    would overflow the padded width K.

    ``include`` is the new ``(R, L)`` bool mask, ``rows`` the changed row
    ids.  The patched matrix is identical to a from-scratch
    :func:`ell_from_include` at the same K.
    """
    k = indices.shape[1]
    sub = np.ascontiguousarray(include[rows])
    if sub.size and int(sub.sum(axis=1).max()) > k:
        return False
    idx, nn = _ell_rows(sub, k)
    indices[rows] = idx
    nnz[rows] = nn
    return True


class IncrementalEll:
    """Delta-driven ELL maintenance for one logical (drifting) model.

    Holds the host include mirror and index matrix and decides, per
    :meth:`refresh`, between the O(changed rows) patch and a full
    rebuild.  A rebuild happens only when a changed row overflows the
    padded width K, or cumulative drift since the last rebuild exceeds
    ``rebuild_threshold`` (a fraction of rows).  Rebuilds pad K by
    ``k_slack`` slots, rounded up to a multiple of 8, so typical online
    drift patches in place for many steps.  The layout's indices go to
    ``device`` (default: the first mask's device, the CPU for numpy).

    Not thread-safe: callers (the ``sparse`` train engine's training
    thread, the ``TMServer`` publish path) serialize refreshes.
    """

    def __init__(self, include, *, k_slack: int = DEFAULT_K_SLACK,
                 rebuild_threshold: float = DEFAULT_REBUILD_THRESHOLD,
                 device=None):
        if k_slack < 0:
            raise ValueError(f"k_slack must be >= 0, got {k_slack}")
        if not 0.0 <= rebuild_threshold <= 1.0:
            raise ValueError(f"rebuild_threshold must be in [0, 1], "
                             f"got {rebuild_threshold}")
        self.k_slack = int(k_slack)
        self.rebuild_threshold = float(rebuild_threshold)
        self.device = _device_of(include, device)
        self.rebuilds = 0           # full builds (the initial one counts)
        self.patches = 0            # delta-driven refreshes applied
        self.rows_patched = 0
        self._rebuild(_host_mask(include))

    def _alloc_k(self, inc: np.ndarray) -> int:
        r, l = inc.shape
        if l == 0:
            return 0
        k_min = int(inc.sum(axis=1).max()) if r else 0
        want = max(k_min + self.k_slack, 1)
        return min(l, -(-want // 8) * 8)

    def _rebuild(self, inc: np.ndarray) -> None:
        self._inc = inc.copy()
        self._idx, self._nnz = _ell_rows(inc, self._alloc_k(inc))
        self._since = 0             # rows patched since this rebuild
        self.rebuilds += 1
        self._emit()

    def _emit(self) -> None:
        self._layout = _layout(self._idx, self._nnz, self._inc.shape[1],
                               self.device)

    @property
    def layout(self) -> EllLayout:
        """The current layout (no refresh)."""
        return self._layout

    def refresh(self, include) -> EllLayout:
        """Bring the layout up to date with ``include`` → the layout.

        Returns the cached layout when nothing flipped; patches the
        flipped rows when drift is small; rebuilds on K overflow,
        threshold drift or a shape change.  The result always equals a
        from-scratch :func:`ell_from_include` of ``include`` at the same
        K.
        """
        inc = _host_mask(include)
        if inc.shape != self._inc.shape:
            self._rebuild(inc)
            return self._layout
        rows = np.nonzero((inc != self._inc).any(axis=1))[0]
        if rows.size == 0:
            return self._layout
        self._since += int(rows.size)
        if (self._since > self.rebuild_threshold * self._inc.shape[0]
                or not ell_apply_deltas(self._idx, self._nnz, inc, rows)):
            self._rebuild(inc)
            return self._layout
        self._inc[rows] = inc[rows]
        self.patches += 1
        self.rows_patched += int(rows.size)
        self._emit()
        return self._layout

    def stats(self) -> dict:
        """``{"rebuilds", "patches", "rows_patched", "k", "rows",
        "density"}`` — the maintenance counters ``TMServer.stats()``
        reports."""
        return {"rebuilds": self.rebuilds, "patches": self.patches,
                "rows_patched": self.rows_patched,
                "k": int(self._idx.shape[1]),
                "rows": int(self._idx.shape[0]),
                "density": self._layout.density}
