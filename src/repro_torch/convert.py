"""Carry the JAX package's state across into the port.

:func:`state_from_numpy` is the one entry that turns a JAX-side
``TMState`` — ``np.asarray(state.ta)``, a ``(C, M, 2F)`` int32 array — into
the port's :class:`~repro_torch.core.tm.TMState` on a device.  Later
slices extend this module (key cursors, checkpoints).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tm import TMState
from repro_torch.kernels.ops import resolve_device

__all__ = ["state_from_numpy"]


def state_from_numpy(ta: np.ndarray, *, device=None) -> TMState:
    """``(C, M, 2F)`` integer TA states → :class:`TMState` on ``device``
    (``None`` → cuda; raises where no GPU is visible)."""
    ta = np.asarray(ta)
    if ta.ndim != 3 or not np.issubdtype(ta.dtype, np.integer):
        raise ValueError(f"ta must be a (C, M, 2F) integer array, got "
                         f"{ta.shape} {ta.dtype}")
    return TMState(ta=torch.as_tensor(ta.astype(np.int32),
                                      device=resolve_device(device)))
