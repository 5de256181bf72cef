"""Carry the JAX package's arrays across into the port.

- :func:`state_from_numpy` turns a JAX-side ``TMState`` —
  ``np.asarray(state.ta)``, a ``(C, M, 2F)`` int32 array — into the
  port's :class:`~repro_torch.core.tm.TMState` on a device;
- :func:`device_from_numpy` turns a JAX ``PDLDevice``'s two arrays into
  the port's :class:`~repro_torch.core.time_domain.PDLDevice`;
- :func:`bnn_params_from_numpy` turns a JAX ``BNNParams``' weight arrays
  into the port's :class:`~repro_torch.core.bnn.BNNParams`.

Later slices extend this module (key cursors, checkpoints).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bnn import BNNParams
from repro_torch.core.time_domain import PDLDevice
from repro_torch.core.tm import TMState
from repro_torch.kernels.ops import resolve_device

__all__ = ["state_from_numpy", "device_from_numpy", "bnn_params_from_numpy"]


def state_from_numpy(ta: np.ndarray, *, device=None) -> TMState:
    """``(C, M, 2F)`` integer TA states → :class:`TMState` on ``device``
    (``None`` → cuda; raises where no GPU is visible)."""
    ta = np.asarray(ta)
    if ta.ndim != 3 or not np.issubdtype(ta.dtype, np.integer):
        raise ValueError(f"ta must be a (C, M, 2F) integer array, got "
                         f"{ta.shape} {ta.dtype}")
    return TMState(ta=torch.as_tensor(ta.astype(np.int32),
                                      device=resolve_device(device)))


def _float32(a, name: str, ndim: int, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim != ndim or not np.issubdtype(a.dtype, np.floating):
        raise ValueError(f"{name} must be a {ndim}-D float array, got "
                         f"{a.shape} {a.dtype}")
    return torch.tensor(a.astype(np.float32), device=device)


def device_from_numpy(elem_offset, skew, *, device=None) -> PDLDevice:
    """A JAX ``PDLDevice``'s ``(C, M, 2)`` element offsets and ``(C,)``
    skew (ps) → the port's :class:`PDLDevice` on ``device`` (``None`` →
    cuda), float32, values unchanged."""
    dev = resolve_device(device)
    off = _float32(elem_offset, "elem_offset", 3, dev)
    sk = _float32(skew, "skew", 1, dev)
    if off.shape[-1] != 2 or sk.shape[0] != off.shape[0]:
        raise ValueError(f"elem_offset (C, M, 2) and skew (C,) do not "
                         f"match: {tuple(off.shape)}, {tuple(sk.shape)}")
    return PDLDevice(elem_offset=off, skew=sk)


def bnn_params_from_numpy(weights, *, device=None) -> BNNParams:
    """A JAX ``BNNParams``' real master weights, one ``(d_in, d_out)``
    array per layer → the port's :class:`BNNParams` on ``device``
    (``None`` → cuda), float32, values unchanged."""
    dev = resolve_device(device)
    ws = tuple(_float32(w, f"weights[{i}]", 2, dev)
               for i, w in enumerate(weights))
    for i in range(1, len(ws)):
        if ws[i].shape[0] != ws[i - 1].shape[1]:
            raise ValueError(f"layer {i} takes {ws[i].shape[0]} inputs but "
                             f"layer {i - 1} gives {ws[i - 1].shape[1]}")
    return BNNParams(weights=ws)
