"""Carry the JAX package's arrays across into the port.

- :func:`state_from_numpy` turns a JAX-side ``TMState`` —
  ``np.asarray(state.ta)``, a ``(C, M, 2F)`` int32 array — into the
  port's :class:`~repro_torch.core.tm.TMState` on a device;
- :func:`device_from_numpy` turns a JAX ``PDLDevice``'s two arrays into
  the port's :class:`~repro_torch.core.time_domain.PDLDevice`;
- :func:`bnn_params_from_numpy` turns a JAX ``BNNParams``' weight arrays
  into the port's :class:`~repro_torch.core.bnn.BNNParams`;
- :func:`lm_params_from_numpy` loads a JAX ``LM`` parameter tree into
  the port's :class:`~repro_torch.models.model.LM`.

Later slices extend this module (key cursors, checkpoints).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bnn import BNNParams
from repro_torch.core.time_domain import PDLDevice
from repro_torch.core.tm import TMState
from repro_torch.kernels.ops import resolve_device

__all__ = ["state_from_numpy", "device_from_numpy", "bnn_params_from_numpy",
           "lm_params_from_numpy"]


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


def _flatten_tree(tree, prefix: tuple = ()) -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten_tree(v, prefix + (k,)))
    return out


def lm_params_from_numpy(tree, lm):
    """A JAX ``LM`` parameter tree — nested dicts of numpy arrays, the
    layer axis stacked first (``jax.tree.map(np.asarray, params)``) —
    loaded into the port's ``lm`` (an :class:`~repro_torch.models.model.LM`
    built from the same config and ``tp``), the layer axis unstacked,
    each leaf cast to its parameter's dtype on ``lm``'s device.  Raises
    ``ValueError`` on any missing, extra or mis-shaped leaf, before
    anything is copied.  Returns ``lm``."""
    from repro_torch.models.common import flatten_defs
    want = {path: d.shape for path, d in flatten_defs(lm.param_defs())}
    got = _flatten_tree(tree)
    names = lambda paths: sorted("/".join(p) for p in paths)  # noqa: E731
    missing, extra = names(want.keys() - got.keys()), \
        names(got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"parameter tree does not match {lm.cfg.name}: "
                         f"missing {missing}, extra {extra}")
    for path, shape in want.items():
        a = np.asarray(got[path])
        if a.shape != tuple(shape) or not (np.issubdtype(a.dtype, np.floating)
                                           or a.dtype.name == "bfloat16"):
            raise ValueError(f"{'/'.join(path)}: expected a float array of "
                             f"shape {tuple(shape)}, got {a.shape} {a.dtype}")
    for path in want:
        lm.load_leaf(path, torch.tensor(np.asarray(got[path],
                                                   dtype=np.float32)))
    return lm
