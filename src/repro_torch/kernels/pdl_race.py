"""Kernel K5: PDL race simulation — chain delays, arbiter argmin, first
arrival and the top-gap metastability flag (port of
``repro.kernels.pdl_race``).

    delay[b,c] = Σ_m (low_sel[b,c,m] ? low[c,m] : high[c,m]) + skew[c]
    winner     = argmin_c delay        (ties → lower index)
    latency    = min_c delay
    metastable = (second − latency) < t_res

where ``second`` is the earliest arrival strictly later than the
minimum, or the minimum itself when every class arrives together (C = 1
included), so such a row has gap 0.  These are the semantics of the
Pallas kernel ``repro/kernels/pdl_race.py:pdl_race_pallas`` (body
``_pdl_race_kernel``), which this replaces.  Its oracle
``repro/kernels/ref.py:ref_pdl_race`` differs when two classes tie for
the minimum (its ``top_k`` gap is 0 there); the port keeps that oracle as
:func:`repro_torch.kernels.ref.ref_pdl_race` and K5's plain version
:func:`pdl_race_plain` follows the kernel.

On a CUDA tensor :func:`pdl_race` launches the hand-written kernel in
``csrc/pdl_race.cu`` (a warp per (row, class) sums the delays, one
thread per row reduces over the classes; the (B, C) delays stay in
shared memory); on a CPU tensor it runs :func:`pdl_race_plain`.  Nothing
falls back: a CUDA build or launch failure raises.

Float32 sums run in another order on the card than in torch or XLA, so
on integer-valued delays (exact in any order) all agree bit for bit, and
on float delays ``latency`` agrees to rounding and ``winner`` and
``metastable`` agree away from near-ties.

This is not the ``time_domain`` engine's race: that engine uses
:func:`repro_torch.core.time_domain.race`, whose flag means "some
arbiter of the tournament saw a gap below ``t_res``".

Bound on an H100 at the ``kernel_bench`` shape B = 1024, C = 10,
M = 100: about 1.04 MB read and written, 0.31 µs at 3.35 TB/s.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pdl_race", "pdl_race_plain"]


def pdl_race_plain(low_sel: torch.Tensor, elem_delays: torch.Tensor,
                   skew: torch.Tensor, t_res: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's arithmetic with stock tensor ops: the gap runs to the
    earliest arrival strictly later than the minimum (0 when there is
    none).  Same arguments and results as :func:`pdl_race`."""
    per = torch.where(low_sel != 0, elem_delays[..., 0],
                      elem_delays[..., 1])                         # (B, C, M)
    delays = per.sum(-1) + skew[None, :]                           # (B, C)
    lat = delays.min(-1).values
    win = torch.argmin(delays, -1).to(torch.int32)   # the first minimum
    masked = torch.where(delays == lat[:, None], float("inf"), delays)
    second = masked.min(-1).values
    second = torch.where(torch.isinf(second), lat, second)
    meta = (second - lat) < float(np.float32(t_res))
    return win, lat, meta


def _check(low_sel, elem_delays, skew):
    if low_sel.dtype != torch.int8 or low_sel.dim() != 3:
        raise ValueError(f"low_sel must be a (B, C, M) int8 tensor, got "
                         f"{tuple(low_sel.shape)} {low_sel.dtype}")
    b, c, m = low_sel.shape
    if c == 0:
        raise ValueError("low_sel has no classes")
    for name, t, shape in (("elem_delays", elem_delays, (c, m, 2)),
                           ("skew", skew, (c,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a float32 tensor of shape "
                             f"{shape}, got {tuple(t.shape)} {t.dtype}")
        if t.device != low_sel.device:
            raise ValueError(f"{name} is on {t.device}, low_sel on "
                             f"{low_sel.device}")


def pdl_race(low_sel: torch.Tensor, elem_delays: torch.Tensor,
             skew: torch.Tensor, t_res: float
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """low_sel (B, C, M) int8 {0,1} — element takes the low-latency net;
    elem_delays (C, M, 2) float32 ps — ``[..., 0]`` low net, ``[..., 1]``
    high net; skew (C,) float32 ps → (winner (B,) int32, latency (B,)
    float32, metastable (B,) bool).

    CPU tensors: the plain version.  CUDA tensors: kernel K5, counted in
    ``pdl_race.launches``."""
    _check(low_sel, elem_delays, skew)
    if low_sel.device.type == "cpu":
        return pdl_race_plain(low_sel, elem_delays, skew, t_res)
    if low_sel.device.type != "cuda":
        raise ValueError(f"pdl_race runs on cpu or cuda, not "
                         f"{low_sel.device}")
    for name, t in (("low_sel", low_sel), ("elem_delays", elem_delays),
                    ("skew", skew)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .ops import launch
    b, c, m = low_sel.shape
    dev = low_sel.device
    win = torch.empty((b,), dtype=torch.int32, device=dev)
    lat = torch.empty((b,), dtype=torch.float32, device=dev)
    meta = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return win, lat, meta
    launch("pdl_race", (low_sel, elem_delays, skew, win, lat, meta),
           (b, c, m, float(t_res)))
    pdl_race.launches += 1
    return win, lat, meta


pdl_race.launches = 0
