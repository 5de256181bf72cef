"""Binarized NN with xnor-popcount neurons (paper Fig. 1(b) + §V future
work; port of ``repro.core.bnn``).

- Hidden neuron: ``a = sign(popcount(xnor(x, w)) − n/2)`` — matches
  minus mismatches against ±1 weights.  The time-domain variant (paper
  §V) gives each neuron a PDL fed by the xnor bits and races it against
  a shared *neutral* PDL with as many ones as zeros; an arbiter emits the
  sign.
- Output layer: popcount per class + argmax — the TM voting head, so it
  reuses :mod:`repro_torch.core.time_domain` for the race.
- Training: straight-through estimator (STE) over real-valued master
  weights; forward binarizes, backward passes the clipped identity
  (a ``torch.autograd.Function``, where JAX has a ``custom_vjp``).

``bnn_apply``'s ``x @ w`` is a plain float product, as in the JAX
package (it lies outside any Pallas kernel); with ±1 operands every
partial sum is an integer below 2²⁴, so it is exact in any order.  The
±1 GEMM kernel K6 serves the int8 inference path
(``kernels.binary_matmul.binary_matmul``, ``launch/bnn_popcount.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .popcount import argmax_tournament
from .time_domain import PDLConfig, PDLDevice, pdl_delays

__all__ = ["BNNConfig", "BNNParams", "init_bnn", "bnn_apply", "bnn_loss",
           "binarize_ste", "xnor_popcount_layer", "time_domain_sign",
           "bnn_predict_time_domain"]


@dataclasses.dataclass(frozen=True)
class BNNConfig:
    in_features: int
    hidden: tuple[int, ...]
    n_classes: int


class BNNParams(NamedTuple):
    weights: tuple[torch.Tensor, ...]   # real master weights, layer i: (d_in, d_out)


def init_bnn(cfg: BNNConfig, generator: torch.Generator, *,
             device=None) -> BNNParams:
    """Gaussian master weights scaled by ``1/√d_in``, drawn on the CPU
    from ``generator`` and moved to ``device`` (a torch generator gives
    other numbers than ``jax.random``: carry JAX's weights across with
    :func:`repro_torch.convert.bnn_params_from_numpy` to compare)."""
    dims = (cfg.in_features, *cfg.hidden, cfg.n_classes)
    ws = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        dtype=torch.float32) * (1.0 / math.sqrt(dims[i]))
        ws.append(w.to(device))
    return BNNParams(weights=tuple(ws))


class _BinarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        dtype = w.dtype if w.dtype.is_floating_point else torch.float32
        return torch.where(w >= 0, 1.0, -1.0).to(dtype)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * (w.abs() <= 1.0).to(g.dtype)   # clipped identity


def binarize_ste(w: torch.Tensor) -> torch.Tensor:
    """``sign(w)`` as ±1 (0 → +1); gradient: the clipped identity
    ``g · (|w| ≤ 1)``."""
    return _BinarizeSTE.apply(w)


def xnor_popcount_layer(x_pm1: torch.Tensor, w_pm1: torch.Tensor
                        ) -> torch.Tensor:
    """±1 activations × ±1 weights.  ``x @ w`` equals
    ``2·popcount(xnor(bits)) − n`` — the matmul *is* the popcount."""
    return x_pm1 @ w_pm1


def bnn_apply(cfg: BNNConfig, params: BNNParams, x_pm1: torch.Tensor,
              *, hard: bool = True) -> torch.Tensor:
    """Forward pass → class scores (popcount-style integer-valued floats)."""
    h = x_pm1
    n = len(params.weights)
    for i, w in enumerate(params.weights):
        h = xnor_popcount_layer(h, binarize_ste(w))
        if i < n - 1:
            h = binarize_ste(h) if hard else torch.tanh(h)
    return h  # (B, n_classes) vote scores


def bnn_loss(cfg: BNNConfig, params: BNNParams, x_pm1: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(0.1 · scores)``."""
    logits = bnn_apply(cfg, params, x_pm1, hard=True)
    logp = torch.log_softmax(logits.to(torch.float32) * 0.1, dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def time_domain_sign(pdl: PDLConfig, device: PDLDevice,
                     match_bits: torch.Tensor, *,
                     key: torch.Tensor | None = None) -> torch.Tensor:
    """Paper §V sign activation: neuron PDL vs a neutral half-ones PDL.

    match_bits: (B, N, n) xnor match bits per neuron → (B, N) ±1
    float32.  The neutral line (row N of ``device``) has exactly n/2
    ones; a neuron fires (+1) iff its PDL (more matches → faster) beats
    the neutral line.
    """
    b, nn_, n = match_bits.shape
    neutral = (torch.arange(n, device=match_bits.device) % 2) \
        .to(match_bits.dtype).expand(b, 1, n)
    pairs = torch.cat([match_bits, neutral], dim=1)          # (B, N+1, n)
    pol = torch.ones((n,), dtype=torch.int32, device=match_bits.device)
    delays = pdl_delays(pdl, device, pairs, pol, key=key)    # (B, N+1)
    fire = delays[:, :nn_] < delays[:, nn_:nn_ + 1]
    return torch.where(fire, 1.0, -1.0)


def bnn_predict_time_domain(cfg: BNNConfig, params: BNNParams,
                            pdl: PDLConfig, devices: list[PDLDevice],
                            x_pm1: torch.Tensor, *,
                            key: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Full §V inference: hidden signs via neutral-PDL races (one device
    per hidden layer), the output through the arbiter tournament →
    (B,) int32 predicted class."""
    h = x_pm1
    n = len(params.weights)
    for i, w in enumerate(params.weights):
        wb = binarize_ste(w)
        if i < n - 1:
            xb = (h > 0)[:, None, :]                     # (B, 1, d_in)
            wbit = (wb > 0).T[None]                      # (1, d_out, d_in)
            match = (xb == wbit).to(torch.int8)          # (B, d_out, d_in)
            h = time_domain_sign(pdl, devices[i], match, key=key)
        else:
            scores = xnor_popcount_layer(h, wb)          # (B, C)
            return argmax_tournament(scores.to(torch.int32))
    raise AssertionError("unreachable")
