"""AdamW with decoupled weight decay and global-norm gradient clipping
(port of ``repro.optim.adamw``; not ``torch.optim.AdamW``, which decays
before the step and clips nothing).

The arithmetic is the JAX function's, in its order, in float32:
``scale = min(1, clip / max(‖g‖, 1e-9))``, ``c1 = 1 − b1**count``,
``p − lr·(m̂/(√(v/c2) + eps) + wd·p)``.  Trees are nested dicts, lists
and NamedTuples of tensors (:mod:`repro_torch.tree`), walked in
``jax.tree.leaves`` order, so :func:`global_norm` sums the leaves as
JAX does.

The JAX function returns new trees; :func:`adamw_update` writes the new
parameters and moments into the given tensors (no second copy of a
model's masters and moments) and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree as _tree

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw_init(params) -> OptState:
    """Zero moments shaped like ``params``; ``count`` an int32 scalar on
    the first leaf's device."""
    dev = _tree.leaves(params)[0].device
    return OptState(mu=_tree.map(torch.zeros_like, params),
                    nu=_tree.map(torch.zeros_like, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """``√Σ leaf²`` in float32, the per-leaf sums added in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _tree.leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: OptState, params,
                 lr: torch.Tensor):
    """→ (params, state, metrics); ``params``, ``state.mu`` and
    ``state.nu`` are updated in place and returned, ``grads`` is left
    as it was.  ``lr`` a float32 scalar tensor (or a float)."""
    gnorm = global_norm(grads)
    clip = torch.full_like(gnorm, cfg.clip_norm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    count = state.count + 1
    c1 = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    c2 = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))

    ps, gs = _tree.leaves(params), _tree.leaves(grads)
    ms, vs = _tree.leaves(state.mu), _tree.leaves(state.nu)
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError("params, grads and moments differ in structure")
    for p, g, m, v in zip(ps, gs, ms, vs):
        g = g * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        update = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (update + cfg.weight_decay * pf))
    return params, OptState(mu=state.mu, nu=state.nu, count=count), \
        {"grad_norm": gnorm}
