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

A leaf may be a :class:`~repro_torch.distributed.sharding.ShardedTensor`
(a sharded ``LM``'s): the update runs shard by shard on each member's
device, and the global norm sums every distinct slice's squares once,
in leaf and then member order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree as _tree
from repro_torch.distributed.sharding import ShardedTensor, leaf_parts

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


def _zeros_like(x):
    if isinstance(x, ShardedTensor):
        return x.map(torch.zeros_like)
    return torch.zeros_like(x)


def adamw_init(params) -> OptState:
    """Zero moments shaped like ``params``; ``count`` an int32 scalar on
    the first leaf's device."""
    dev = _tree.leaves(params)[0].device
    return OptState(mu=_tree.map(_zeros_like, params),
                    nu=_tree.map(_zeros_like, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """``√Σ leaf²`` in float32, the per-leaf sums added in leaf order (a
    ShardedTensor's distinct shards one after another), on the first
    leaf's device."""
    leaves = _tree.leaves(tree)
    dev = leaves[0].device
    sq = [torch.sum(torch.square(t.float())).to(dev)
          for x in leaves
          for t in ([t for _, t in x.distinct()]
                    if isinstance(x, ShardedTensor) else [x])]
    return torch.sqrt(sum(sq))


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
    parts = [list(zip(*map(leaf_parts, t))) for t in zip(ps, gs, ms, vs)]
    for p, g, m, v in (t for leaf in parts for t in leaf):
        dev = p.device
        g = g * scale.to(dev)
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        update = (m / c1.to(dev)) / (torch.sqrt(v / c2.to(dev)) + cfg.eps)
        pf = p.float()
        lr_d = lr.to(dev) if isinstance(lr, torch.Tensor) else lr
        p.copy_(pf - lr_d * (update + cfg.weight_decay * pf))
    return params, OptState(mu=state.mu, nu=state.nu, count=count), \
        {"grad_norm": gnorm}
