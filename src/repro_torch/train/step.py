"""Train-step factory: loss → grads (with microbatch accumulation) →
AdamW (port of ``repro.train.step``).

The JAX ``make_train_step(loss_fn, hp)`` differentiates a pure
``loss_fn(params, batch)``.  The port's :class:`~repro_torch.models.model.LM`
holds its parameters, so :func:`make_train_step` takes the model — an
``LM(trainable=True)`` — and differentiates ``lm.loss`` through
``lm.params``, reading the gradients from ``lm.grads``.  The step's
arithmetic is the JAX step's: microbatching adds float32 gradient sums
over ``n_micro`` row slices (the first slice added to zeros) and divides
them by ``n_micro``, as the JAX ``lax.scan`` does (the loss is not
scaled); the learning rate comes from ``state.step`` before its
increment; the metrics are ``loss``, ``acc``, ``grad_norm`` and ``lr``.

On a sharded ``LM`` (``LM(mesh=...)``) each member's gradient is its
shard's; the copies of a replicated slice are summed in member order
(``lm.reduce_grads()``) before AdamW, which runs shard by shard.  Every
family trains on a mesh as it does without one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree as _tree
from repro_torch.distributed.sharding import ShardedTensor, leaf_parts
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update)
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["TrainState", "TrainHParams", "init_train_state",
           "make_train_step"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    n_micro: int = 1
    adamw: AdamWConfig = AdamWConfig()


def init_train_state(params) -> TrainState:
    """Zero moments and step (int32) for ``params``, on their device."""
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.count.device))


def _like(x, p, device):
    """A state leaf ``x`` placed as parameter leaf ``p``: a global
    array sliced for a sharded ``p``, else a tensor on ``device``."""
    if isinstance(x, ShardedTensor):
        return x
    if isinstance(p, ShardedTensor):
        return ShardedTensor.from_full(x, p.sharding, p.dtype)
    return torch.as_tensor(x, device=device)


def make_train_step(lm, hp: TrainHParams):
    """``lm`` an ``LM(trainable=True)`` → ``train_step(state, batch)`` →
    ``(state', metrics)``.

    ``batch`` maps ``tokens`` and ``targets`` (and ``prefix``, or
    ``frames`` for the encdec family) to (B, …)
    arrays or tensors, B a multiple of ``hp.n_micro``.  ``state.params``
    is ``lm.params``; a state restored from a checkpoint (other tensors
    or arrays of the same tree) is copied into ``lm.params`` first.  The
    parameters and moments are updated in place and returned in
    ``state'``."""
    if not lm.trainable:
        raise ValueError("make_train_step needs LM(..., trainable=True): a "
                         "serving LM holds no float32 masters or gradients")
    params, grads = lm.params, lm.grads
    p_leaves, g_leaves = _tree.leaves(params), _tree.leaves(grads)

    def load(state: TrainState) -> None:
        got = _tree.leaves(state.params)
        if len(got) != len(p_leaves):
            raise ValueError(f"state holds {len(got)} parameter leaves, the "
                             f"model {len(p_leaves)}")
        with torch.no_grad():
            for dst, src in zip(p_leaves, got):
                if src is not dst:
                    dst.copy_(src if isinstance(dst, ShardedTensor)
                              else torch.as_tensor(src))

    def grads_of(batch) -> dict:
        loss, metrics = lm.loss(batch)
        loss.backward()
        return metrics

    def train_step(state: TrainState, batch: dict):
        load(state)
        batch = {k: torch.as_tensor(v, device=lm.device)
                 for k, v in batch.items()}
        for g in g_leaves:
            for t in leaf_parts(g):
                t.zero_()
        if hp.n_micro > 1:
            n = hp.n_micro
            rows = next(iter(batch.values())).shape[0]
            if rows % n:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n} microbatches")
            mb = rows // n
            m_sum = {"loss": torch.zeros((), device=lm.device),
                     "acc": torch.zeros((), device=lm.device)}
            for i in range(n):
                m = grads_of({k: v[i * mb:(i + 1) * mb]
                              for k, v in batch.items()})
                m_sum = {k: m_sum[k] + m[k] for k in m_sum}
            lm.reduce_grads()
            with torch.no_grad():
                for g in g_leaves:
                    for t in leaf_parts(g):
                        t.div_(n)
            metrics = {k: v / n for k, v in m_sum.items()}
        else:
            metrics = grads_of(batch)
            lm.reduce_grads()
        lr = cosine_warmup(state.step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                           total=hp.total_steps)
        step = torch.as_tensor(state.step, device=lm.device)
        mu, nu, count = state.opt
        opt = OptState(*[_tree.map(lambda x, p: _like(x, p, lm.device), t,
                                   params) for t in (mu, nu)],
                       torch.as_tensor(count, device=lm.device))
        new_params, opt, opt_metrics = adamw_update(hp.adamw, grads, opt,
                                                    params, lr)
        return TrainState(params=new_params, opt=opt, step=step + 1), \
            {**metrics, **opt_metrics, "lr": lr}

    return train_step
