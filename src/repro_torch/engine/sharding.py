"""Batch-axis sharding for any VoteEngine: data-parallel serving (port of
``repro.engine.sharding``).

``ShardedEngine`` splits each batch into one slice per member of a 1-D
mesh and runs the inner backend on every slice, each on its member's
device, from the one calling thread — where the JAX engine has a
``shard_map``.  Results concatenate back on the batch axis on the inner
engine's device; every backend's ``EngineResult`` leaves (prediction,
class sums, ``aux`` arrays) are batch-leading, so this works for each.

The inner engine's layout is copied once per distinct mesh device at
construction (a shard on the inner engine's own device uses it as is),
so a call moves only its literal slice and its results.  Members may
repeat (a simulated mesh): their shards then run one after another on
that device, through the same code.

Ragged batches pad to a multiple of the shard count with all-zero
literal rows (a valid input: clauses evaluate normally) and the padding
is sliced off, so callers never see it.
"""

from __future__ import annotations

import copy

import torch

from repro_torch.distributed.sharding import Mesh, data_mesh

from .base import EngineResult, VoteEngine, pad_batch

__all__ = ["ShardedEngine"]


def _moved(value, src: torch.device, dst: torch.device):
    """``value`` with its tensors on ``src`` moved to ``dst``: nested
    engines are replicated, tuples (layouts such as ``EllLayout``) and
    dicts rebuilt only where an item changed (so counters such as a
    cascade's ``passes`` stay shared between replicas), anything else
    shared."""
    if isinstance(value, torch.Tensor):
        return value.to(dst) if value.device == src else value
    if hasattr(value, "infer"):
        return _replica(value, dst)
    if isinstance(value, tuple):
        items = [_moved(x, src, dst) for x in value]
        if all(a is b for a, b in zip(items, value)):
            return value
        if hasattr(value, "_fields"):           # a NamedTuple
            return type(value)(*items)
        return tuple(items)
    if isinstance(value, dict):
        items = {k: _moved(v, src, dst) for k, v in value.items()}
        if all(items[k] is v for k, v in value.items()):
            return value
        return items
    return value


def _replica(engine, device: torch.device):
    """A shallow copy of ``engine`` whose layout tensors live on
    ``device`` (the copy's ``device`` names it)."""
    src = engine.device
    if src == device:
        return engine
    clone = copy.copy(engine)
    for name, value in vars(engine).items():
        setattr(clone, name, _moved(value, src, device))
    clone.device = device
    return clone


class ShardedEngine:
    """Serve ``inner.infer`` data-parallel over the batch axis.

    ``mesh=`` serves over an existing 1-D mesh (e.g.
    :func:`repro_torch.distributed.sharding.data_mesh`, the one a
    mesh-configured ``TMServer`` routes its stage-B buckets through);
    ``devices=`` builds a private ``("batch",)`` mesh over those devices;
    neither takes every visible CUDA device.  An inner engine with a
    ``noise_key`` is refused: every shard would draw the same jitter.
    """

    def __init__(self, inner: VoteEngine, devices=None, *, mesh=None):
        if getattr(inner, "noise_key", None) is not None:
            raise ValueError(
                "shard_batch with a noise_key would replicate the same "
                "per-event jitter on every device shard; run unsharded or "
                "drop the noise_key")
        self.inner = inner
        self.cfg = inner.cfg
        self.name = f"{inner.name}+shard_batch"
        self.device = inner.device
        if mesh is not None:
            if len(mesh.axis_names) != 1:
                raise ValueError(
                    f"ShardedEngine needs a 1-D mesh, got {mesh.axis_names}")
            self.mesh = mesh
        else:
            devs = tuple(devices) if devices is not None else \
                data_mesh().devices
            self.mesh = Mesh(devs, ("batch",))
        self.n_devices = self.mesh.size
        self.replicas = {dev: _replica(inner, dev)
                         for dev in self.mesh.distinct_devices()}

    def infer(self, literals) -> EngineResult:
        """(B, 2F) literals (numpy or a tensor) → the inner engine's
        result, tensors on the inner engine's device; shard ``i`` runs on
        mesh member ``i``.  A shard whose result is not on its member's
        device raises."""
        b = literals.shape[0]
        d = self.n_devices
        bp = -(-b // d) * d
        if bp != b:
            literals = pad_batch(literals, bp)
        per = bp // d
        parts = []
        for i, dev in enumerate(self.mesh.devices):
            res = self.replicas[dev].infer(literals[i * per:(i + 1) * per])
            if res.class_sums.device != dev:
                raise RuntimeError(f"{self.name}: shard {i} ran on "
                                   f"{res.class_sums.device}, not {dev}")
            parts.append(res)

        def cat(leaves):
            return torch.cat([x.to(self.device) for x in leaves])[:b]

        return EngineResult(cat([p.prediction for p in parts]),
                            cat([p.class_sums for p in parts]),
                            {k: cat([p.aux[k] for p in parts])
                             for k in parts[0].aux})
