"""Fault tolerance and elasticity (port of
``repro.distributed.fault_tolerance``).

- :class:`StragglerWatchdog`: a per-step deadline timer; on expiry it
  calls a policy hook (default: record and continue).
- :class:`ElasticRunner`: on a device-set change, rebuild the mesh from
  the live device list, re-derive the placement of every leaf and
  restore the latest checkpoint onto it.
- :func:`run_with_recovery`: the supervisor loop — a checkpoint of the
  starting state, an asynchronous one every k steps, restart from the
  latest one on failure, bounded retries.

Checkpoints go through :mod:`repro_torch.checkpoint`, the JAX package's
on-disk format, so a run either package checkpointed resumes in the
other.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import tree as _tree

from .sharding import ShardedTensor, visible_devices

__all__ = ["ElasticRunner", "StragglerWatchdog", "run_with_recovery"]


class StragglerWatchdog:
    """Flags steps exceeding ``deadline_s``; policy hook for mitigation."""

    def __init__(self, deadline_s: float,
                 on_straggle: Callable[[int, float], None] | None = None):
        self.deadline_s = deadline_s
        self.on_straggle = on_straggle or (lambda step, dt: None)
        self.slow_steps: list[tuple[int, float]] = []

    def step(self, step_idx: int, fn: Callable[[], Any]) -> Any:
        t0 = time.monotonic()
        done = threading.Event()

        def watch():
            if not done.wait(self.deadline_s):
                dt = time.monotonic() - t0
                self.slow_steps.append((step_idx, dt))
                self.on_straggle(step_idx, dt)

        w = threading.Thread(target=watch, daemon=True)
        w.start()
        try:
            return fn()
        finally:
            done.set()


@dataclasses.dataclass
class ElasticRunner:
    """Rebuild mesh + placements from the live device set and restore.

    ``mesh_factory(devices)`` returns the port's
    :class:`~repro_torch.distributed.sharding.Mesh` over exactly those
    devices (e.g. ``launch.mesh.mesh_from_devices``); ``shardings_factory(
    mesh)`` gives the restore's ``shardings=`` tree (``torch.device`` or
    ``NamedSharding`` leaves, or ``None``; an ``LM``'s
    ``param_shardings()``), the same function a cold start uses.
    """

    mesh_factory: Callable[[list], Any]
    shardings_factory: Callable[[Any], Any]
    ckpt_dir: str

    def recover(self, like_tree, devices=None):
        """→ ``(mesh, shardings, tree, extra)``; ``tree`` and ``extra``
        are ``None`` when ``ckpt_dir`` holds no valid checkpoint.
        ``devices``: a list of ``torch.device`` (default: the visible
        CUDA devices; raises when there are none)."""
        if devices is None:
            devices = visible_devices()
            if not devices:
                raise RuntimeError(
                    "ElasticRunner.recover: no CUDA device visible; pass "
                    "devices= (e.g. [torch.device('cpu')])")
        mesh = self.mesh_factory(list(devices))
        shardings = self.shardings_factory(mesh)
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return mesh, shardings, None, None
        tree, extra = ckpt.restore(self.ckpt_dir, step, like_tree,
                                   shardings=shardings)
        return mesh, shardings, tree, {"step": step, **extra}


def _restore_like(ckpt_dir: str, step: int, state):
    """Restore ``step`` into ``state``'s structure, each leaf that is a
    tensor in ``state`` back on that tensor's device (the JAX restore's
    numpy leaves go back onto the device when the jitted step reads
    them), and each sharded one re-sliced over its mesh."""
    tree, _ = ckpt.restore(ckpt_dir, step, state)

    def place(new, old):
        if isinstance(old, ShardedTensor):
            return ShardedTensor.from_full(new, old.sharding, old.dtype)
        if isinstance(old, torch.Tensor):
            return torch.as_tensor(new).to(old.device)
        return new
    return _tree.map(place, tree, state)


def run_with_recovery(step_fn: Callable[[Any, int], Any], state: Any, *,
                      n_steps: int, ckpt_dir: str, ckpt_every: int = 50,
                      max_restarts: int = 3,
                      deadline_s: float = 300.0,
                      state_extra: Callable[[Any], dict] | None = None):
    """Supervised train loop: async checkpoints + restart-from-latest.

    ``step_fn(state, i) -> state``.  Exceptions trigger restore of the
    latest checkpoint and a retry (bounded).  Checkpoints it started are
    waited for before a restore picks the latest and before it returns
    the final state.

    Unlike the JAX loop, which retries a failure before the first
    checkpoint from the state it holds, a run that starts on a directory
    without checkpoints first writes one of ``state`` at step 0: the
    port's train step updates parameters and moments in place, so a step
    that fails after its update would otherwise be replayed on top of
    it."""
    watchdog = StragglerWatchdog(deadline_s)
    writers: list[threading.Thread] = []
    restarts = 0
    start = ckpt.latest_step(ckpt_dir)
    i = 0 if start is None else start
    if start is None:
        ckpt.save(ckpt_dir, 0, state,
                  extra=state_extra(state) if state_extra else {})
    else:
        state = _restore_like(ckpt_dir, start, state)
    try:
        while i < n_steps:
            try:
                state = watchdog.step(i, lambda: step_fn(state, i))
                i += 1
                if i % ckpt_every == 0 or i == n_steps:
                    extra = state_extra(state) if state_extra else {}
                    writers.append(ckpt.save_async(ckpt_dir, i, state,
                                                   extra=extra))
            except Exception:
                restarts += 1
                if restarts > max_restarts:
                    raise
                for t in writers:       # let started checkpoints land
                    t.join()
                i = ckpt.latest_step(ckpt_dir)
                state = _restore_like(ckpt_dir, i, state)
    finally:
        for t in writers:
            t.join()
    return state
