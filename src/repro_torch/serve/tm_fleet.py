"""Multi-tenant TM serving: many named models behind one scheduler (port
of ``repro.serve.tm_fleet``).

A TM deployment is rarely one model: it is many small per-cohort or
per-surface models.  :class:`TMFleet` serves many named models on one
device worker with three sharing mechanisms:

- **Shared engine-cache budget with weighted eviction.**  Every model's
  engines live in the process-wide keyed LRU (:mod:`repro_torch.engine.
  base`); the fleet sets an entry/byte budget (``cache_entries=`` /
  ``cache_bytes=``) and registers each model's request share as its
  eviction weight on every publish and every few requests, so a hot
  model's engines survive budget pressure from cold siblings whichever
  was touched last.  ``weights={name: w}`` pins static weights instead.

- **Per-model versioned state and lifecycle.**  Every model is backed by
  its own :class:`~repro_torch.serve.tm_server.TMServer` (online learning
  on its own key chain, checkpoints, history ring, rollback, probe);
  :meth:`TMFleet.checkpoint` / :meth:`TMFleet.restore` /
  :meth:`TMFleet.rollback` name the model.

- **Cross-model batch packing.**  Models sharing a clause-plane shape
  ``(n_clauses, n_features, n_states)`` form a *pack group*: their ``ta``
  planes concatenate along the class axis into one fused machine (class
  sums are per-class independent), served by one group ``TMServer``.
  Requests for any member coalesce into the same micro-batches, so k
  models' trickles fill one kernel launch instead of k under-filled ones.
  Each response unpacks once: the member's class-sum columns ``[lo:hi)``
  equal the solo machine's bit for bit, and its prediction is the argmax
  over that slice (``np.argmax``: ties → lowest index, every engine's
  tie rule).  Inference never reads ``T``/``s``, so members may differ in
  training hyperparameters and still pack.  A ``cascade`` shed tier on a
  pack group is forced to ``exact_sums=True``: early exit proves only the
  global fused argmax, and a member's segment argmax needs exact sums.

Isolation contract (held to the JAX ``TMFleet`` in
``tests/test_torch_fleet.py``): for any interleaved multi-model trace,
each model's responses — predictions and class sums — equal a solo
``TMServer`` replaying only that model's requests, across packed and
unpacked buckets, version pins, shed tiers and checkpoint restarts; one
model's failing update, corrupt checkpoint or engine-build error never
touches a sibling's serving path.  A single-model fleet behaves as a bare
``TMServer`` (no group forms).

The fleet runs on ``device`` (``None`` → cuda, raising where no GPU is
visible); every member and group server gets it.  ``mesh=`` (a 1-D mesh
or a device count) is forwarded to every member server and every pack
group's fused server, so packed buckets shard as solo ones do; a model's
own ``mesh=`` in its spec wins for its member server.  With a mesh the
fleet's device is the mesh's first device.

>>> fleet = TMFleet({"en": {"cfg": cfg, "state": s1,
...                         "train_backend": "fused"},
...                  "de": {"cfg": cfg, "state": s2}},
...                 ServePolicy(max_batch=64, backend="mxu_fused"))
>>> async with fleet:
...     res = await fleet.submit("en", literals)
...     version = await fleet.submit_labeled("en", literals, labels)
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.tm import TMConfig, TMState
from repro_torch.distributed import sharding
from repro_torch.engine import (EngineResult, engine_cache_info,
                                set_engine_cache_budget, state_nbytes,
                                weight_engines_for_state)
from repro_torch.kernels.ops import resolve_device

from .loadgen import DeadlineExceeded, percentiles_ms
from .tm_server import ServePolicy, TMServer

__all__ = ["TMFleet", "pack_key", "fuse_states"]

# re-register a model's eviction weight every this many requests, so the
# popularity weighted eviction reads stays fresh under traffic without a
# registry write per request
_REWEIGHT_EVERY = 32


def pack_key(cfg: TMConfig) -> tuple:
    """The clause-plane shape two models must share to pack:
    ``(n_clauses, n_features, n_states)``.  Class counts may differ
    (classes concatenate); ``T``/``s`` may differ (inference never reads
    them)."""
    return (cfg.n_clauses, cfg.n_features, cfg.n_states)


def fuse_states(states) -> TMState:
    """Concatenate member ``ta`` planes along the class axis, on the
    members' device → the pack group's fused state.  Exact by
    construction: class sums are per-class independent, so fused column
    ``lo + j`` equals member column ``j`` of a solo machine."""
    dev = states[0].ta.device
    return TMState(ta=torch.cat([s.ta.to(dev) for s in states], dim=0))


def _group_policy(policy: ServePolicy) -> ServePolicy:
    """The pack-group server's policy: the fleet policy with a
    ``cascade`` shed tier forced to ``exact_sums=True`` — early exit
    proves the global fused argmax only, and unpacking a member needs
    its exact class-sum segment."""
    if policy.shed_backend != "cascade":
        return policy
    opts = dict(policy.resolved_shed_opts())
    opts["exact_sums"] = True
    return dataclasses.replace(policy, shed_opts=opts)


class _Model:
    """Fleet-side record for one named model: its lifecycle server, the
    pack group serving its predicts (``None`` for solo serving), its
    class-column segment in the fused machine and per-model traffic
    counters."""

    __slots__ = ("name", "cfg", "server", "group", "lo", "hi",
                 "weight_override", "requests", "errors", "rejects",
                 "latencies")

    def __init__(self, name, cfg, server, *, weight_override=None,
                 latency_window=4096):
        self.name = name
        self.cfg = cfg
        self.server = server
        self.group = None
        self.lo = 0
        self.hi = cfg.n_classes
        self.weight_override = weight_override
        self.requests = 0
        self.errors = 0
        self.rejects = 0
        self.latencies: deque[float] = deque(maxlen=latency_window)


class _PackGroup:
    """One fused serving plane over two or more same-shape members.

    Owns the fused ``TMServer`` and the member → class-column mapping;
    :meth:`republish` re-stacks the members' current states into a new
    fused version.  Each member's publish hook calls it, so a member
    update is visible to packed predicts before the update's future
    resolves — exactly when a solo server would show it."""

    __slots__ = ("key", "members", "server", "_lock")

    def __init__(self, key, members, policy, executor, device, mesh=None):
        self.key = key
        self.members = list(members)        # _Model records, in order
        self._assign_segments()
        cfg0 = self.members[0].cfg
        fused_cfg = TMConfig(
            n_classes=sum(m.cfg.n_classes for m in self.members),
            n_clauses=cfg0.n_clauses, n_features=cfg0.n_features,
            n_states=cfg0.n_states, T=cfg0.T, s=cfg0.s)
        # republish reads every member's state and bumps the group's
        # version: one at a time, whichever thread a member publishes on
        self._lock = threading.Lock()
        self.server = TMServer(
            fused_cfg, fuse_states([m.server.state for m in self.members]),
            _group_policy(policy), executor=executor, device=device,
            mesh=mesh)

    def _assign_segments(self) -> None:
        lo = 0
        for m in self.members:
            m.lo, m.hi = lo, lo + m.cfg.n_classes
            lo = m.hi

    def republish(self) -> int:
        """Re-stack the member states → publish a new fused version."""
        with self._lock:
            return self.server.publish(
                fuse_states([m.server.state for m in self.members]))


def _unpack(res: EngineResult, lo: int, hi: int) -> EngineResult:
    """Slice one member's result out of a fused-group result: class-sum
    columns ``[lo:hi)`` and their argmax (ties → lowest index, the engine
    tie rule).  Row-aligned ``aux`` passes through unchanged."""
    cs = np.asarray(res.class_sums)[:, lo:hi]
    pred = np.argmax(cs, axis=1).astype(np.int32)
    return EngineResult(prediction=pred, class_sums=cs, aux=dict(res.aux))


class TMFleet:
    """Many named TM models behind one scheduler, device and cache budget.

    ``models`` maps name → spec; a spec is ``(cfg, state)`` or a dict with
    ``cfg``/``state`` plus any per-model ``TMServer`` keyword
    (``train_backend``, ``train_seed``, ``checkpoint_dir``,
    ``checkpoint_every_updates``, ``probe``, ...) and an optional
    ``weight``.  ``policy`` applies fleet-wide.  ``pack=True`` (default)
    groups models sharing :func:`pack_key` into fused serving planes;
    ``pack=False`` serves every model solo (same scheduler sharing, no
    cross-model batching: the control arm).  ``cache_entries`` /
    ``cache_bytes`` set the process-wide engine-cache budget (see
    :func:`repro_torch.engine.set_engine_cache_budget`); ``weights`` pins
    static eviction weights per model name, otherwise each model's
    measured request share is registered.  ``device`` (``None`` → cuda)
    is where every server runs; ``mesh=`` serves (and, for
    ``train_backend="sharded"`` members, trains) data-parallel over a
    1-D device mesh.

    Use as an async context manager like ``TMServer``.  The request API is
    :meth:`submit` / :meth:`submit_labeled` with the model name first; the
    lifecycle is :meth:`checkpoint` / :meth:`restore` / :meth:`rollback` /
    :meth:`add_model` / :meth:`drain`.
    """

    def __init__(self, models: dict, policy: ServePolicy | None = None, *,
                 pack: bool = True,
                 mesh=None,
                 device=None,
                 cache_entries: int | None = None,
                 cache_bytes: int | None = None,
                 weights: dict[str, float] | None = None,
                 latency_window: int = 4096):
        if not models:
            raise ValueError("TMFleet needs at least one model")
        self.policy = policy or ServePolicy()
        self.pack = bool(pack)
        # the fleet-wide data-parallel mesh, forwarded to every member
        # and pack group server
        self.mesh = sharding.resolve_mesh(mesh)
        self.device = resolve_device(device) if self.mesh is None else \
            sharding.mesh_device(self.mesh, device)
        self._mu = threading.Lock()
        self._models: dict[str, _Model] = {}
        self._groups: list[_PackGroup] = []
        self._started = False
        self._closed = False
        self._latency_window = int(latency_window)
        self._weights_cfg = dict(weights or {})
        if cache_entries is not None or cache_bytes is not None:
            set_engine_cache_budget(cache_entries, cache_bytes)
        # one device worker thread for every server in the fleet: the
        # single-device execution model the pipeline scoreboard assumes
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tm-fleet-infer")
        for name, spec in models.items():
            self._build_model(name, spec)
        if self.pack:
            self._form_groups()
        for entry in self._models.values():
            self._reweight(entry)

    # -- construction ------------------------------------------------

    def _build_model(self, name: str, spec) -> _Model:
        """Construct one member server and its fleet record from a spec."""
        if name in self._models:
            raise ValueError(f"duplicate model name {name!r}")
        if isinstance(spec, dict):
            kw = dict(spec)
            cfg, state = kw.pop("cfg"), kw.pop("state")
        else:
            cfg, state = spec
            kw = {}
        weight = kw.pop("weight", self._weights_cfg.get(name))
        if self.mesh is not None:
            kw.setdefault("mesh", self.mesh)
        if kw.get("mesh") is None:
            kw.setdefault("device", self.device)
        server = TMServer(
            cfg, state, self.policy, executor=self._pool,
            on_publish=lambda v, s, _n=name: self._member_published(_n, v, s),
            **kw)
        entry = _Model(name, cfg, server, weight_override=weight,
                       latency_window=self._latency_window)
        self._models[name] = entry
        return entry

    def _form_groups(self) -> None:
        """Group same-``pack_key`` models into fused serving planes."""
        by_key: dict[tuple, list[_Model]] = {}
        for entry in self._models.values():
            by_key.setdefault(pack_key(entry.cfg), []).append(entry)
        for key, members in by_key.items():
            if len(members) < 2:
                continue
            group = _PackGroup(key, members, self.policy, self._pool,
                               self.device, self.mesh)
            for m in members:
                m.group = group
            self._groups.append(group)

    # -- publish hook / weighted eviction ------------------------------

    def _member_published(self, name: str, version: int,
                          state: TMState) -> None:
        """Member publish hook: refresh the model's eviction weight and
        re-stack its pack group (inside the member's publish, so a packed
        predict submitted after an update's future resolves sees the
        post-update fused state)."""
        entry = self._models.get(name)
        if entry is None:        # constructor-time publish, not wired yet
            return
        self._reweight(entry)
        if entry.group is not None:
            entry.group.republish()

    def _weight(self, entry: _Model) -> float:
        """Eviction weight: the static override, else the model's measured
        request share (+1 smoothing, so an unqueried model is light but
        never weightless)."""
        if entry.weight_override is not None:
            return float(entry.weight_override)
        with self._mu:
            total = sum(m.requests for m in self._models.values())
            n = len(self._models)
            return (entry.requests + 1) / (total + max(n, 1))

    def _reweight(self, entry: _Model) -> None:
        """Register the model's weight on the state its served engines are
        built on (the fused group state for packed models, its own
        otherwise)."""
        if entry.group is not None:
            w = max(self._weight(m) for m in entry.group.members)
            weight_engines_for_state(entry.group.server.state, w)
        else:
            weight_engines_for_state(entry.server.state,
                                     self._weight(entry))

    # -- lifecycle ----------------------------------------------------

    async def start(self) -> "TMFleet":
        """Start every member and group server (once only)."""
        if self._started:
            raise RuntimeError("fleet already started")
        self._started = True
        for entry in self._models.values():
            await entry.server.start()
        for group in self._groups:
            await group.server.start()
        return self

    async def stop(self) -> None:
        """Drain and stop every server, then the shared device worker."""
        if self._closed:
            return
        self._closed = True
        for group in self._groups:
            await group.server.stop()
        for entry in self._models.values():
            await entry.server.stop()
        self._pool.shutdown(wait=True)

    async def __aenter__(self) -> "TMFleet":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def warmup(self, *,
                     train_batches: tuple[int, ...] = ()) -> None:
        """Build every serving (engine, bucket) pair — group planes and
        solo models — and run each learning member's update step at the
        given labeled-batch row counts, before taking traffic."""
        for group in self._groups:
            await group.server.warmup()
        for entry in self._models.values():
            learns = entry.server._train_engine is not None
            if entry.group is None:
                await entry.server.warmup(
                    train_batches=train_batches if learns else ())
            elif train_batches and learns:
                await entry.server.warmup(train_batches=train_batches)

    # -- request path -------------------------------------------------

    def _entry(self, model: str) -> _Model:
        entry = self._models.get(model)
        if entry is None:
            raise KeyError(f"unknown model {model!r}; serving: "
                           f"{sorted(self._models)}")
        return entry

    def _record(self, entry: _Model, dt: float) -> None:
        with self._mu:
            entry.requests += 1
            entry.latencies.append(dt)
            n = entry.requests
        if n % _REWEIGHT_EVERY == 0:
            self._reweight(entry)

    async def submit(self, model: str, literals, *, client=None,
                     deadline_us: int | None = None,
                     priority: int = 0) -> EngineResult:
        """One predict for ``model`` → its own :class:`EngineResult`
        (numpy).

        The contract of :meth:`TMServer.submit` (deadlines, priority,
        backpressure, exactly once and in order per client).  A packed
        model's request rides the group's fused batches and is unpacked
        to the member's class segment; class sums and argmax equal a solo
        server's.
        """
        entry = self._entry(model)
        # capture the segment before awaiting: a concurrent drain may
        # shift sibling segments, but this request is pinned to the fused
        # state current at submit, which matches these columns
        lo, hi = entry.lo, entry.hi
        server = entry.group.server if entry.group is not None \
            else entry.server
        t0 = time.monotonic()
        try:
            res = await server.submit(literals, client=client,
                                      deadline_us=deadline_us,
                                      priority=priority)
        except DeadlineExceeded:
            with self._mu:
                entry.rejects += 1
            raise
        except Exception:
            with self._mu:
                entry.errors += 1
            raise
        if entry.group is not None:
            res = _unpack(res, lo, hi)
        self._record(entry, time.monotonic() - t0)
        return res

    async def submit_labeled(self, model: str, literals, labels) -> int:
        """One labeled feedback batch for ``model`` → the model's new
        state version.  Runs on the member's own training thread and key
        chain (equal to a solo replay); once the future resolves, the
        model's pack group serves the updated fused state.  A failing
        update is contained to this model."""
        entry = self._entry(model)
        try:
            return await entry.server.submit_labeled(literals, labels)
        except Exception:
            with self._mu:
                entry.errors += 1
            raise

    # -- per-model lifecycle delegation --------------------------------

    def checkpoint(self, model: str, directory: str | None = None, *,
                   block: bool = True) -> int:
        """Snapshot ``model``'s lifecycle (see :meth:`TMServer.checkpoint`)."""
        return self._entry(model).server.checkpoint(directory, block=block)

    def restore(self, model: str, directory: str | None = None, *,
                step: int | None = None, mesh=None, shardings=None) -> int:
        """Restore ``model`` from its checkpoint directory (before
        :meth:`start`); its pack group republishes the restored state.
        ``mesh=`` / ``shardings=`` retarget the member's data-parallel
        mesh at restore time (elastic re-shard, see
        :meth:`TMServer.restore`)."""
        return self._entry(model).server.restore(directory, step=step,
                                                 mesh=mesh,
                                                 shardings=shardings)

    def rollback(self, model: str, version: int) -> int:
        """Re-publish one model's historical version (see
        :meth:`TMServer.rollback`); siblings are untouched."""
        return self._entry(model).server.rollback(version)

    def model_names(self) -> list[str]:
        """Names currently served, sorted."""
        return sorted(self._models)

    def server_for(self, model: str) -> TMServer:
        """The model's lifecycle ``TMServer`` (its serving plane may be a
        pack group — see ``stats()["models"][model]["packed"]``)."""
        return self._entry(model).server

    async def add_model(self, name: str, spec) -> None:
        """Add a model to a running (or not yet started) fleet.

        An added model serves solo: pack groups form at construction
        (re-stacking a live group around a new member would re-segment
        siblings mid-traffic); restart the fleet to fold it into a group.
        It starts serving at once when the fleet is running.
        """
        entry = self._build_model(name, spec)
        self._reweight(entry)
        if self._started and not self._closed:
            await entry.server.start()

    async def drain(self, name: str) -> None:
        """Remove a model: stop routing new requests to it, drain its
        queued work, stop its server.

        A packed member's departure changes the fused class count, which
        its group server's ``TMConfig`` fixes, so the old group server is
        drained and stopped (in-flight sibling requests complete against
        the pinned state and segment they captured at submit) and the
        survivors are rebuilt: a fresh fused group for two or more, solo
        serving for one.  Quiesce the drained model's own traffic first —
        a request racing the drain may see ``KeyError`` or complete
        normally."""
        entry = self._models.pop(name, None)
        if entry is None:
            raise KeyError(f"unknown model {name!r}")
        group = entry.group
        if group is not None:
            survivors = [m for m in group.members if m is not entry]
            entry.group = None
            self._groups.remove(group)
            if len(survivors) >= 2:
                regrouped = _PackGroup(group.key, survivors, self.policy,
                                       self._pool, self.device, self.mesh)
                for m in survivors:
                    m.group = regrouped
                self._groups.append(regrouped)
                if self._started and not self._closed:
                    await regrouped.server.start()
            elif survivors:
                solo = survivors[0]
                solo.group = None
                solo.lo, solo.hi = 0, solo.cfg.n_classes
                self._reweight(solo)
            if self._started:
                await group.server.stop()
        if self._started:
            await entry.server.stop()

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        """Fleet-wide and per-model serving stats (the JAX key set).

        ``models`` maps each name to its summary: fleet-side request /
        error / reject counters and latency percentiles (measured at the
        fleet seam, unpacking included), ``packed`` and its ``group``
        index, ``segment``, the model's ``version`` / ``updates``, its
        current eviction ``weight`` and the member server's full
        ``stats()`` under ``server``.  ``groups`` lists each pack group's
        members, fused class count, shape and batching counters.
        ``engine_cache`` is the shared budgeted cache
        (:func:`repro_torch.engine.engine_cache_info`).
        """
        models = {}
        for name, e in sorted(self._models.items()):
            with self._mu:
                lats = list(e.latencies)
                snap = {"requests": e.requests, "errors": e.errors,
                        "rejects": e.rejects}
            p50, p99 = percentiles_ms(lats, (0.50, 0.99))
            sstats = e.server.stats()
            models[name] = {
                **snap,
                "p50_ms": p50, "p99_ms": p99,
                "packed": e.group is not None,
                "group": (self._groups.index(e.group)
                          if e.group is not None else None),
                "segment": [e.lo, e.hi],
                "version": sstats["state_version"],
                "updates": sstats["updates"],
                "errors_total": snap["errors"] + sstats["errors"],
                "weight": round(self._weight(e), 6),
                "state_nbytes": state_nbytes(e.server.state),
                "server": sstats,
            }
        groups = []
        for g in self._groups:
            gs = g.server.stats()
            groups.append({
                "members": [m.name for m in g.members],
                "fused_classes": g.server.cfg.n_classes,
                "shape": {"clauses": g.key[0], "features": g.key[1]},
                "version": gs["state_version"],
                "requests": gs["requests"],
                "batches": gs["batches"],
                "mean_batch_rows": gs["mean_batch_rows"],
            })
        return {
            "n_models": len(models),
            "n_groups": len(groups),
            "packed_models": sum(1 for m in models.values() if m["packed"]),
            "models": models,
            "groups": groups,
            "engine_cache": engine_cache_info(),
        }
