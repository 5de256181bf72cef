"""TM serving: async micro-batching scheduler over the VoteEngine registry
(port of ``repro.serve.tm_server``: the predict, learning and lifecycle
planes and the overload shed tier).

Requests arrive one at a time — variable-size, asynchronous, bursty — and
throughput comes from decoupling arrival from evaluation:

- :class:`ServePolicy` — coalesce waiting requests until ``max_batch``
  rows are gathered or ``max_wait_us`` has elapsed since the batch opened;
  bounded backpressure at ``queue_depth``.
- bucketing — each coalesced batch pads (all-zero neutral rows) to the
  smallest configured bucket that fits.
- routing — each bucket maps to a backend name (:func:`route_buckets`):
  an explicit choice, a measured route from the autotune cache, or the
  include-density heuristic (``sparse_csr`` for trained, sparse states).
  Engines come from ``get_engine``, so buckets
  sharing a backend share one cached engine; the newest state's
  ``sparse_csr`` engine is prebuilt at publish from an incrementally
  refreshed layout (:meth:`TMServer._refresh_serving`).

**Pipelined dispatch** (``pipeline_depth``, default 2):

- *Stage A (host, event loop)*: coalesce the next batch and assemble its
  padded numpy buffer, one reusable buffer per pipeline slot.
- *Stage B (device)*: the engine call runs on a single worker thread, up
  to ``pipeline_depth`` batches in flight.  It copies the batch to the
  server's device, launches there, and ends in the ``.cpu()`` copy of the
  result (:func:`~repro_torch.engine.infer_padded`) — the batch's one
  device synchronisation, which also retires the host-to-device copy
  before the slot's buffer can be reused.
- *Stage C (fan-out)*: a coroutine consumes a FIFO completion queue and
  resolves per-request futures.  The worker thread is serial, so
  completion order is dispatch order: exactly once, in order per client.

Every request is pinned to the ``(version, state)`` pair current at
arrival; :meth:`publish` swaps in a new pair and keeps it in a bounded
history ring (:meth:`rollback` targets), re-resolves density routes,
refreshes the sparse serving layout and evicts the superseded state's
cached engines.

**Deadline scheduling** — :meth:`submit` takes ``deadline_us`` /
``priority``: waiting requests are served by ``(priority, absolute
deadline, arrival seq)``, and admission control (``admission_control``,
default on) rejects with :class:`~repro_torch.serve.loadgen.
DeadlineExceeded` at submit (deadline below the bucket's fastest observed
service time) and reaps already-expired queue heads at dispatch.

**Overload shedding** (opt-in via ``shed_backend=``) — a batch dispatched
while the backlog holds at least ``shed_qdepth`` waiting items, or whose
tightest deadline is inside the bucket's EWMA service time, routes to the
shed tier's engine instead of the bucket's routed backend.  The intended
tier is the exact early-exit ``cascade``
(:mod:`repro_torch.engine.cascade`, built with ``exact_sums=False``):
predictions stay bit-exact while wide-margin rows skip most clause work.
``stats()["tiers"]`` counts shed batches and rows and, whenever a cascade
served a batch (shed or routed), its escalated rows.

A failing batch (bad routing entry, backend error) fails its own
requests' futures only; the scheduler outlives engine errors.

**Online learning** (opt-in via ``train_backend=``) — :meth:`submit_labeled`
enqueues labeled batches.  Each runs a :mod:`repro_torch.engine.train`
``TrainEngine`` step on a dedicated training thread (overlapping predict
compute) and publishes the new ``(version, state)`` pair as one tuple
swap, so a predict never sees a half-applied update; updates serialise
among themselves.  ``train_seed`` seeds the update-key chain exactly as
the JAX package does (update ``i`` uses ``split(chain)[1]``, the chain
advancing to ``split(chain)[0]`` only when the step succeeds), so for the
same seed and batches the published states equal the JAX server's bit for
bit.  ``probe=(literals, labels)`` with ``probe_every_updates`` scores a
held-out stream every N applied updates (``stats()["probe"]``).

**State lifecycle** (``checkpoint_dir=``) — :meth:`checkpoint` snapshots
``(version, TMState, update-key-chain cursor, train backend + opts)``
through :mod:`repro_torch.checkpoint` in the JAX package's on-disk format
(atomic, ``.complete``-marked), so a snapshot moves between the two
packages either way; ``checkpoint_every_updates=`` takes them
periodically (``save_async`` on a writer thread, ``checkpoint_keep``
newest retained), ``stop()`` takes a final one and joins the writers,
and :meth:`restore` resumes a killed server bit-exactly.
:meth:`rollback` re-publishes a state from the history ring or, failing
that, from the checkpoint directory.

The server runs on ``device`` (``None`` → cuda, and it raises where no
GPU is visible); tensors carry their device, so the worker thread needs
no ``set_device`` and kernels launch on that device's current stream.

Not ported yet (see ROADMAP.md): ``mesh=`` (and ``restore``'s ``mesh=`` /
``shardings=``), which raise ``NotImplementedError``.

>>> async with TMServer(cfg, state, ServePolicy(max_batch=64,
...                     backend="mxu_fused")) as srv:
...     result = await srv.submit(literals)       # (n, 2F) or (2F,)
...     result.prediction                         # (n,) int32 numpy
...     fast = await srv.submit(literals, deadline_us=5000, priority=0)
>>> async with TMServer(cfg, state, train_backend="fused",
...                     train_seed=0) as srv:
...     version = await srv.submit_labeled(literals, labels)
>>> srv = TMServer(cfg, state, train_backend="fused",
...                checkpoint_dir="ckpt", checkpoint_every_updates=50)
>>> srv.restore()                                 # newest valid snapshot
"""

from __future__ import annotations

import asyncio
import dataclasses
import heapq
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import prng
from repro_torch.core.tm import TMConfig, TMState, include_mask
from repro_torch.engine import autotune
from repro_torch.engine import (EngineResult, ServiceStats,
                                available_backends, engine_cache_info,
                                evict_engines_for_state, export_key_cursor,
                                get_engine, get_train_engine,
                                import_key_cursor, infer_padded,
                                train_engine_opts)
from repro_torch.engine.sparse import IncrementalEll
from repro_torch.kernels.ops import resolve_device

from .loadgen import DeadlineExceeded, percentiles_ms

__all__ = ["ServePolicy", "TMServer", "DeadlineExceeded", "bucket_for",
           "default_buckets", "route_buckets"]

_STOP = object()        # queue sentinel: wakes the scheduler for shutdown
_NOT_PORTED = ("ROADMAP.md lists it among the TMServer options the port "
               "does not have yet")
_UNPORTED_OPTIONS = ("mesh",)


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to (and always including) ``max_batch``."""
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest configured bucket holding ``n`` rows; oversized batches
    round up to a multiple of the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Micro-batching knobs (the JAX package's fields, unchanged).

    ``max_batch``: row budget per coalesced batch — a request that would
    overflow it opens the next batch (requests are never split).
    ``max_wait_us``: how long an open batch may wait for more arrivals.
    ``buckets``: padded shapes (``None`` → powers of two up to
    ``max_batch``).  ``queue_depth``: bound on waiting requests (``submit``
    awaits instead of growing the backlog).  ``backend``: pin every bucket
    to one backend; ``None`` routes by the density heuristic.
    ``pipeline_depth``: dispatched batches in flight at once (``1`` is the
    serial scheduler).  ``admission_control``: reject provably late
    requests instead of serving a guaranteed miss.

    ``shed_backend``: the overload tier's backend (``None`` turns shedding
    off).  A batch dispatched while the backlog holds at least
    ``shed_qdepth`` waiting items — or whose tightest deadline is inside
    the bucket's EWMA service time — routes there; ``shed_qdepth=0``
    sheds every batch.  ``shed_opts`` go to the tier engine's
    constructor; a ``cascade`` tier defaults to ``exact_sums=False``.
    """

    max_batch: int = 64
    max_wait_us: int = 2000
    buckets: tuple[int, ...] | None = None
    queue_depth: int = 1024
    backend: str | None = None
    shed_backend: str | None = None
    shed_qdepth: int = 0
    shed_opts: dict | None = None
    pipeline_depth: int = 2
    admission_control: bool = True

    def __post_init__(self):
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}")

    def resolved_buckets(self) -> tuple[int, ...]:
        """The sorted, deduplicated bucket shapes this policy pads to."""
        if self.buckets is not None:
            return tuple(sorted(set(self.buckets)))
        return default_buckets(self.max_batch)

    def resolved_shed_opts(self) -> dict:
        """Constructor opts for the shed tier engine: ``shed_opts``, and
        for a ``cascade`` tier ``exact_sums=False`` unless given (the
        tier skips the remainder pass; predictions stay exact)."""
        opts = dict(self.shed_opts or {})
        if self.shed_backend == "cascade":
            opts.setdefault("exact_sums", False)
        return opts


def route_buckets(cfg: TMConfig, state: TMState,
                  buckets: tuple[int, ...], *,
                  backend: str | None = None,
                  density: float | None = None) -> dict[int, str]:
    """bucket size → backend name.

    Priority per bucket: an explicit ``backend`` > a measured route in
    the autotune cache for the state's device kind
    (:func:`~repro_torch.engine.autotune.serve_lookup`) > the
    include-density heuristic (trained machines are ~5% include-dense →
    ``sparse_csr``, denser → ``swar_packed``).  A measured route naming a
    backend that is not registered (a stale cache) falls back to the
    heuristic.  ``density`` short-circuits the include-mask reduction
    when the caller knows it; it is a float64 mean, as numpy's in the JAX
    server, so a state right at the 0.10 boundary routes the same way in
    both.
    """
    if backend is not None:
        return {b: backend for b in buckets}
    registered = set(available_backends())
    if density is None:
        density = float(include_mask(cfg, state).to(torch.float64).mean())
    fallback = "sparse_csr" if density <= 0.10 else "swar_packed"
    routes = {}
    for b in buckets:
        measured = autotune.serve_lookup(cfg, b, state.ta.device)
        routes[b] = measured if measured in registered else fallback
    return routes


class _Request:
    """A queued predict, pinned to the state version current at arrival.

    ``deadline`` is the absolute monotonic completion target (``None``
    for best-effort); the EDF heap orders by ``(priority, deadline,
    seq)``, so deadline-free traffic is FIFO.
    """

    __slots__ = ("lits", "n", "future", "t_in", "client", "version",
                 "state", "deadline", "priority", "seq")

    def __init__(self, lits, future, client, version, state, *,
                 deadline=None, priority=0, seq=0):
        self.lits = lits
        self.n = lits.shape[0]
        self.future = future
        self.t_in = time.monotonic()
        self.client = client
        self.version = version
        self.state = state
        self.deadline = deadline
        self.priority = priority
        self.seq = seq

    def sort_key(self):
        return (self.priority,
                self.deadline if self.deadline is not None else float("inf"),
                self.seq)


class _Update:
    """A queued labeled feedback batch (online-learning mode)."""

    __slots__ = ("lits", "labels", "future", "t_in")

    def __init__(self, lits, labels, future):
        self.lits = lits
        self.labels = labels
        self.future = future
        self.t_in = time.monotonic()


class TMServer:
    """Async micro-batching front end over one (cfg, state) TM on a device.

    Use as an async context manager, or call :meth:`start` / :meth:`stop`.
    :meth:`submit` awaits queue space (backpressure), then the request's
    slice of a batched ``infer``.  One scheduler coroutine coalesces and
    assembles (stage A), one worker thread runs the engines (stage B) and
    a fan-out coroutine resolves futures (stage C).

    ``train_backend`` opts into online learning through the named
    :mod:`repro_torch.engine.train` backend on a training thread of its
    own; ``train_seed`` seeds the update-key chain (see the module
    docstring).  ``probe=(literals, labels)`` with ``probe_every_updates >
    0`` scores the held-out probe stream every N applied updates, keeping
    the last ``probe_window`` scores.

    Lifecycle knobs: ``checkpoint_dir`` names where :meth:`checkpoint` /
    :meth:`restore` persist snapshots; ``checkpoint_every_updates > 0``
    snapshots asynchronously every that many versions
    (``checkpoint_keep`` newest retained on disk).

    ``device``: where the state lives and the engines run (``None`` →
    cuda; raises where no GPU is visible — pass ``device="cpu"`` for the
    CPU).  ``history_size`` bounds the ring of recent ``(version,
    state)`` pairs; ``on_publish(version, state)`` is called after every
    publish (its errors are counted, never propagated); ``executor``
    shares one worker thread across servers.
    """

    def __init__(self, cfg: TMConfig, state: TMState,
                 policy: ServePolicy | None = None, *,
                 routing: dict[int, str] | None = None,
                 device=None,
                 train_backend: str | None = None, train_seed: int = 0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every_updates: int = 0,
                 checkpoint_keep: int = 3,
                 history_size: int = 8,
                 probe: tuple | None = None,
                 probe_every_updates: int = 0,
                 probe_window: int = 256,
                 latency_window: int = 4096,
                 on_publish=None,
                 executor: ThreadPoolExecutor | None = None,
                 **unported):
        if unported:
            unknown = sorted(set(unported) - set(_UNPORTED_OPTIONS))
            if unknown:
                raise TypeError(f"TMServer got unexpected keyword "
                                f"arguments {unknown}")
            raise NotImplementedError(
                f"TMServer option(s) {sorted(unported)}: {_NOT_PORTED}")
        self.policy = policy or ServePolicy()
        if (self.policy.shed_backend is not None
                and self.policy.shed_backend not in available_backends()):
            raise ValueError(
                f"unknown shed_backend {self.policy.shed_backend!r}; "
                f"available: {available_backends()}")
        self.cfg = cfg
        self.device = resolve_device(device)
        # one lock for every counter stats() reads, so a snapshot is
        # internally consistent
        self._mu = threading.Lock()
        self._history: deque[tuple[int, TMState]] = deque(
            maxlen=max(1, int(history_size)))
        self.buckets = self.policy.resolved_buckets()
        # an explicit routing= table or policy.backend pins routes; density
        # routes re-resolve on every publish
        self._routing_pinned = (routing is not None
                                or self.policy.backend is not None)
        self.routing = dict(routing) if routing is not None else \
            route_buckets(cfg, state, self.buckets,
                          backend=self.policy.backend)
        self._n_routing_updates = 0
        # publish-path sparse serving maintenance: an IncrementalEll mirror
        # of the served state's include mask plus a one-slot (state,
        # engine) pair prebuilt for the newest state (a layout holds
        # tensors, so it cannot key the engine cache); swapped as one
        # tuple so lock-free readers see a matched pair
        self._serve_ell: IncrementalEll | None = None
        self._sparse_serving: tuple[TMState, object] | None = None
        self._on_publish = on_publish
        self._n_publish_hook_errors = 0
        self._n_rollbacks = 0
        self._publish(0, state)
        self._train_engine = None
        self._train_key = None
        self._train_backend = train_backend
        self._train_pool: ThreadPoolExecutor | None = None
        if train_backend is not None:
            self._train_engine = get_train_engine(train_backend, cfg)
            # the chain lives on the CPU: its splits and the step's small
            # draws are a few hundred tiny ops, cheaper there than as
            # kernel launches
            self._train_key = prng.key(train_seed)
            # updates get their own thread: a training step overlaps
            # predict compute (stage B) instead of serialising behind it
            self._train_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tm-serve-train")
        # -- lifecycle: checkpointing, rollback, drift probe ----------
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = int(checkpoint_every_updates)
        self._ckpt_keep = int(checkpoint_keep)
        if self._ckpt_every and checkpoint_dir is None:
            raise ValueError("checkpoint_every_updates needs checkpoint_dir=")
        self._ckpt_threads: list[threading.Thread] = []   # live writers
        self._last_ckpt_version: int | None = None
        self._restored_from: int | None = None
        self._probe = None
        if probe is not None:
            lits, labels = probe
            lits = self._check_literals(lits)
            y = np.asarray(labels, dtype=np.int32).reshape(-1)
            if y.shape[0] != lits.shape[0]:
                raise ValueError(f"probe labels {y.shape} do not match "
                                 f"{lits.shape[0]} literal rows")
            self._probe = (lits, y)
        self._probe_every = int(probe_every_updates)
        if self._probe_every and self._probe is None:
            raise ValueError("probe_every_updates needs probe=(lits, labels)")
        self._probe_history: deque[tuple[int, float]] = deque(
            maxlen=probe_window)
        self._probe_best: float | None = None
        self._n_probe_evals = 0
        # -- queues + pipeline state ----------------------------------
        # the arrival queue is unbounded; the capacity semaphores are the
        # backpressure bounds, one per plane (a predict flood must not
        # park labeled updates behind it), released when the scheduler
        # pops the item
        self._queue: asyncio.Queue = asyncio.Queue()
        self._capacity = asyncio.Semaphore(self.policy.queue_depth)
        self._update_capacity = asyncio.Semaphore(self.policy.queue_depth)
        self._sem = asyncio.Semaphore(self.policy.pipeline_depth)
        self._completions: asyncio.Queue = asyncio.Queue()
        self._pending: list[tuple] = []            # EDF heap of predicts
        self._pending_updates: deque[_Update] = deque()
        self._get_task: asyncio.Task | None = None
        self._update_task: asyncio.Task | None = None
        self._fanout_task: asyncio.Task | None = None
        self._seq = 0
        self._next_slot = 0
        self._asm_buffers: list[np.ndarray | None] = \
            [None] * self.policy.pipeline_depth
        self._inflight = 0
        self._inflight_versions: dict[int, int] = {}
        self._svc = ServiceStats()        # per-bucket service-time ring
        self._owns_pool = executor is None
        self._pool = executor if executor is not None else \
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="tm-serve-infer")
        self._task: asyncio.Task | None = None
        self._closed = False
        self._stop_seen = False
        # stats (mutated under self._mu; snapshotted by stats())
        self._latencies: deque[float] = deque(maxlen=latency_window)
        self._n_requests = 0
        self._n_rows = 0
        self._n_batches = 0
        self._n_padded_rows = 0
        self._n_errors = 0
        self._n_updates = 0
        self._n_update_rows = 0
        self._n_deadline_reqs = 0
        self._n_deadline_misses = 0
        self._n_admission_rejects = 0
        self._n_expired_drops = 0
        self._n_slack_shed_batches = 0
        # tier counters: shed decisions are per batch; escalation splits
        # per row, from any engine whose aux carries an "escalated" mask
        # (the cascade, shed or routed)
        self._n_shed_batches = 0
        self._n_shed_rows = 0
        self._n_cascade_rows = 0
        self._n_escalated_rows = 0

    def _publish(self, version: int, state: TMState) -> None:
        """Swap in a ``(version, state)`` pair (the state moved to the
        server's device) atomically and remember it in the history ring;
        then re-resolve serving against it (:meth:`_refresh_serving`)."""
        state = TMState(ta=torch.as_tensor(state.ta, device=self.device))
        with self._mu:
            prev = getattr(self, "_current", None)
            self._current = (version, state)
            self._history.append((version, state))
        self._refresh_serving(
            state, superseded=prev[1] if prev is not None else None)
        if self._on_publish is not None:
            try:
                self._on_publish(version, state)
            except Exception:
                # a broken observer must not poison the publish path
                with self._mu:
                    self._n_publish_hook_errors += 1

    def publish(self, state: TMState) -> int:
        """Swap in ``state`` as a new version (bumped by one) → version.
        Call from the event-loop thread only."""
        version = self._current[0] + 1
        self._publish(version, state)
        return version

    def _refresh_serving(self, state: TMState, *,
                         superseded: TMState | None = None) -> None:
        """Publish-path serving maintenance, on the event-loop thread
        after each ``(version, state)`` swap:

        1. re-resolve density-heuristic routes against the new state's
           include density (unless routing is pinned by an explicit table
           or ``policy.backend``), so a model drifting across the 0.10
           boundary flips between ``swar_packed`` and ``sparse_csr``;
        2. refresh the :class:`IncrementalEll` mirror by include deltas
           and prebuild the newest state's ``sparse_csr`` engine from it:
           O(changed rows) per publish, not a from-scratch build;
        3. evict the superseded state's engines from the keyed cache
           (in-flight predicts pinned to it rebuild on a miss).
        """
        cfg = self.cfg
        if self._routing_pinned and "sparse_csr" not in self.routing.values():
            inc = None      # pinned dense routes: no include mask to read
        else:
            inc = (state.ta > cfg.n_states).reshape(
                cfg.n_classes * cfg.n_clauses, cfg.n_literals).cpu().numpy()
        if not self._routing_pinned:
            new_routes = route_buckets(cfg, state, self.buckets,
                                       density=float(inc.mean()))
            if new_routes != self.routing:
                self.routing = new_routes
                with self._mu:
                    self._n_routing_updates += 1
        if "sparse_csr" in self.routing.values():
            if self._serve_ell is None:
                self._serve_ell = IncrementalEll(inc, device=self.device)
            else:
                self._serve_ell.refresh(inc)
            engine = get_engine("sparse_csr", cfg, state, cache=False,
                                ell=self._serve_ell.layout)
            self._sparse_serving = (state, engine)
        else:
            self._sparse_serving = None
        if superseded is not None and superseded.ta is not state.ta:
            evict_engines_for_state(superseded)

    def rollback(self, version: int) -> int:
        """Re-publish a historical state → the new (bumped) version.

        Looks the target up in the history ring first, then — when a
        checkpoint directory is configured — on disk at ``step ==
        version``.  Versions stay monotonic; in-flight predicts pinned to
        other versions are untouched.  Rollback restores the state only:
        the update-key chain keeps advancing from its cursor.  Call from
        the event-loop thread."""
        state = next((s for v, s in self._history if v == version), None)
        if state is None and self._ckpt_dir is not None \
                and version in ckpt.valid_steps(self._ckpt_dir):
            _, tree, _ = ckpt.restore_tm_lifecycle(self._ckpt_dir, version)
            state = TMState(ta=torch.from_numpy(tree["ta"]))
        if state is None:
            raise KeyError(
                f"version {version} is in neither the history ring "
                f"{list(self.history_versions)} nor the checkpoint dir")
        new_version = self._current[0] + 1
        self._publish(new_version, state)
        self._n_rollbacks += 1
        return new_version

    @property
    def state(self) -> TMState:
        """The currently served ``TMState``."""
        return self._current[1]

    @property
    def state_version(self) -> int:
        """Version of the served state (0 at start, +1 per applied update,
        publish or rollback)."""
        return self._current[0]

    @property
    def history_versions(self) -> tuple[int, ...]:
        """Versions retained in the bounded history ring (oldest first)."""
        return tuple(v for v, _ in self._history)

    # -- state lifecycle: checkpoint / restore -----------------------

    def _directory(self, directory: str | None) -> str:
        directory = self._ckpt_dir if directory is None else directory
        if directory is None:
            raise ValueError("no checkpoint directory: pass directory= or "
                             "construct TMServer with checkpoint_dir=")
        return directory

    def checkpoint(self, directory: str | None = None, *,
                   block: bool = True) -> int:
        """Snapshot the serving lifecycle → the step number written.

        Persists ``(version, TMState, update-key-chain cursor, train
        backend + opts)`` at ``step == state_version`` in the JAX
        package's format and ``extra`` schema (``version``,
        ``has_cursor``, ``cfg``, ``train_backend``, ``train_opts``,
        ``updates``, ``rollbacks``, ``mesh_devices``, ``key_impl``), so
        the JAX ``TMServer.restore`` resumes it too.  ``block=False``
        copies the state to the host here and serializes on a writer
        thread (``save_async``); either way ``gc_keep`` retention follows.
        Call from the event-loop thread, or on a stopped server.
        """
        directory = self._directory(directory)
        version, state = self._current
        cursor = None
        extra = {"version": version, "has_cursor": False,
                 "cfg": dataclasses.asdict(self.cfg),
                 "train_backend": self._train_backend,
                 "train_opts": {}, "updates": self._n_updates,
                 "rollbacks": self._n_rollbacks,
                 "mesh_devices": None}
        if self._train_key is not None:
            data, impl = export_key_cursor(self._train_key)
            cursor, extra["has_cursor"], extra["key_impl"] = data, True, impl
            extra["train_opts"] = train_engine_opts(self._train_engine)
        tree = ckpt.tm_lifecycle_tree(state.ta, cursor)
        if block:
            ckpt.save(directory, version, tree, extra=extra)
        else:
            self._ckpt_threads = [t for t in self._ckpt_threads
                                  if t.is_alive()]
            self._ckpt_threads.append(
                ckpt.save_async(directory, version, tree, extra=extra))
        ckpt.gc_keep(directory, self._ckpt_keep)
        self._last_ckpt_version = version
        return version

    def restore(self, directory: str | None = None, *,
                step: int | None = None, mesh=None,
                shardings=None) -> int:
        """Resume from a checkpoint (this package's or the JAX package's)
        → the restored state version.

        Loads the newest valid step (or ``step=``), checks the saved
        ``TMConfig`` against this server's, publishes the snapshot's
        ``(version, state)`` on the server's device and adopts its
        update-key-chain cursor and train backend with its saved opts, so
        a killed and restarted server replays bit-exactly against the
        uninterrupted run.  The history ring restarts at the restored
        pair.  Must run before :meth:`start`.  ``mesh=`` / ``shardings=``
        (the elastic multi-device restore) are not ported yet.
        """
        if mesh is not None or shardings is not None:
            raise NotImplementedError(
                f"restore(mesh=, shardings=): {_NOT_PORTED}")
        if self._task is not None and not self._closed:
            raise RuntimeError("restore() must run before start()")
        directory = self._directory(directory)
        step, tree, extra = ckpt.restore_tm_lifecycle(directory, step)
        saved_cfg = extra.get("cfg")
        if saved_cfg and saved_cfg != dataclasses.asdict(self.cfg):
            raise ValueError(f"checkpoint step_{step} was written for "
                             f"cfg {saved_cfg}, not {self.cfg}")
        version = int(extra.get("version", step))
        self._history.clear()
        self._publish(version, TMState(ta=torch.from_numpy(tree["ta"])))
        if extra.get("has_cursor"):
            backend = extra.get("train_backend")
            if backend:
                # the checkpoint's backend and opts win: restore means
                # resume *that* run
                self._train_engine = get_train_engine(
                    backend, self.cfg, **dict(extra.get("train_opts", {})))
                self._train_backend = backend
                if self._train_pool is None:
                    self._train_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="tm-serve-train")
            self._train_key = import_key_cursor(tree["cursor"],
                                                extra["key_impl"])
        self._restored_from = step
        self._last_ckpt_version = version
        return version

    # -- lifecycle ----------------------------------------------------

    async def start(self) -> "TMServer":
        """Launch the fan-out + scheduler coroutines (once only)."""
        if self._task is not None:
            raise RuntimeError("server already started")
        loop = asyncio.get_running_loop()
        self._fanout_task = loop.create_task(
            self._fanout_loop(), name="tm-serve-fanout")
        self._task = loop.create_task(
            self._scheduler(), name="tm-serve-scheduler")
        return self

    async def stop(self) -> None:
        """Graceful shutdown: drain queued requests and in-flight
        pipeline stages, shut down the worker threads it owns, take a
        final checkpoint when a checkpoint directory is set and the state
        moved past the last snapshot, then join the checkpoint writers so
        no snapshot is torn by process exit."""
        if self._closed:
            return
        self._closed = True
        await self._queue.put(_STOP)
        if self._task is not None:
            await self._task
        if self._owns_pool:
            self._pool.shutdown(wait=True)
        if self._train_pool is not None:
            self._train_pool.shutdown(wait=True)
        if (self._ckpt_dir is not None
                and self._current[0] != self._last_ckpt_version):
            self.checkpoint()
        for t in self._ckpt_threads:
            t.join()
        self._ckpt_threads.clear()

    async def __aenter__(self) -> "TMServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def engine_for(self, bucket: int, state: TMState | None = None):
        """The (cached) engine serving this bucket; ``state`` pins a state
        version (default: the newest).  ``sparse_csr`` for the newest
        state is the one-slot engine the publish path prebuilt from the
        incrementally refreshed layout."""
        st = self.state if state is None else state
        backend = self.routing.get(bucket) or \
            self.routing.get(self.buckets[-1], "oracle")
        if backend == "sparse_csr":
            # one read of the (state, engine) pair: publishes swap the
            # whole tuple, so a racing reader sees a matched pair or misses
            # the identity check and builds its own
            pair = self._sparse_serving
            if pair is not None and pair[0] is st:
                return pair[1]
        return get_engine(backend, self.cfg, st)

    def shed_engine_for(self, bucket: int, state: TMState | None = None):
        """The (cached) overload-tier engine (``policy.shed_backend``) on
        ``state`` (default: the newest); ``bucket`` is kept for symmetry
        with :meth:`engine_for`."""
        if self.policy.shed_backend is None:
            raise RuntimeError("no shed tier configured (shed_backend=)")
        return get_engine(self.policy.shed_backend, self.cfg,
                          self.state if state is None else state,
                          **self.policy.resolved_shed_opts())

    async def warmup(self, *, train_batches: tuple[int, ...] = ()) -> None:
        """Build every bucket's engine (the probe's bucket too), and on
        cuda its kernel library, on the worker thread before taking
        traffic.  ``train_batches`` also runs one train step per listed
        labeled-batch row count on the training thread; its result is
        discarded and the served state and key chain are untouched."""
        loop = asyncio.get_running_loop()
        zeros = np.zeros((1, self.cfg.n_literals), np.int8)
        buckets = list(self.buckets)
        if self._probe is not None:
            probe_bucket = bucket_for(self._probe[0].shape[0], self.buckets)
            if probe_bucket not in buckets:
                buckets.append(probe_bucket)
        for bucket in buckets:
            engines = [self.engine_for(bucket)]
            if self.policy.shed_backend is not None:
                # the overload tier must be warm before the overload
                engines.append(self.shed_engine_for(bucket))
            for eng in engines:
                await loop.run_in_executor(
                    self._pool,
                    lambda e=eng, b=bucket: infer_padded(e, zeros, b))
        for n in train_batches:
            if self._train_engine is None:
                raise RuntimeError("train_batches warmup needs online "
                                   "learning (train_backend=)")
            lits = np.zeros((n, self.cfg.n_literals), np.int8)
            labels = np.zeros((n,), np.int32)
            await loop.run_in_executor(
                self._train_pool,
                lambda l=lits, y=labels: self._sync(self._train_engine.step(
                    self._current[1], prng.key(0), l, y)))

    @staticmethod
    def _sync(state: TMState) -> TMState:
        """Wait for ``state``'s device work (the counterpart of JAX's
        ``block_until_ready``): a CUDA stream sync, a no-op on the CPU."""
        if state.ta.device.type == "cuda":
            torch.cuda.current_stream(state.ta.device).synchronize()
        return state

    # -- request path -------------------------------------------------

    async def submit(self, literals, *, client=None,
                     deadline_us: int | None = None,
                     priority: int = 0) -> EngineResult:
        """One request: ``(n, 2F)`` or ``(2F,)`` {0,1} literals → the
        request's own :class:`EngineResult` (numpy, ``n`` rows).

        ``deadline_us`` is the completion SLO from now: tighter slack is
        served first within a ``priority`` tier (lower first), and
        admission control may reject with :class:`DeadlineExceeded` when
        the deadline is provably unmeetable.  Awaits queue space when
        ``queue_depth`` requests are already waiting.
        """
        if self._closed:
            raise RuntimeError("TMServer is stopped")
        lits = self._check_literals(literals)
        if deadline_us is not None:
            deadline_us = int(deadline_us)
            if deadline_us <= 0:
                raise ValueError(f"deadline_us must be > 0, "
                                 f"got {deadline_us}")
            if self.policy.admission_control:
                floor = self._svc.floor(
                    bucket_for(lits.shape[0], self.buckets))
                if floor is not None and floor > deadline_us * 1e-6:
                    with self._mu:
                        self._n_admission_rejects += 1
                    raise DeadlineExceeded(
                        f"deadline {deadline_us}us is below the fastest "
                        f"observed service time {floor * 1e6:.0f}us for "
                        f"this bucket — the request provably cannot "
                        f"meet it")
        future = asyncio.get_running_loop().create_future()
        await self._capacity.acquire()
        # pin *after* backpressure resolves: the version current when the
        # request actually enters the scheduler's queue
        version, state = self._current
        self._seq += 1
        req = _Request(
            lits, future, client, version, state,
            deadline=(time.monotonic() + deadline_us * 1e-6
                      if deadline_us is not None else None),
            priority=int(priority), seq=self._seq)
        self._queue.put_nowait(req)
        return await future

    def _check_literals(self, literals) -> np.ndarray:
        """Validate/promote request literals to ``(n, 2F)`` int8 numpy."""
        if isinstance(literals, torch.Tensor):
            literals = literals.cpu().numpy()
        lits = np.asarray(literals, dtype=np.int8)
        if lits.ndim == 1:
            lits = lits[None, :]
        if lits.ndim != 2 or lits.shape[1] != self.cfg.n_literals:
            raise ValueError(
                f"expected (n, {self.cfg.n_literals}) literals, "
                f"got {np.shape(literals)}")
        return lits

    async def submit_labeled(self, literals, labels) -> int:
        """One labeled feedback batch: ``(n, 2F)`` literals + ``(n,)``
        labels → the state version that includes this update, once it is
        live.

        Requires online-learning mode (``train_backend=``).  Updates apply
        in FIFO order among themselves behind their own admission gate
        (``queue_depth`` deep); predicts already queued keep the version
        they arrived under.
        """
        if self._closed:
            raise RuntimeError("TMServer is stopped")
        if self._train_engine is None:
            raise RuntimeError(
                "online learning is off: construct TMServer with "
                "train_backend=<TrainEngine name> to enable submit_labeled")
        lits = self._check_literals(literals)
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu().numpy()
        y = np.asarray(labels, dtype=np.int32).reshape(-1)
        if y.shape[0] != lits.shape[0]:
            raise ValueError(f"labels {y.shape} do not match "
                             f"{lits.shape[0]} literal rows")
        if y.size and (y.min() < 0 or y.max() >= self.cfg.n_classes):
            raise ValueError(f"labels out of range [0, {self.cfg.n_classes})")
        future = asyncio.get_running_loop().create_future()
        await self._update_capacity.acquire()
        self._queue.put_nowait(_Update(lits, y, future))
        return await future

    # -- scheduler (stage A: coalesce + assemble) ---------------------

    def _ingest(self, item) -> None:
        """Sort one arrival into the EDF heap / update FIFO."""
        if item is _STOP:
            self._stop_seen = True
        elif isinstance(item, _Update):
            self._pending_updates.append(item)
        else:
            heapq.heappush(self._pending, (*item.sort_key(), item))

    def _drain_queue(self) -> None:
        """Move every already-arrived item into the EDF heap."""
        t = self._get_task
        if t is not None and t.done():
            self._get_task = None
            self._ingest(t.result())
        while True:
            try:
                self._ingest(self._queue.get_nowait())
            except asyncio.QueueEmpty:
                break

    async def _next_arrival(self, timeout, extra: asyncio.Task | None = None
                            ) -> bool:
        """Block up to ``timeout`` for the next queue item (ingested on
        arrival; returns True) — or until ``extra`` (the in-flight update
        task) finishes.  The queue getter is a persistent task so a
        timeout never cancels a get that already claimed an item."""
        if self._get_task is None:
            self._get_task = asyncio.ensure_future(self._queue.get())
        waits = {self._get_task}
        if extra is not None:
            waits.add(extra)
        done, _ = await asyncio.wait(waits, timeout=timeout,
                                     return_when=asyncio.FIRST_COMPLETED)
        if self._get_task in done:
            item = self._get_task.result()
            self._get_task = None
            self._ingest(item)
            return True
        return False

    def _qdepth(self) -> int:
        """Waiting (undispatched) items: arrival queue + EDF heap + update
        FIFO."""
        return (self._queue.qsize() + len(self._pending)
                + len(self._pending_updates))

    def _reap_expired(self) -> None:
        """Fail already-dead queue heads without compute (the dispatch
        half of admission control): EDF order means a live head proves
        the rest of its tier is live."""
        if not self.policy.admission_control:
            return
        now = time.monotonic()
        while self._pending:
            req = self._pending[0][-1]
            if req.deadline is None or req.deadline > now:
                return
            heapq.heappop(self._pending)
            self._capacity.release()
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"deadline passed {(now - req.deadline) * 1e6:.0f}us "
                    f"ago while queued — dropped at dispatch"))
            with self._mu:
                self._n_expired_drops += 1

    def _pop_head(self, version: int | None = None,
                  max_rows: int | None = None) -> _Request | None:
        """Pop the EDF head if it can join the open batch (matching state
        version, fits the row budget); popping releases one unit of
        backpressure capacity.  A head that cannot join closes the batch."""
        if not self._pending:
            return None
        req = self._pending[0][-1]
        if version is not None and req.version != version:
            return None
        if max_rows is not None and req.n > max_rows:
            return None
        heapq.heappop(self._pending)
        self._capacity.release()
        return req

    async def _service_updates(self) -> None:
        """Dispatch the next pending update when the barrier allows:
        updates serialise among themselves (one in flight); at
        ``pipeline_depth=1`` an update also waits for in-flight predicts
        first, the serial interleaving."""
        if self._update_task is not None and self._update_task.done():
            await self._update_task   # surfaces scheduler bugs, not
            self._update_task = None  # engine errors (_run_update catches)
        if self._update_task is None and self._pending_updates:
            upd = self._pending_updates.popleft()
            self._update_capacity.release()
            if self.policy.pipeline_depth == 1:
                await self._completions.join()
                await self._run_update(upd)
            else:
                self._update_task = asyncio.get_running_loop().create_task(
                    self._run_update(upd), name="tm-serve-update")

    async def _scheduler(self) -> None:
        try:
            while True:
                # drain before servicing updates: an update that arrived
                # ahead of this pass must dispatch now
                self._drain_queue()
                self._reap_expired()
                await self._service_updates()
                if self._pending:
                    await self._coalesce_and_dispatch()
                    continue
                update_running = (self._update_task is not None
                                  and not self._update_task.done())
                if (self._stop_seen and self._queue.empty()
                        and not self._pending_updates
                        and not update_running):
                    break
                if self._pending_updates and not update_running:
                    # at pipeline_depth=1 the pass above applied one update
                    # inline; the next one queued behind it goes now, not
                    # after an arrival that may never come
                    continue
                # idle: wake on the next arrival, or on the in-flight
                # update finishing (its successor may be waiting)
                await self._next_arrival(
                    None, extra=self._update_task if update_running
                    else None)
        finally:
            t, self._get_task = self._get_task, None
            if t is not None:
                t.cancel()
                try:
                    item = await t
                except (asyncio.CancelledError, Exception):
                    pass
                else:
                    self._ingest(item)   # cancel raced a claimed item
            if self._update_task is not None:
                try:
                    await self._update_task
                except Exception:
                    pass
                self._update_task = None
            # abnormal exit only: on a graceful stop all are empty
            leftovers = [entry[-1] for entry in self._pending]
            self._pending.clear()
            leftovers.extend(self._pending_updates)
            self._pending_updates.clear()
            while not self._queue.empty():
                item = self._queue.get_nowait()
                if item is not _STOP:
                    leftovers.append(item)
            for item in leftovers:
                if not item.future.done():
                    item.future.set_exception(
                        RuntimeError("TMServer scheduler exited"))
            # drain the pipeline, then retire the fan-out coroutine
            await self._completions.join()
            self._completions.put_nowait(_STOP)
            if self._fanout_task is not None:
                await self._fanout_task
                self._fanout_task = None

    async def _coalesce_and_dispatch(self) -> None:
        """Open a batch at the EDF head and coalesce until full, closed, or
        out of wait budget — then hand it to stage B."""
        policy = self.policy
        first = self._pop_head()
        batch, rows = [first], first.n
        deadline = time.monotonic() + policy.max_wait_us * 1e-6
        while rows < policy.max_batch:
            self._drain_queue()
            nxt = self._pop_head(version=first.version,
                                 max_rows=policy.max_batch - rows)
            if nxt is not None:
                batch.append(nxt)
                rows += nxt.n
                continue
            if self._pending or self._pending_updates or self._stop_seen:
                # the head cannot join (version cut / row overflow), or an
                # update or a stop wants the floor: close
                break
            timeout = deadline - time.monotonic()
            if timeout <= 0 or not await self._next_arrival(timeout):
                break
        await self._dispatch_batch(batch, rows)

    def _assemble(self, batch: list[_Request], rows: int, bucket: int,
                  slot: int) -> np.ndarray:
        """Stage A assembly into the slot's reusable buffer.

        Slot ``k`` is idle when reused: re-acquiring the pipeline
        semaphore ``depth`` dispatches later implies the dispatch that
        last wrote it completed compute — whose ``.cpu()`` result copy
        came after the host-to-device copy of this buffer — and fan-out.
        An exact-fit single request skips the copy."""
        if len(batch) == 1 and batch[0].n == bucket:
            return batch[0].lits
        buf = self._asm_buffers[slot]
        if buf is None or buf.shape[0] < bucket:
            buf = np.zeros((bucket, self.cfg.n_literals), np.int8)
            self._asm_buffers[slot] = buf
        off = 0
        for req in batch:
            buf[off:off + req.n] = req.lits
            off += req.n
        buf[off:bucket] = 0          # neutral padding rows
        return buf[:bucket]

    async def _dispatch_batch(self, batch: list[_Request], rows: int
                              ) -> None:
        """Assemble (stage A) and launch compute (stage B), bounded at
        ``pipeline_depth`` in flight; completion metadata goes to the
        FIFO that stage C fans out from."""
        await self._sem.acquire()
        slot = self._next_slot
        self._next_slot = (slot + 1) % self.policy.pipeline_depth
        bucket = bucket_for(rows, self.buckets)
        lits = self._assemble(batch, rows, bucket, slot)
        # shed decision at dispatch: backlog depth (arrivals outpace
        # compute) or slack exhaustion (the batch's tightest deadline is
        # inside the bucket's expected service time)
        slack_shed = False
        if self.policy.shed_backend is not None:
            deadlines = [r.deadline for r in batch if r.deadline is not None]
            if deadlines:
                ewma = self._svc.ewma(bucket)
                slack_shed = (ewma is not None and
                              min(deadlines) - time.monotonic() < ewma)
        shed = (self.policy.shed_backend is not None
                and (self._qdepth() >= self.policy.shed_qdepth
                     or slack_shed))
        fut = asyncio.get_running_loop().run_in_executor(
            self._pool, self._compute, lits, bucket, batch[0].state, shed)
        with self._mu:
            self._inflight += 1
            v = batch[0].version
            self._inflight_versions[v] = \
                self._inflight_versions.get(v, 0) + 1
            if shed and slack_shed:
                self._n_slack_shed_batches += 1
        self._completions.put_nowait((batch, rows, bucket, shed, fut))
        if self.policy.pipeline_depth == 1:
            # serial semantics: this batch retires before the next opens
            await self._completions.join()

    # -- stage B: device compute (worker thread) ----------------------

    def _compute(self, lits: np.ndarray, bucket: int, state: TMState,
                 shed: bool) -> EngineResult:
        """One padded engine call on the server's device (the shed tier's
        engine when ``shed``), materialised to numpy (worker thread).
        The wall time feeds the per-bucket service ring that admission
        control and slack shedding read."""
        t0 = time.perf_counter()
        engine = (self.shed_engine_for(bucket, state) if shed
                  else self.engine_for(bucket, state))
        res = infer_padded(engine, lits, bucket)
        self._svc.observe(bucket, time.perf_counter() - t0)
        return res

    # -- stage C: fan-out ---------------------------------------------

    async def _fanout_loop(self) -> None:
        """Resolve per-request futures in dispatch (FIFO) order."""
        while True:
            item = await self._completions.get()
            if item is _STOP:
                self._completions.task_done()
                return
            batch, rows, bucket, shed, fut = item
            try:
                try:
                    res = await fut
                except Exception as exc:
                    # a failing batch fails *its own* requests only
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(exc)
                    with self._mu:
                        self._n_errors += len(batch)
                else:
                    self._fan_out(batch, rows, bucket, shed, res)
            finally:
                with self._mu:
                    self._inflight -= 1
                    v = batch[0].version
                    left = self._inflight_versions.get(v, 1) - 1
                    if left > 0:
                        self._inflight_versions[v] = left
                    else:
                        self._inflight_versions.pop(v, None)
                self._sem.release()
                self._completions.task_done()

    def _fan_out(self, batch: list[_Request], rows: int, bucket: int,
                 shed: bool, res: EngineResult) -> None:
        """Slice one completed batch back per request and settle counters
        (one locked update)."""
        done = time.monotonic()
        lats = []
        n_dead = n_miss = 0
        offset = 0
        for req in batch:
            sl = slice(offset, offset + req.n)
            offset += req.n
            out = EngineResult(res.prediction[sl], res.class_sums[sl],
                               {k: v[sl] for k, v in res.aux.items()})
            if not req.future.done():
                req.future.set_result(out)
            lats.append(done - req.t_in)
            if req.deadline is not None:
                n_dead += 1
                if done > req.deadline:
                    n_miss += 1
        esc = res.aux.get("escalated")
        with self._mu:
            self._latencies.extend(lats)
            self._n_requests += len(batch)
            self._n_rows += rows
            self._n_batches += 1
            self._n_padded_rows += bucket
            self._n_deadline_reqs += n_dead
            self._n_deadline_misses += n_miss
            if shed:
                self._n_shed_batches += 1
                self._n_shed_rows += rows
            if esc is not None:         # a cascade served this batch
                # the mask is bucket-shaped: pad rows are not traffic
                self._n_cascade_rows += rows
                self._n_escalated_rows += int(esc[:rows].sum())

    # -- online learning ----------------------------------------------

    async def _run_update(self, upd: _Update) -> None:
        """Apply one labeled batch on the training thread, then publish
        the new ``(version, state)`` pair.  The key chain advances on the
        event loop only after the step succeeded: the offline-replay
        contract covers applied updates, so a failed step consumes no
        key."""
        def learn() -> tuple:
            chain, k = prng.split(self._train_key)
            new_state = self._train_engine.step(
                self._current[1], k, upd.lits, upd.labels)
            return chain, self._sync(new_state)

        try:
            chain, new_state = await asyncio.get_running_loop() \
                .run_in_executor(self._train_pool, learn)
        except Exception as exc:
            if not upd.future.done():
                upd.future.set_exception(exc)
            with self._mu:
                self._n_errors += 1
            return
        self._train_key = chain
        version = self._current[0] + 1
        self._publish(version, new_state)
        with self._mu:
            self._n_updates += 1
            self._n_update_rows += upd.lits.shape[0]
        if not upd.future.done():
            upd.future.set_result(version)
        if (self._ckpt_dir is not None and self._ckpt_every
                and version % self._ckpt_every == 0):
            # the host copy is taken here on the loop; serialization runs
            # on a writer thread
            self.checkpoint(block=False)
        if (self._probe is not None and self._probe_every
                and self._n_updates % self._probe_every == 0):
            try:
                acc = await asyncio.get_running_loop().run_in_executor(
                    self._train_pool, self._probe_eval, new_state)
            except Exception:
                with self._mu:
                    self._n_errors += 1
            else:
                self._probe_history.append((version, acc))
                self._n_probe_evals += 1
                if self._probe_best is None or acc > self._probe_best:
                    self._probe_best = acc

    def _probe_eval(self, state: TMState) -> float:
        """Accuracy of the held-out probe stream under ``state`` (training
        thread), through the padded-bucket engine path predicts take."""
        lits, labels = self._probe
        bucket = bucket_for(lits.shape[0], self.buckets)
        res = infer_padded(self.engine_for(bucket, state), lits, bucket)
        return float((res.prediction == labels).mean())

    # -- observability ------------------------------------------------

    def stats(self) -> dict:
        """Serving counters in one consistent snapshot, with the JAX
        package's key set; ``mesh``, which the port does not have yet,
        reads ``None``.  ``sparse_layout`` holds the serving
        ``IncrementalEll``'s refresh counters (``None`` until a
        ``sparse_csr`` route exists).  ``device`` names where the engines
        run.  ``checkpoint`` is ``None`` without a checkpoint directory,
        else the directory, the last step written, the writers still
        pending and the step restored from.  In online-learning
        mode ``state_version``/``updates``/``update_rows`` track the
        learning stream; ``probe`` is ``None`` without a probe, else the
        latest and best accuracy, ``drift`` = best − latest, ``delta`` =
        latest − previous, the window mean and the eval count.

        ``batch_fill`` is real rows ÷ padded rows; p50/p90/p99 come from
        a sliding window of per-request latencies (ms).  ``pipeline``
        shows batches in flight (per state version); ``deadline`` the SLO
        policy's counters; ``buckets`` the per-bucket service-time ring
        that admission control decides on.  ``tiers`` tracks the overload
        path: the shed backend and threshold, batches and rows shed, and
        — whenever a cascade served a batch (shed or routed) — its rows,
        the escalated ones and the ``escalation_rate``.
        """
        with self._mu:
            lats = list(self._latencies)
            snap = {
                "requests": self._n_requests,
                "rows": self._n_rows,
                "batches": self._n_batches,
                "padded": self._n_padded_rows,
                "errors": self._n_errors,
                "updates": self._n_updates,
                "update_rows": self._n_update_rows,
                "version": self._current[0],
                "history": list(v for v, _ in self._history),
                "inflight": self._inflight,
                "inflight_versions": dict(self._inflight_versions),
                "deadline_reqs": self._n_deadline_reqs,
                "deadline_misses": self._n_deadline_misses,
                "admission_rejects": self._n_admission_rejects,
                "expired_drops": self._n_expired_drops,
                "slack_shed": self._n_slack_shed_batches,
                "shed_batches": self._n_shed_batches,
                "shed_rows": self._n_shed_rows,
                "cascade_rows": self._n_cascade_rows,
                "escalated_rows": self._n_escalated_rows,
                "routing_updates": self._n_routing_updates,
                "publish_hook_errors": self._n_publish_hook_errors,
            }
        p50_ms, p90_ms, p99_ms = percentiles_ms(lats, (0.50, 0.90, 0.99))
        ckpt_stats = None
        if self._ckpt_dir is not None:
            ckpt_stats = {
                "dir": self._ckpt_dir,
                "last_step": self._last_ckpt_version,
                "pending": sum(t.is_alive() for t in self._ckpt_threads),
                "restored_from": self._restored_from,
            }
        probe_stats = None
        if self._probe is not None:
            probe_stats = {"evals": self._n_probe_evals, "accuracy": None,
                           "best": self._probe_best, "drift": 0.0,
                           "delta": 0.0, "window_mean": 0.0,
                           "at_version": None}
            if self._probe_history:
                accs = [a for _, a in self._probe_history]
                probe_stats.update(
                    accuracy=accs[-1],
                    drift=round(self._probe_best - accs[-1], 6),
                    delta=round(accs[-1] - accs[-2], 6)
                    if len(accs) > 1 else 0.0,
                    window_mean=round(float(np.mean(accs)), 6),
                    at_version=self._probe_history[-1][0])
        return {
            "requests": snap["requests"],
            "rows": snap["rows"],
            "batches": snap["batches"],
            "errors": snap["errors"],
            "publish_hook_errors": snap["publish_hook_errors"],
            "qdepth": self._qdepth(),
            "mean_batch_rows": snap["rows"] / max(snap["batches"], 1),
            "batch_fill": snap["rows"] / max(snap["padded"], 1),
            "p50_ms": p50_ms,
            "p90_ms": p90_ms,
            "p99_ms": p99_ms,
            "state_version": snap["version"],
            "updates": snap["updates"],
            "update_rows": snap["update_rows"],
            "history": {"versions": snap["history"],
                        "capacity": self._history.maxlen},
            "rollbacks": self._n_rollbacks,
            "checkpoint": ckpt_stats,
            "probe": probe_stats,
            "routing": {str(k): v for k, v in sorted(self.routing.items())},
            "routing_updates": snap["routing_updates"],
            "mesh": None,
            "sparse_layout": (None if self._serve_ell is None
                              else self._serve_ell.stats()),
            "device": str(self.device),
            "pipeline": {
                "depth": self.policy.pipeline_depth,
                "inflight": snap["inflight"],
                "inflight_versions": {str(k): v for k, v in
                                      sorted(snap["inflight_versions"]
                                             .items())},
                "update_inflight": (self._update_task is not None
                                    and not self._update_task.done()),
            },
            "deadline": {
                "requests": snap["deadline_reqs"],
                "misses": snap["deadline_misses"],
                "miss_rate": round(snap["deadline_misses"]
                                   / max(snap["deadline_reqs"], 1), 6),
                "admission_rejects": snap["admission_rejects"],
                "expired_drops": snap["expired_drops"],
                "slack_shed_batches": snap["slack_shed"],
            },
            "buckets": {str(k): v
                        for k, v in sorted(self._svc.snapshot().items())},
            "tiers": {
                "shed_backend": self.policy.shed_backend,
                "shed_qdepth": self.policy.shed_qdepth,
                "shed_batches": snap["shed_batches"],
                "shed_rows": snap["shed_rows"],
                "cascade_rows": snap["cascade_rows"],
                "escalated_rows": snap["escalated_rows"],
                "escalation_rate": round(
                    snap["escalated_rows"]
                    / max(snap["cascade_rows"], 1), 6),
            },
            "engine_cache": engine_cache_info(),
        }
