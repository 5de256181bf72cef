"""TM serving: async micro-batching scheduler over the VoteEngine registry
(port of ``repro.serve.tm_server``, predict plane).

Requests arrive one at a time — variable-size, asynchronous, bursty — and
throughput comes from decoupling arrival from evaluation:

- :class:`ServePolicy` — coalesce waiting requests until ``max_batch``
  rows are gathered or ``max_wait_us`` has elapsed since the batch opened;
  bounded backpressure at ``queue_depth``.
- bucketing — each coalesced batch pads (all-zero neutral rows) to the
  smallest configured bucket that fits.
- routing — each bucket maps to a backend name (:func:`route_buckets`):
  an explicit choice or the include-density heuristic.  Engines come from
  ``get_engine``, so buckets sharing a backend share one cached engine.

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
history ring (:meth:`rollback` targets).

**Deadline scheduling** — :meth:`submit` takes ``deadline_us`` /
``priority``: waiting requests are served by ``(priority, absolute
deadline, arrival seq)``, and admission control (``admission_control``,
default on) rejects with :class:`~repro_torch.serve.loadgen.
DeadlineExceeded` at submit (deadline below the bucket's fastest observed
service time) and reaps already-expired queue heads at dispatch.

A failing batch (bad routing entry, backend error) fails its own
requests' futures only; the scheduler outlives engine errors.

The server runs on ``device`` (``None`` → cuda, and it raises where no
GPU is visible); tensors carry their device, so the worker thread needs
no ``set_device`` and kernels launch on that device's current stream.

Not ported yet (see ROADMAP.md): online learning (``train_backend``,
``submit_labeled``), checkpoint/restore and rollback from disk, the drift
probe, ``mesh=``, the overload shed tier, the measured autotune routes
and the sparse layout half of the publish refresh.  Passing one of those
options raises ``NotImplementedError``.

>>> async with TMServer(cfg, state, ServePolicy(max_batch=64,
...                     backend="mxu_fused")) as srv:
...     result = await srv.submit(literals)       # (n, 2F) or (2F,)
...     result.prediction                         # (n,) int32 numpy
...     fast = await srv.submit(literals, deadline_us=5000, priority=0)
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

from repro_torch.core.tm import TMConfig, TMState, include_mask
from repro_torch.engine import (EngineResult, ServiceStats,
                                engine_cache_info, evict_engines_for_state,
                                get_engine, infer_padded)
from repro_torch.kernels.ops import resolve_device

from .loadgen import DeadlineExceeded, percentiles_ms

__all__ = ["ServePolicy", "TMServer", "DeadlineExceeded", "bucket_for",
           "default_buckets", "route_buckets"]

_STOP = object()        # queue sentinel: wakes the scheduler for shutdown
_NOT_PORTED = ("ROADMAP.md lists it among the TMServer options the port "
               "does not have yet")
_UNPORTED_OPTIONS = ("mesh", "train_backend", "train_seed",
                     "checkpoint_dir", "checkpoint_every_updates",
                     "checkpoint_keep", "probe", "probe_every_updates",
                     "probe_window")


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
    requests instead of serving a guaranteed miss.  ``shed_backend`` /
    ``shed_qdepth`` / ``shed_opts`` configure the overload tier, which the
    port does not have yet: a ``TMServer`` given a ``shed_backend``
    raises ``NotImplementedError``.
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


def route_buckets(cfg: TMConfig, state: TMState,
                  buckets: tuple[int, ...], *,
                  backend: str | None = None,
                  density: float | None = None) -> dict[int, str]:
    """bucket size → backend name.

    An explicit ``backend`` wins; otherwise the include-density heuristic
    (trained machines are ~5% include-dense → ``sparse_csr``, denser →
    ``swar_packed``).  ``sparse_csr`` is not ported yet, so a sparse state
    served without an explicit backend fails loudly at engine build
    rather than being re-routed (measured autotune routes are not ported
    either).
    """
    if backend is not None:
        return {b: backend for b in buckets}
    if density is None:
        density = float(include_mask(cfg, state).float().mean())
    fallback = "sparse_csr" if density <= 0.10 else "swar_packed"
    return {b: fallback for b in buckets}


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


class TMServer:
    """Async micro-batching front end over one (cfg, state) TM on a device.

    Use as an async context manager, or call :meth:`start` / :meth:`stop`.
    :meth:`submit` awaits queue space (backpressure), then the request's
    slice of a batched ``infer``.  One scheduler coroutine coalesces and
    assembles (stage A), one worker thread runs the engines (stage B) and
    a fan-out coroutine resolves futures (stage C).

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
                 history_size: int = 8,
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
        if self.policy.shed_backend is not None:
            raise NotImplementedError(f"ServePolicy.shed_backend (the "
                                      f"overload tier): {_NOT_PORTED}")
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
        self._on_publish = on_publish
        self._n_publish_hook_errors = 0
        self._n_rollbacks = 0
        self._publish(0, state)
        # -- queues + pipeline state ----------------------------------
        # the arrival queue is unbounded; the capacity semaphore is the
        # backpressure bound, released when the scheduler pops a request
        self._queue: asyncio.Queue = asyncio.Queue()
        self._capacity = asyncio.Semaphore(self.policy.queue_depth)
        self._sem = asyncio.Semaphore(self.policy.pipeline_depth)
        self._completions: asyncio.Queue = asyncio.Queue()
        self._pending: list[tuple] = []            # EDF heap of predicts
        self._get_task: asyncio.Task | None = None
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
        self._n_deadline_reqs = 0
        self._n_deadline_misses = 0
        self._n_admission_rejects = 0
        self._n_expired_drops = 0

    def _publish(self, version: int, state: TMState) -> None:
        """Swap in a ``(version, state)`` pair (the state moved to the
        server's device) atomically and remember it in the history ring;
        then re-resolve density routes and evict the superseded state's
        cached engines."""
        state = TMState(ta=torch.as_tensor(state.ta, device=self.device))
        with self._mu:
            prev = getattr(self, "_current", None)
            self._current = (version, state)
            self._history.append((version, state))
        if not self._routing_pinned:
            new_routes = route_buckets(self.cfg, state, self.buckets)
            if new_routes != self.routing:
                self.routing = new_routes
                with self._mu:
                    self._n_routing_updates += 1
        if prev is not None and prev[1].ta is not state.ta:
            evict_engines_for_state(prev[1])
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

    def rollback(self, version: int) -> int:
        """Re-publish a state from the history ring → the new (bumped)
        version.  Versions stay monotonic; in-flight predicts pinned to
        other versions are untouched.  Rollback from a checkpoint on disk
        is not ported yet (see ROADMAP.md)."""
        state = next((s for v, s in self._history if v == version), None)
        if state is None:
            raise KeyError(f"version {version} is not in the history ring "
                           f"{list(self.history_versions)}")
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
        """Version of the served state (0 at start, +1 per publish)."""
        return self._current[0]

    @property
    def history_versions(self) -> tuple[int, ...]:
        """Versions retained in the bounded history ring (oldest first)."""
        return tuple(v for v, _ in self._history)

    # -- planes that are not ported yet ---------------------------------

    async def submit_labeled(self, literals, labels) -> int:
        """Online learning is not ported yet (see ROADMAP.md)."""
        raise NotImplementedError(f"submit_labeled: {_NOT_PORTED}")

    def checkpoint(self, directory: str | None = None, **_) -> int:
        """Checkpointing is not ported yet (see ROADMAP.md)."""
        raise NotImplementedError(f"checkpoint: {_NOT_PORTED}")

    def restore(self, directory: str | None = None, **_) -> int:
        """Restoring from a checkpoint is not ported yet (see ROADMAP.md)."""
        raise NotImplementedError(f"restore: {_NOT_PORTED}")

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
        pipeline stages, then shut down the worker thread it owns."""
        if self._closed:
            return
        self._closed = True
        await self._queue.put(_STOP)
        if self._task is not None:
            await self._task
        if self._owns_pool:
            self._pool.shutdown(wait=True)

    async def __aenter__(self) -> "TMServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def engine_for(self, bucket: int, state: TMState | None = None):
        """The (cached) engine serving this bucket; ``state`` pins a state
        version (default: the newest)."""
        st = self.state if state is None else state
        backend = self.routing.get(bucket) or \
            self.routing.get(self.buckets[-1], "oracle")
        return get_engine(backend, self.cfg, st)

    async def warmup(self) -> None:
        """Build every bucket's engine, and on cuda its kernel library,
        on the worker thread before taking traffic."""
        loop = asyncio.get_running_loop()
        zeros = np.zeros((1, self.cfg.n_literals), np.int8)
        for bucket in self.buckets:
            eng = self.engine_for(bucket)
            await loop.run_in_executor(
                self._pool, lambda e=eng, b=bucket: infer_padded(e, zeros, b))

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

    # -- scheduler (stage A: coalesce + assemble) ---------------------

    def _ingest(self, item) -> None:
        """Sort one arrival into the EDF heap."""
        if item is _STOP:
            self._stop_seen = True
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

    async def _next_arrival(self, timeout) -> bool:
        """Block up to ``timeout`` for the next queue item (ingested on
        arrival; returns True).  The queue getter is a persistent task so
        a timeout never cancels a get that already claimed an item."""
        if self._get_task is None:
            self._get_task = asyncio.ensure_future(self._queue.get())
        done, _ = await asyncio.wait({self._get_task}, timeout=timeout)
        if self._get_task in done:
            item = self._get_task.result()
            self._get_task = None
            self._ingest(item)
            return True
        return False

    def _qdepth(self) -> int:
        """Waiting (undispatched) requests: arrival queue + EDF heap."""
        return self._queue.qsize() + len(self._pending)

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

    async def _scheduler(self) -> None:
        try:
            while True:
                self._drain_queue()
                self._reap_expired()
                if self._pending:
                    await self._coalesce_and_dispatch()
                    continue
                if self._stop_seen and self._queue.empty():
                    break
                await self._next_arrival(None)
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
            # abnormal exit only: on a graceful stop both are empty
            leftovers = [entry[-1] for entry in self._pending]
            self._pending.clear()
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
            if self._pending or self._stop_seen:
                # the head cannot join (version cut / row overflow), or a
                # stop wants the floor: close
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
        fut = asyncio.get_running_loop().run_in_executor(
            self._pool, self._compute, lits, bucket, batch[0].state)
        with self._mu:
            self._inflight += 1
            v = batch[0].version
            self._inflight_versions[v] = \
                self._inflight_versions.get(v, 0) + 1
        self._completions.put_nowait((batch, rows, bucket, fut))
        if self.policy.pipeline_depth == 1:
            # serial semantics: this batch retires before the next opens
            await self._completions.join()

    # -- stage B: device compute (worker thread) ----------------------

    def _compute(self, lits: np.ndarray, bucket: int,
                 state: TMState) -> EngineResult:
        """One padded engine call on the server's device, materialised to
        numpy (worker thread).  The wall time feeds the per-bucket
        service ring that admission control reads."""
        t0 = time.perf_counter()
        res = infer_padded(self.engine_for(bucket, state), lits, bucket)
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
            batch, rows, bucket, fut = item
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
                    self._fan_out(batch, rows, bucket, res)
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
                 res: EngineResult) -> None:
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
        with self._mu:
            self._latencies.extend(lats)
            self._n_requests += len(batch)
            self._n_rows += rows
            self._n_batches += 1
            self._n_padded_rows += bucket
            self._n_deadline_reqs += n_dead
            self._n_deadline_misses += n_miss

    # -- observability ------------------------------------------------

    def stats(self) -> dict:
        """Serving counters in one consistent snapshot, with the JAX
        package's key set; blocks for planes the port does not have yet
        (learning, checkpoint, probe, mesh, sparse layout, shed tier)
        read ``None`` or zero.  ``device`` names where the engines run.

        ``batch_fill`` is real rows ÷ padded rows; p50/p90/p99 come from
        a sliding window of per-request latencies (ms).  ``pipeline``
        shows batches in flight (per state version); ``deadline`` the SLO
        policy's counters; ``buckets`` the per-bucket service-time ring
        that admission control decides on.
        """
        with self._mu:
            lats = list(self._latencies)
            snap = {
                "requests": self._n_requests,
                "rows": self._n_rows,
                "batches": self._n_batches,
                "padded": self._n_padded_rows,
                "errors": self._n_errors,
                "version": self._current[0],
                "history": list(v for v, _ in self._history),
                "inflight": self._inflight,
                "inflight_versions": dict(self._inflight_versions),
                "deadline_reqs": self._n_deadline_reqs,
                "deadline_misses": self._n_deadline_misses,
                "admission_rejects": self._n_admission_rejects,
                "expired_drops": self._n_expired_drops,
                "routing_updates": self._n_routing_updates,
                "publish_hook_errors": self._n_publish_hook_errors,
            }
        p50_ms, p90_ms, p99_ms = percentiles_ms(lats, (0.50, 0.90, 0.99))
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
            "updates": 0,
            "update_rows": 0,
            "history": {"versions": snap["history"],
                        "capacity": self._history.maxlen},
            "rollbacks": self._n_rollbacks,
            "checkpoint": None,
            "probe": None,
            "routing": {str(k): v for k, v in sorted(self.routing.items())},
            "routing_updates": snap["routing_updates"],
            "mesh": None,
            "sparse_layout": None,
            "device": str(self.device),
            "pipeline": {
                "depth": self.policy.pipeline_depth,
                "inflight": snap["inflight"],
                "inflight_versions": {str(k): v for k, v in
                                      sorted(snap["inflight_versions"]
                                             .items())},
                "update_inflight": False,
            },
            "deadline": {
                "requests": snap["deadline_reqs"],
                "misses": snap["deadline_misses"],
                "miss_rate": round(snap["deadline_misses"]
                                   / max(snap["deadline_reqs"], 1), 6),
                "admission_rejects": snap["admission_rejects"],
                "expired_drops": snap["expired_drops"],
                "slack_shed_batches": 0,
            },
            "buckets": {str(k): v
                        for k, v in sorted(self._svc.snapshot().items())},
            "tiers": {
                "shed_backend": None,
                "shed_qdepth": self.policy.shed_qdepth,
                "shed_batches": 0,
                "shed_rows": 0,
                "cascade_rows": 0,
                "escalated_rows": 0,
                "escalation_rate": 0.0,
            },
            "engine_cache": engine_cache_info(),
        }
