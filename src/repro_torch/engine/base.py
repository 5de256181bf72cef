"""VoteEngine: one backend-dispatched inference path for popcount + argmax
(port of ``repro.engine.base``).

- :class:`EngineResult` — what every backend returns: the prediction, the
  signed class sums and backend-specific per-sample extras (``aux``).
- :class:`VoteEngine` — the protocol: ``infer(literals) -> EngineResult``.
- a string-keyed registry (:func:`register_backend`, :func:`get_engine`,
  :func:`available_backends`) so backend choice is a config knob.

Engines are built once per ``(TMConfig, TMState)``: each backend
precomputes its clause layout (include masks, packed words, vote matrix)
on the state's device at construction, so ``infer`` does only the
literal-dependent work.  :func:`get_engine` keeps a keyed LRU of built
engines; state identity is by tensor object (``id``, shape, dtype and
device), entries hold only *weakrefs* to the state tensors and evict
themselves when a state is garbage-collected.

``aux`` entries are batch-leading, which lets :func:`infer_padded` strip
padding rows from any backend's result.  Padding seam: serving pads
variable-size requests to a few bucket shapes; every backend is
data-parallel over the batch axis, so all-zero pad rows cannot change any
real row's result and are sliced off.

Not ported yet (see ROADMAP.md): the autotune lookup (``get_engine`` uses
the constructor defaults or explicit opts), ``shard_batch``,
``donate_literals`` and the fleet's weighted cache budget.
"""

from __future__ import annotations

import math
import threading
import weakref
from collections import OrderedDict, deque
from typing import Callable, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.tm import TMConfig, TMState

__all__ = ["EngineResult", "VoteEngine", "Registry", "KeyedEngineCache",
           "ServiceStats", "nearest_rank", "register_backend", "get_engine",
           "available_backends", "clear_engine_cache", "engine_cache_info",
           "evict_engines_for_state", "state_nbytes", "pad_batch",
           "infer_padded", "as_literals", "DEFAULT_BACKEND"]

DEFAULT_BACKEND = "oracle"
ENGINE_CACHE_SIZE = 16


class EngineResult(NamedTuple):
    """What every inference backend returns (all batch-leading)."""

    prediction: torch.Tensor         # (B,) int32 — argmax class (ties → lowest)
    class_sums: torch.Tensor         # (B, C) int32 — signed vote counts
    aux: dict[str, torch.Tensor]     # backend extras; each batch-leading


@runtime_checkable
class VoteEngine(Protocol):
    """A built inference engine over one (cfg, state) clause layout."""

    name: str
    cfg: TMConfig

    def infer(self, literals) -> EngineResult:
        """(B, 2F) {0,1} literals → :class:`EngineResult`."""
        ...


class Registry:
    """String-keyed backend factory registry; ``kind`` names the engine
    family in error messages (e.g. ``"VoteEngine"``)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.factories: dict[str, Callable] = {}

    def register(self, name: str):
        """Class decorator: register a backend factory under ``name``."""
        def deco(factory):
            self.factories[name] = factory
            factory.name = name
            return factory
        return deco

    def names(self) -> list[str]:
        """Sorted names of all registered backends."""
        return sorted(self.factories)

    def build(self, name: str, *args, **opts):
        """Instantiate the named backend, ``KeyError`` on unknown names."""
        if name not in self.factories:
            raise KeyError(f"unknown {self.kind} backend {name!r}; "
                           f"available: {self.names()}")
        return self.factories[name](*args, **opts)


class KeyedEngineCache:
    """Thread-safe keyed LRU of built engines, weakref-pinned to state.

    Entries map a hashable key → (weakrefs to the key's state tensors,
    engine).  A weakref's death callback evicts the entry the moment any
    of its state tensors is garbage-collected, which keeps id-based state
    identity sound (an id is recycled only after its tensor died, and by
    then the entry is gone) and means the cache never retains dead
    states.  Guarded by an RLock: gc can run an eviction callback on the
    thread that already holds the lock, and a serving process hits the
    cache from several threads at once.
    """

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._data: OrderedDict[tuple, tuple] = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "superseded": 0}
        self._lock = threading.RLock()

    def get(self, key):
        """The cached engine for ``key`` (marking it most-recent), or None."""
        with self._lock:
            hit = self._data.get(key)
            if hit is None:
                return None
            self._data.move_to_end(key)
            self._stats["hits"] += 1
            return hit[1]

    def insert(self, key, state, engine) -> None:
        """Cache ``engine`` under ``key``, pinned (weakly) to ``state``'s
        tensors; evicts the least-recent entries past ``maxsize``.
        Replacing an existing key (the benign duplicate-build race in
        :func:`get_engine`) counts the displaced twin as an eviction, so
        ``misses == size + evictions + superseded`` holds."""
        def _evict(_ref, _key=key):
            with self._lock:
                if self._data.pop(_key, None) is not None:
                    self._stats["evictions"] += 1

        refs = tuple(weakref.ref(a, _evict) for a in state)
        with self._lock:
            self._stats["misses"] += 1
            if self._data.pop(key, None) is not None:
                self._stats["evictions"] += 1
            self._data[key] = (refs, engine)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self._stats["evictions"] += 1

    def evict_state(self, state) -> int:
        """Drop every entry pinned to any of ``state``'s tensors → count
        (the *superseded* path: a publish replaced the state, its layouts
        are stale for the logical model but the tensors stay alive in the
        history ring).  Counted under ``"superseded"``."""
        targets = {id(a) for a in state}
        with self._lock:
            stale = [k for k, ent in self._data.items()
                     if any((r() is not None and id(r()) in targets)
                            for r in ent[0])]
            for k in stale:
                del self._data[k]
            self._stats["superseded"] += len(stale)
            return len(stale)

    def clear(self) -> None:
        """Drop every cached engine and reset the counters."""
        with self._lock:
            self._data.clear()
            for k in self._stats:
                self._stats[k] = 0

    def info(self) -> dict:
        """``{"size", "maxsize", "hits", "misses", "evictions",
        "superseded"}``."""
        with self._lock:
            return {"size": len(self._data), "maxsize": self.maxsize,
                    **self._stats}


def nearest_rank(sorted_vals, p: float) -> float:
    """The nearest-rank percentile (``ceil(p·n)``-th order statistic) of an
    ascending-sorted non-empty sequence — the one percentile definition
    every latency reporter of the serving layer shares."""
    return sorted_vals[min(len(sorted_vals) - 1,
                           max(0, math.ceil(p * len(sorted_vals)) - 1))]


class ServiceStats:
    """Thread-safe per-key service-time tracker: EWMA + fixed-size ring.

    The serving worker thread :meth:`observe`\\ s each engine call's wall
    time; the event loop reads :meth:`ewma` / :meth:`floor` /
    :meth:`snapshot` for admission control and ``stats()``, so both sides
    see the same numbers.  Keys are hashables (the TM server keys by
    padded bucket size).
    """

    def __init__(self, alpha: float = 0.2, window: int = 512):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.window = window
        self._ewma: dict = {}
        self._rings: dict = {}
        self._counts: dict = {}
        self._lock = threading.Lock()

    def observe(self, key, seconds: float) -> None:
        """Record one service time (seconds) under ``key``."""
        with self._lock:
            prev = self._ewma.get(key)
            self._ewma[key] = seconds if prev is None else \
                self.alpha * seconds + (1.0 - self.alpha) * prev
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = deque(maxlen=self.window)
            ring.append(seconds)
            self._counts[key] = self._counts.get(key, 0) + 1

    def ewma(self, key) -> float | None:
        """Expected service time (seconds) for ``key``; None if unseen."""
        with self._lock:
            return self._ewma.get(key)

    def floor(self, key) -> float | None:
        """Fastest service time (seconds) in ``key``'s ring; None if
        unseen — a lower bound on how fast ``key`` can be served now."""
        with self._lock:
            ring = self._rings.get(key)
            return min(ring) if ring else None

    def snapshot(self) -> dict:
        """``{key: {count, ewma_ms, min_ms, p50_ms, p90_ms, p99_ms}}``,
        one consistent copy taken under the lock."""
        with self._lock:
            out = {}
            for key, ring in self._rings.items():
                lat = sorted(ring)
                out[key] = {
                    "count": self._counts[key],
                    "ewma_ms": round(self._ewma[key] * 1e3, 3),
                    "min_ms": round(lat[0] * 1e3, 3),
                    "p50_ms": round(nearest_rank(lat, 0.50) * 1e3, 3),
                    "p90_ms": round(nearest_rank(lat, 0.90) * 1e3, 3),
                    "p99_ms": round(nearest_rank(lat, 0.99) * 1e3, 3),
                }
            return out


_VOTE_REGISTRY = Registry("VoteEngine")
_ENGINE_CACHE = KeyedEngineCache(ENGINE_CACHE_SIZE)


def register_backend(name: str):
    """Class decorator: register a ``VoteEngine`` factory under ``name``."""
    return _VOTE_REGISTRY.register(name)


def available_backends() -> list[str]:
    """Sorted names of all registered backends."""
    from . import backends  # noqa: F401  (import side effect: registration)
    return _VOTE_REGISTRY.names()


def _cache_key(name, cfg, state, opts):
    """Hashable cache key, or ``None`` when opts aren't hashable.  State
    identity is (id, shape, dtype, device) of each tensor.  Tensor-valued
    opts (a ``PDLDevice``, a noise key) bypass the cache, as JAX arrays,
    which are unhashable, do in the JAX package: a tensor hashes by its
    id, which a new tensor may reuse once the old one is freed, and
    nothing pins an opt tensor the way the state's weakrefs pin it."""
    for v in opts.values():
        if isinstance(v, torch.Tensor) or (isinstance(v, tuple) and any(
                isinstance(x, torch.Tensor) for x in v)):
            return None
    try:
        opts_key = tuple(sorted(opts.items()))
        state_key = tuple((id(a), tuple(a.shape), str(a.dtype), str(a.device))
                          for a in state)
        key = (name, cfg, state_key, opts_key)
        hash(key)
    except TypeError:
        return None
    return key


def clear_engine_cache() -> None:
    """Drop every cached engine."""
    _ENGINE_CACHE.clear()


def engine_cache_info() -> dict:
    """``{"size", "maxsize", "hits", "misses", "evictions",
    "superseded"}`` of the engine cache."""
    return _ENGINE_CACHE.info()


def evict_engines_for_state(state: TMState) -> int:
    """Evict every cached engine built on ``state`` → count evicted."""
    return _ENGINE_CACHE.evict_state(state)


def state_nbytes(state) -> int:
    """Summed ``nbytes`` over a state's tensors."""
    return sum(int(a.nbytes) for a in state)


def get_engine(name: str, cfg: TMConfig, state: TMState, *,
               cache: bool = True, **opts) -> VoteEngine:
    """Build (or fetch from the keyed LRU) the named backend's engine on
    ``state``'s device.  ``opts`` go to the backend constructor;
    ``cache=False`` bypasses the LRU."""
    from . import backends  # noqa: F401  (import side effect: registration)
    key = _cache_key(name, cfg, state, opts) if cache else None
    if key is not None:
        hit = _ENGINE_CACHE.get(key)
        if hit is not None:
            return hit
    # build outside the lock: two threads missing on one key both build and
    # the second insert wins — benign, the engines are equivalent
    engine = _VOTE_REGISTRY.build(name, cfg, state, **opts)
    if key is not None:
        _ENGINE_CACHE.insert(key, state, engine)
    return engine


def as_literals(literals, device: torch.device) -> torch.Tensor:
    """Request literals (tensor or numpy, any int dtype) → contiguous int8
    tensor on ``device`` (a host array is copied to the device)."""
    t = literals if isinstance(literals, torch.Tensor) else \
        torch.as_tensor(np.asarray(literals))
    return t.to(device=device, dtype=torch.int8).contiguous()


def pad_batch(literals, bucket: int):
    """Pad a ``(B, L)`` literal batch with all-zero rows up to ``bucket``.

    Zero rows are neutral: every backend is data-parallel over the batch
    axis, so a pad row only produces its own (discarded) result.
    ``B == bucket`` returns the input; ``B > bucket`` is an error.  numpy
    pads in numpy (host-side assembly), a tensor on its device.
    """
    b = literals.shape[0]
    if b > bucket:
        raise ValueError(f"batch of {b} rows does not fit bucket {bucket}")
    if b == bucket:
        return literals
    if isinstance(literals, np.ndarray):
        pad = np.zeros((bucket - b,) + literals.shape[1:], literals.dtype)
        return np.concatenate([literals, pad], axis=0)
    pad = literals.new_zeros((bucket - b,) + tuple(literals.shape[1:]))
    return torch.cat([literals, pad], dim=0)


def infer_padded(engine: VoteEngine, literals, bucket: int) -> EngineResult:
    """``engine.infer`` at the bucket shape; results sliced to real rows.

    A numpy input is the host-side caller (the serving worker): the
    result comes back as numpy arrays.  Prediction and class sums (both
    int32) cross in one ``.cpu()`` copy of their concatenation — the
    call's one device synchronisation for every ported backend, none of
    which returns ``aux``.  A tensor input gets tensors on the engine's
    device.
    """
    b = literals.shape[0]
    res = engine.infer(pad_batch(literals, bucket))
    if isinstance(literals, np.ndarray):
        both = torch.cat([res.prediction[:b, None].to(res.class_sums.dtype),
                          res.class_sums[:b]], dim=1).cpu().numpy()
        return EngineResult(
            both[:, 0].astype(np.int32), both[:, 1:],
            {k: v[:b].cpu().numpy() for k, v in res.aux.items()})
    if b == bucket:
        return res
    return EngineResult(res.prediction[:b], res.class_sums[:b],
                        {k: v[:b] for k, v in res.aux.items()})
