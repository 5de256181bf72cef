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

The cache runs under an entry budget (``ENGINE_CACHE_SIZE`` by default)
and an optional byte budget (:func:`set_engine_cache_budget`); past it the
entry of least (registered weight, LRU age) is evicted, so a fleet's hot
model keeps its engines under pressure from cold siblings
(:func:`weight_engines_for_state`).

Not ported yet (see ROADMAP.md): ``shard_batch`` and ``donate_literals``.
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
           "evict_engines_for_state", "weight_engines_for_state",
           "set_engine_cache_budget", "state_nbytes", "pad_batch",
           "infer_padded", "as_literals", "DEFAULT_BACKEND",
           "ENGINE_CACHE_SIZE"]

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
    """Thread-safe keyed LRU of built engines, weakref-pinned to state,
    under an entry and an optional byte budget with weighted eviction.

    Entries map a hashable key → (weakrefs to the key's state tensors,
    engine, bytes charged).  A weakref's death callback evicts the entry
    the moment any of its state tensors is garbage-collected, which keeps
    id-based state identity sound (an id is recycled only after its
    tensor died, and by then the entry is gone) and means the cache never
    retains dead states.  Past the budget the entry of least (weight, LRU
    age) goes first (:meth:`set_state_weight`).  Guarded by an RLock: gc
    can run an eviction callback on the thread that already holds the
    lock, and a serving process hits the cache from several threads at
    once.
    """

    def __init__(self, maxsize: int, max_bytes: int | None = None):
        self.maxsize = maxsize
        self.max_bytes = max_bytes
        self._data: OrderedDict[tuple, tuple] = OrderedDict()
        self._bytes = 0
        # id(tensor) -> (weakref, weight): the per-model weight registry
        # behind weighted eviction, keyed like entry pinning (tensor
        # identity), so a weight registered for a model's state covers
        # every engine built on that state
        self._weights: dict[int, tuple] = {}
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

    def set_state_weight(self, state, weight: float) -> None:
        """Register eviction ``weight`` for every tensor of ``state``.

        Entries pinned to a weighted tensor are evicted *after* lighter
        ones regardless of recency (weight first, LRU as tie-break), so a
        hot model's engines survive budget pressure from cold siblings.
        Unweighted entries weigh 1.0.  The registry holds weakrefs: a
        weight dies with its tensors and never pins them.
        """
        w = float(weight)
        for a in state:
            i = id(a)

            def _drop(_ref, _i=i):
                with self._lock:
                    self._weights.pop(_i, None)

            ref = weakref.ref(a, _drop)
            with self._lock:
                self._weights[i] = (ref, w)

    def _entry_weight_locked(self, refs) -> float:
        """Max registered weight over an entry's live pinned tensors."""
        w = None
        for r in refs:
            obj = r()
            if obj is None:
                continue
            reg = self._weights.get(id(obj))
            if reg is not None and (w is None or reg[1] > w):
                w = reg[1]
        return 1.0 if w is None else w

    def _evict_one_locked(self) -> None:
        """Evict the minimum-(weight, LRU-age) entry (capacity path)."""
        victim, vw = None, None
        for k, ent in self._data.items():    # oldest -> newest
            w = self._entry_weight_locked(ent[0])
            if vw is None or w < vw:         # strict <: ties keep oldest
                victim, vw = k, w
        if victim is not None:
            self._bytes -= self._data.pop(victim)[2]
            self._stats["evictions"] += 1

    def _over_budget_locked(self) -> bool:
        return len(self._data) > self.maxsize or \
            (self.max_bytes is not None and self._bytes > self.max_bytes)

    def set_budget(self, maxsize: int | None = None,
                   max_bytes: int | None = None) -> None:
        """Update the entry and/or byte budget and evict down to it
        (weighted, see :meth:`set_state_weight`).  ``None`` leaves a limit
        unchanged; ``max_bytes <= 0`` removes the byte limit."""
        with self._lock:
            if maxsize is not None:
                self.maxsize = int(maxsize)
            if max_bytes is not None:
                self.max_bytes = int(max_bytes) if max_bytes > 0 else None
            while self._data and self._over_budget_locked():
                self._evict_one_locked()

    def insert(self, key, state, engine, nbytes: int | None = None) -> None:
        """Cache ``engine`` under ``key``, pinned (weakly) to ``state``'s
        tensors.  ``nbytes`` (default: the summed ``nbytes`` of
        ``state``'s tensors, a proxy for the engine's layout) charges the
        byte budget; minimum-(weight, LRU-age) entries are evicted past
        ``maxsize`` / ``max_bytes``.  Replacing an existing key (the
        benign duplicate-build race in :func:`get_engine`) counts the
        displaced twin as an eviction, so ``misses == size + evictions +
        superseded`` holds."""
        def _evict(_ref, _key=key):
            with self._lock:
                ent = self._data.pop(_key, None)
                if ent is not None:
                    self._bytes -= ent[2]
                    self._stats["evictions"] += 1

        refs = tuple(weakref.ref(a, _evict) for a in state)
        if nbytes is None:
            nbytes = state_nbytes(state)
        with self._lock:
            self._stats["misses"] += 1
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old[2]
                self._stats["evictions"] += 1
            self._data[key] = (refs, engine, nbytes)
            self._bytes += nbytes
            while self._data and self._over_budget_locked():
                self._evict_one_locked()

    def evict_state(self, state) -> int:
        """Drop every entry pinned to any of ``state``'s tensors → count
        (the *superseded* path: a publish replaced the state, its layouts
        are stale for the logical model but the tensors stay alive in the
        history ring).  Counted under ``"superseded"``, apart from
        capacity and state-death ``"evictions"``."""
        targets = {id(a) for a in state}

        def _held(r):
            obj = r()
            return obj is not None and id(obj) in targets

        with self._lock:
            stale = [k for k, ent in self._data.items()
                     if any(_held(r) for r in ent[0])]
            for k in stale:
                self._bytes -= self._data.pop(k)[2]
            self._stats["superseded"] += len(stale)
            return len(stale)

    def clear(self) -> None:
        """Drop every cached engine and registered weight, and reset the
        counters (a deliberate clear is not an eviction)."""
        with self._lock:
            self._data.clear()
            self._weights.clear()
            self._bytes = 0
            for k in self._stats:
                self._stats[k] = 0

    def info(self) -> dict:
        """``{"size", "maxsize", "bytes", "max_bytes", "weights",
        "hits", "misses", "evictions", "superseded"}``."""
        with self._lock:
            return {"size": len(self._data), "maxsize": self.maxsize,
                    "bytes": self._bytes, "max_bytes": self.max_bytes,
                    "weights": len(self._weights), **self._stats}


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
    """``{"size", "maxsize", "bytes", "max_bytes", "weights", "hits",
    "misses", "evictions", "superseded"}`` of the engine cache (the
    ``engine_cache`` block of ``TMServer.stats()`` and
    ``TMFleet.stats()``)."""
    return _ENGINE_CACHE.info()


def evict_engines_for_state(state: TMState) -> int:
    """Evict every cached engine built on ``state`` → count evicted."""
    return _ENGINE_CACHE.evict_state(state)


def weight_engines_for_state(state: TMState, weight: float) -> None:
    """Register eviction ``weight`` for engines built on ``state``: the
    fleet's seam, so under a shared budget a hot model's engines outlive
    a cold model's whichever was touched last (see
    :meth:`KeyedEngineCache.set_state_weight`)."""
    _ENGINE_CACHE.set_state_weight(state, weight)


def set_engine_cache_budget(max_entries: int | None = None,
                            max_bytes: int | None = None) -> dict:
    """Set the process-wide engine-cache budget → fresh cache info.

    ``max_entries`` bounds the entry count (default
    ``ENGINE_CACHE_SIZE``); ``max_bytes`` bounds the summed state-tensor
    footprint of cached layouts (``<= 0`` removes the byte limit).
    ``None`` leaves a limit unchanged.  Shrinking evicts at once, the
    lightest first.
    """
    _ENGINE_CACHE.set_budget(max_entries, max_bytes)
    return _ENGINE_CACHE.info()


def state_nbytes(state) -> int:
    """Summed ``nbytes`` over a state's tensors: the byte proxy the
    engine cache charges per entry."""
    return sum(int(a.nbytes) for a in state)


def get_engine(name: str, cfg: TMConfig, state: TMState, *,
               cache: bool = True, **opts) -> VoteEngine:
    """Build (or fetch from the keyed LRU) the named backend's engine on
    ``state``'s device.  ``opts`` go to the backend constructor; a
    tunable backend's opts not given explicitly come from the autotune
    cache (:func:`repro_torch.engine.autotune.lookup`) where it has an
    entry for this shape and device kind.  ``cache=False`` bypasses the
    LRU."""
    from . import backends  # noqa: F401  (import side effect: registration)
    from . import autotune
    for opt, val in autotune.lookup(name, cfg, state.ta.device).items():
        opts.setdefault(opt, val)
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
