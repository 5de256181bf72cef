"""TrainEngine: one backend-dispatched TM training path (port of
``repro.engine.train``).

- :class:`TrainEngine` — the protocol: ``step(state, key, literals,
  labels) -> TMState``.
- a string-keyed registry (:func:`register_train_backend`,
  :func:`get_train_engine`, :func:`available_train_backends`) on the same
  :class:`~repro_torch.engine.base.Registry` /
  :class:`~repro_torch.engine.base.KeyedEngineCache` machinery as
  inference, keyed by (backend, cfg, opts): train engines derive nothing
  from the state at build time.

Delta-exactness contract: every backend consumes the step key through
:func:`repro_torch.core.tm_train.feedback_masks` and computes bit-identical
clause outputs and class sums, so for a fixed threefry key all backends
return bitwise-identical states — and the same states as the JAX
package's backend of the same name.

======================  ====================================================
``reference``           :func:`repro_torch.core.tm_train.train_step` — the
                        dense formulation, the functional oracle.
``packed``              bit-packed literals + SWAR clause evaluation (the
                        ``swar_packed`` inference layout) feeding the
                        shared feedback math.
``fused``               class sums through kernel K1 (``swar_fused_votes``)
                        and the deltas through kernel K2
                        (``train_deltas_keyed``): clause eval of the
                        addressed classes, the threefry words, Type I/II
                        and the per-class scatter in one CUDA kernel, so
                        neither the per-sample deltas nor the uniform words
                        reach device memory.  On CPU tensors both wrappers
                        run their plain versions.
``sparse``              class sums from the ELL gather over the include
                        indices (:func:`~repro_torch.kernels.ell_gather.
                        ell_clause_votes`), then the ``fused`` tail through
                        kernel K2.  The index matrix is kept up to date by
                        an :class:`~repro_torch.engine.sparse.
                        IncrementalEll`.
======================  ====================================================

A step runs on the state's device; literals, labels and key may come as
numpy arrays or tensors on any device.  The key's small draws (offsets,
feedback uniforms, row keys) run where the key lies, so a CPU key keeps
some hundred tiny threefry ops off the card.

Not ported yet (see ROADMAP.md): ``sharded``.  ``block_b``/``block_m``
are the Pallas tiles; the port keeps them only so an engine's options
round-trip.  The autotune search space has no train entry (its only
train knobs would be those tiles), so ``get_train_engine`` consults no
autotune cache: it uses the constructor defaults or explicit opts.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.popcount import pack_bits
from repro_torch.core.tm import TMConfig, TMState, clause_polarity
from repro_torch.core.tm_train import (feedback_masks, feedback_update,
                                       train_step)
from repro_torch.kernels.clause_eval import make_vote_matrix
from repro_torch.kernels.ell_gather import ell_clause_votes
from repro_torch.kernels.swar_fused import swar_fused_votes
from repro_torch.kernels.train_fused import (DEFAULT_BLOCK_B,
                                             DEFAULT_BLOCK_M,
                                             feedback_polarity_masks,
                                             train_deltas_keyed)

from .backends import swar_clauses_votes
from .base import KeyedEngineCache, Registry, _cache_key
from .sparse import DEFAULT_K_SLACK, DEFAULT_REBUILD_THRESHOLD, IncrementalEll

__all__ = ["TrainEngine", "register_train_backend", "get_train_engine",
           "available_train_backends", "clear_train_engine_cache",
           "train_engine_cache_info", "DEFAULT_TRAIN_BACKEND",
           "ReferenceTrainEngine", "PackedTrainEngine", "FusedTrainEngine",
           "SparseTrainEngine",
           "export_key_cursor", "import_key_cursor", "train_engine_opts"]

DEFAULT_TRAIN_BACKEND = "reference"
TRAIN_ENGINE_CACHE_SIZE = 8


@runtime_checkable
class TrainEngine(Protocol):
    """A built training engine for one clause geometry (cfg, not state)."""

    name: str
    cfg: TMConfig

    def step(self, state: TMState, key, x_literals, y) -> TMState:
        """One batched update: (B, 2F) {0,1} literals + (B,) labels → the
        new ``TMState`` (states clipped to [1, 2N])."""
        ...


_TRAIN_REGISTRY = Registry("TrainEngine")
_TRAIN_CACHE = KeyedEngineCache(TRAIN_ENGINE_CACHE_SIZE)


def register_train_backend(name: str):
    """Class decorator: register a ``TrainEngine`` factory under ``name``."""
    return _TRAIN_REGISTRY.register(name)


def available_train_backends() -> list[str]:
    """Sorted names of all registered training backends."""
    return _TRAIN_REGISTRY.names()


def clear_train_engine_cache() -> None:
    """Drop every cached training engine."""
    _TRAIN_CACHE.clear()


def train_engine_cache_info() -> dict:
    """``{"size", "maxsize", "hits", "misses", ...}`` of the train-engine
    cache."""
    return _TRAIN_CACHE.info()


def get_train_engine(name: str, cfg: TMConfig, *, cache: bool = True,
                     **opts) -> TrainEngine:
    """Build (or fetch from the keyed LRU) the named training backend's
    engine; ``opts`` go to its constructor (e.g. ``boost_tpf=False``),
    ``cache=False`` builds afresh."""
    key = _cache_key(name, cfg, (), opts) if cache else None
    if key is not None:
        hit = _TRAIN_CACHE.get(key)
        if hit is not None:
            return hit
    engine = _TRAIN_REGISTRY.build(name, cfg, **opts)
    if key is not None:
        _TRAIN_CACHE.insert(key, (), engine)
    return engine


def export_key_cursor(key: torch.Tensor) -> tuple:
    """An update-key-chain cursor → ``(data, impl)``: the raw ``uint32``
    key data and the PRNG implementation name — the JAX package's format,
    so a cursor crosses between the two packages either way."""
    return prng.key_data(key), prng.IMPL


def import_key_cursor(data, impl: str) -> torch.Tensor:
    """Rebuild a key from :func:`export_key_cursor` output (also a JAX
    cursor).  Only ``threefry2x32`` is supported; ``rbg`` raises."""
    return prng.wrap_key_data(np.asarray(data), impl=impl)


def train_engine_opts(engine: TrainEngine) -> dict:
    """The constructor opts a built engine was resolved with (its
    ``lifecycle_opts``; ``{}`` for engines without one)."""
    fn = getattr(engine, "lifecycle_opts", None)
    return dict(fn()) if fn is not None else {}


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.array(a))


def _batch(cfg: TMConfig, state: TMState, key, x_literals, y) -> tuple:
    """Step inputs on the state's device; the key (a tensor, or raw key
    data) stays where it is, since its draws run there.  Labels are
    checked here, before any kernel indexes by them."""
    dev = state.ta.device
    key = key if isinstance(key, torch.Tensor) else prng.wrap_key_data(key)
    y = _tensor(y).to(torch.int64)
    if y.numel() and (int(y.min()) < 0 or int(y.max()) >= cfg.n_classes):
        raise ValueError(f"labels out of range [0, {cfg.n_classes})")
    return (key, _tensor(x_literals).to(dev, torch.int8).contiguous(),
            y.to(dev))


def _polarity_words(cfg: TMConfig, device) -> tuple:
    pol = clause_polarity(cfg.n_clauses, device)
    return pack_bits((pol > 0).to(torch.int8)), \
        pack_bits((pol < 0).to(torch.int8))


def _packed_clauses_votes(cfg, state, x, pos_mask, neg_mask):
    """SWAR clause eval + class sums on the bit-packed word layout →
    (clauses (B, C, M) int8, votes (B, C) int32)."""
    c, m = cfg.n_classes, cfg.n_clauses
    inc = (state.ta > cfg.n_states).to(torch.int8)
    inc_words = pack_bits(inc.reshape(c * m, cfg.n_literals))   # (CM, Wl)
    return swar_clauses_votes(inc_words, pos_mask, neg_mask, x, c=c, m=m)


def _deltas_from_votes(cfg, state, key, x, y, votes, inc8, *, boost_tpf):
    """Shared tail of the fused and sparse steps: feedback masks → kernel
    K2 (the threefry words, Type I/II and the per-class scatter) →
    clipped new state."""
    y_neg, fb_t, fb_n, k1s, k2s = feedback_masks(cfg, key, votes, y)
    pos = (clause_polarity(cfg.n_clauses, x.device) > 0)[None, :]
    masks = feedback_polarity_masks(fb_t, fb_n, pos)
    p_inc = 1.0 if boost_tpf else (cfg.s - 1.0) / cfg.s
    upd = train_deltas_keyed(x, k1s, k2s, inc8, *masks, y, y_neg,
                             n_classes=cfg.n_classes, p_inc=p_inc,
                             p_dec=1.0 / cfg.s)
    return TMState(ta=(state.ta + upd).clamp(1, 2 * cfg.n_states))


@register_train_backend("reference")
class ReferenceTrainEngine:
    """Wraps :func:`repro_torch.core.tm_train.train_step` — the oracle."""

    def __init__(self, cfg: TMConfig, *, boost_tpf: bool = True):
        self.cfg = cfg
        self.boost_tpf = boost_tpf

    def step(self, state: TMState, key, x_literals, y) -> TMState:
        """One reference update (see :class:`TrainEngine`)."""
        key, x, y = _batch(self.cfg, state, key, x_literals, y)
        return train_step(self.cfg, state, key, x, y,
                          boost_tpf=self.boost_tpf)

    def lifecycle_opts(self) -> dict:
        """Constructor opts to persist (see :func:`train_engine_opts`)."""
        return {"boost_tpf": self.boost_tpf}


@register_train_backend("packed")
class PackedTrainEngine:
    """Bit-packed SWAR clause eval feeding the shared feedback math."""

    def __init__(self, cfg: TMConfig, *, boost_tpf: bool = True):
        self.cfg = cfg
        self.boost_tpf = boost_tpf

    def step(self, state: TMState, key, x_literals, y) -> TMState:
        """One packed-layout update (see :class:`TrainEngine`)."""
        key, x, y = _batch(self.cfg, state, key, x_literals, y)
        pos_mask, neg_mask = _polarity_words(self.cfg, x.device)
        clauses, votes = _packed_clauses_votes(self.cfg, state, x, pos_mask,
                                               neg_mask)
        return feedback_update(self.cfg, state, key, x, y, clauses, votes,
                               boost_tpf=self.boost_tpf)

    def lifecycle_opts(self) -> dict:
        """Constructor opts to persist (see :func:`train_engine_opts`)."""
        return {"boost_tpf": self.boost_tpf}


@register_train_backend("fused")
class FusedTrainEngine:
    """Fused training on kernels K1 and K2.

    Class sums come from K1 on the packed ¬literal and include words;
    the feedback masks and row keys come from the shared PRNG contract;
    K2 then evaluates the addressed classes' clauses, draws the Type I
    words from the row keys and sums the Type I/II deltas per class, so
    the per-sample ``(B, M, 2F)`` tensors of the reference are never
    written.  ``block_b``/``block_m`` are kept for the JAX package's
    engine options and do not change the CUDA kernels' tiling.
    """

    def __init__(self, cfg: TMConfig, *, boost_tpf: bool = True,
                 block_b: int = DEFAULT_BLOCK_B,
                 block_m: int = DEFAULT_BLOCK_M):
        self.cfg = cfg
        self.boost_tpf = boost_tpf
        self._blocks = (block_b, block_m)
        self._vms: dict[torch.device, torch.Tensor] = {}

    def _vote_matrix(self, device) -> torch.Tensor:
        vm = self._vms.get(device)
        if vm is None:
            vm = self._vms[device] = make_vote_matrix(
                self.cfg.n_classes, self.cfg.n_clauses, device)
        return vm

    def step(self, state: TMState, key, x_literals, y) -> TMState:
        """One fused-kernel update (see :class:`TrainEngine`)."""
        cfg = self.cfg
        key, x, y = _batch(cfg, state, key, x_literals, y)
        inc8 = (state.ta > cfg.n_states).to(torch.int8)           # (C, M, L)
        inc_words = pack_bits(inc8.reshape(-1, cfg.n_literals))   # (CM, Wl)
        votes = swar_fused_votes(pack_bits(1 - x), inc_words,
                                 self._vote_matrix(x.device))     # (B, C)
        return _deltas_from_votes(cfg, state, key, x, y, votes, inc8,
                                  boost_tpf=self.boost_tpf)

    def lifecycle_opts(self) -> dict:
        """Constructor opts to persist, the JAX package's keys (see
        :func:`train_engine_opts`)."""
        return {"boost_tpf": self.boost_tpf,
                "block_b": self._blocks[0], "block_m": self._blocks[1]}


@register_train_backend("sparse")
class SparseTrainEngine:
    """Clause-indexed training: ELL-gathered class sums, fused deltas.

    Class sums come from the batch-bit-packed gather over the ELL index
    matrix (:func:`~repro_torch.kernels.ell_gather.ell_clause_votes`),
    O(R·K) per 32-sample word instead of the dense O(R·L), and the shared
    fused tail (feedback masks, then kernel K2) applies feedback, so the
    backend is delta-exact against ``reference``/``packed``/``fused`` for
    the same key.  The index matrix is state-derived: the engine carries
    an :class:`~repro_torch.engine.sparse.IncrementalEll` and refreshes
    it from each step's input state by include deltas (at most 2·M rows
    change per update), with a full rebuild only on K overflow or
    ``rebuild_threshold`` cumulative drift.  PyTorch runs eagerly, so
    every step sees a concrete state and needs no traced fallback.

    ``k_slack``/``rebuild_threshold`` tune the layout refresh policy;
    ``block_b``/``block_m`` are kept for the JAX package's engine options
    and do not change the CUDA kernels' tiling.
    """

    def __init__(self, cfg: TMConfig, *, boost_tpf: bool = True,
                 k_slack: int = DEFAULT_K_SLACK,
                 rebuild_threshold: float = DEFAULT_REBUILD_THRESHOLD,
                 block_b: int = DEFAULT_BLOCK_B,
                 block_m: int = DEFAULT_BLOCK_M):
        self.cfg = cfg
        self.boost_tpf = boost_tpf
        self.k_slack = int(k_slack)
        self.rebuild_threshold = float(rebuild_threshold)
        self._blocks = (block_b, block_m)
        self._ell: IncrementalEll | None = None

    def _refresh(self, state: TMState,
                 inc8: torch.Tensor | None = None) -> torch.Tensor:
        """Sync the incremental layout to ``state``'s include mask
        (``inc8``, when the caller has it) → the index matrix on the
        state's device."""
        cfg = self.cfg
        if inc8 is None:
            inc8 = state.ta > cfg.n_states
        inc = inc8.reshape(cfg.n_classes * cfg.n_clauses, cfg.n_literals)
        if self._ell is None or self._ell.device != state.ta.device:
            self._ell = IncrementalEll(
                inc, k_slack=self.k_slack,
                rebuild_threshold=self.rebuild_threshold)
        else:
            self._ell.refresh(inc)
        return self._ell.layout.indices

    def step(self, state: TMState, key, x_literals, y) -> TMState:
        """One clause-indexed update (see :class:`TrainEngine`)."""
        cfg = self.cfg
        key, x, y = _batch(cfg, state, key, x_literals, y)
        inc8 = (state.ta > cfg.n_states).to(torch.int8)           # (C, M, L)
        indices = self._refresh(state, inc8)
        _, votes = ell_clause_votes(
            indices, clause_polarity(cfg.n_clauses, x.device), x,
            c=cfg.n_classes, m=cfg.n_clauses)
        return _deltas_from_votes(cfg, state, key, x, y, votes, inc8,
                                  boost_tpf=self.boost_tpf)

    def layout_stats(self) -> dict | None:
        """Refresh counters of the engine's :class:`IncrementalEll`
        (``None`` before the first step)."""
        return None if self._ell is None else self._ell.stats()

    def lifecycle_opts(self) -> dict:
        """Constructor opts to persist, the JAX package's keys (see
        :func:`train_engine_opts`)."""
        return {"boost_tpf": self.boost_tpf, "k_slack": self.k_slack,
                "rebuild_threshold": self.rebuild_threshold,
                "block_b": self._blocks[0], "block_m": self._blocks[1]}
