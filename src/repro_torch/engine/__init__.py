"""Backend-dispatched inference engines (port of ``repro.engine``).

>>> from repro_torch.engine import get_engine
>>> eng = get_engine("mxu_fused", cfg, state)   # or oracle / adder_tree /
>>> eng.infer(literals).prediction              #   swar_packed / swar_fused

Training engines (``get_train_engine``) come with the next slice of the
port (see ROADMAP.md).
"""

from .base import (DEFAULT_BACKEND, EngineResult, ServiceStats, VoteEngine,
                   available_backends, clear_engine_cache, engine_cache_info,
                   evict_engines_for_state, get_engine, infer_padded,
                   nearest_rank, pad_batch, register_backend, state_nbytes)
from . import backends  # noqa: F401  (registers the built-in backends)

__all__ = ["DEFAULT_BACKEND", "EngineResult", "ServiceStats", "VoteEngine",
           "available_backends", "clear_engine_cache", "engine_cache_info",
           "evict_engines_for_state", "get_engine", "infer_padded",
           "nearest_rank", "pad_batch", "register_backend", "state_nbytes"]
