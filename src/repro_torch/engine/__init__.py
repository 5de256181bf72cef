"""Backend-dispatched inference and training engines (port of
``repro.engine``).

>>> from repro_torch.engine import get_engine, get_train_engine
>>> eng = get_engine("mxu_fused", cfg, state)   # or oracle / adder_tree /
>>> eng.infer(literals).prediction              #   swar_packed / swar_fused /
...                                             #   sparse_csr / cascade / ...
>>> new_state = get_train_engine("fused", cfg).step(state, key, lits, y)
"""

from .base import (DEFAULT_BACKEND, EngineResult, ServiceStats, VoteEngine,
                   available_backends, clear_engine_cache, engine_cache_info,
                   evict_engines_for_state, get_engine, infer_padded,
                   nearest_rank, pad_batch, register_backend, state_nbytes)
from . import backends  # noqa: F401  (registers the built-in backends)
from . import cascade  # noqa: F401  (registers the cascade backend)
from .train import (DEFAULT_TRAIN_BACKEND, TrainEngine,
                    available_train_backends, clear_train_engine_cache,
                    export_key_cursor, get_train_engine, import_key_cursor,
                    register_train_backend, train_engine_cache_info,
                    train_engine_opts)

__all__ = ["DEFAULT_BACKEND", "EngineResult", "ServiceStats", "VoteEngine",
           "available_backends", "clear_engine_cache", "engine_cache_info",
           "evict_engines_for_state", "get_engine", "infer_padded",
           "nearest_rank", "pad_batch", "register_backend", "state_nbytes",
           "DEFAULT_TRAIN_BACKEND", "TrainEngine", "available_train_backends",
           "clear_train_engine_cache", "export_key_cursor",
           "get_train_engine", "import_key_cursor", "register_train_backend",
           "train_engine_cache_info", "train_engine_opts"]
