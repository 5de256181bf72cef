"""Backend-dispatched inference and training engines (port of
``repro.engine``).

>>> from repro_torch.engine import get_engine, get_train_engine
>>> eng = get_engine("mxu_fused", cfg, state)   # or oracle / adder_tree /
>>> eng.infer(literals).prediction              #   swar_packed / swar_fused /
...                                             #   sparse_csr / cascade / ...
>>> new_state = get_train_engine("fused", cfg).step(state, key, lits, y)
"""

from .base import (DEFAULT_BACKEND, ENGINE_CACHE_SIZE, EngineResult,
                   ServiceStats, VoteEngine, available_backends,
                   clear_engine_cache, engine_cache_info,
                   evict_engines_for_state, get_engine, infer_padded,
                   nearest_rank, pad_batch, register_backend,
                   set_engine_cache_budget, state_nbytes,
                   weight_engines_for_state)
from . import backends  # noqa: F401  (registers the built-in backends)
from . import cascade  # noqa: F401  (registers the cascade backend)
from .train import (DEFAULT_TRAIN_BACKEND, TrainEngine,
                    available_train_backends, clear_train_engine_cache,
                    export_key_cursor, get_train_engine, import_key_cursor,
                    register_train_backend, train_engine_cache_info,
                    train_engine_opts)

__all__ = ["DEFAULT_BACKEND", "ENGINE_CACHE_SIZE", "EngineResult",
           "ServiceStats", "VoteEngine",
           "available_backends", "clear_engine_cache", "engine_cache_info",
           "evict_engines_for_state", "weight_engines_for_state",
           "set_engine_cache_budget", "get_engine", "infer_padded",
           "nearest_rank", "pad_batch", "register_backend", "state_nbytes",
           "DEFAULT_TRAIN_BACKEND", "TrainEngine", "available_train_backends",
           "clear_train_engine_cache", "export_key_cursor",
           "get_train_engine", "import_key_cursor", "register_train_backend",
           "train_engine_cache_info", "train_engine_opts",
           "engine_from_model_config"]


def engine_from_model_config(model_cfg, state, **opts) -> VoteEngine:
    """Build the engine a registered ``family="tm"`` ModelConfig asks for
    (:mod:`repro_torch.configs`), on ``state``'s device.

    TM configs repurpose LM fields (see ``repro_torch.configs.tm_paper``):
    ``n_heads`` = C, ``d_ff`` = M (clauses per class), ``d_model`` = F,
    ``rope_theta`` = T, ``norm_eps`` = s, plus the ``backend`` this engine
    layer dispatches on, and ``shard_batch`` (serve data-parallel over
    every visible CUDA device, see :func:`get_engine`).
    """
    from repro_torch.core.tm import TMConfig
    cfg = TMConfig(n_classes=model_cfg.n_heads, n_clauses=model_cfg.d_ff,
                   n_features=model_cfg.d_model, T=int(model_cfg.rope_theta),
                   s=model_cfg.norm_eps)
    return get_engine(model_cfg.backend, cfg, state,
                      shard_batch=model_cfg.shard_batch, **opts)
