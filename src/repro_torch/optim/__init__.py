"""AdamW with global-norm clipping and the warmup + cosine schedule
(port of ``repro.optim``)."""

from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    global_norm)
from .schedule import cosine_warmup

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "global_norm", "cosine_warmup"]
