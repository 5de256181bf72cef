"""Config registry (port of ``repro.configs``): the paper's Tsetlin
machines and BNN (:mod:`.tm_paper`).  The LM architectures come with the
model zoo (ROADMAP.md, queue 1).

>>> from repro_torch.configs import get_config
>>> get_config("tm-mnist-50").backend
'mxu_fused'
"""

from .base import (SHAPES, ModelConfig, ShapeSpec, get_config, list_configs,
                   register)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import tm_paper  # noqa: F401  (registers the presets)


__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_configs",
           "register"]
