"""Config registry (port of ``repro.configs``): one module per LM
architecture (copies of the JAX package's, pure data) and the paper's
Tsetlin machines and BNN (:mod:`.tm_paper`), so ``list_configs()`` names
what the JAX registry names.  :mod:`.reduce` gives the CPU smoke widths.

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
    from . import (deepseek_v2_236b, internvl2_26b, llama4_scout_17b_a16e,
                   mamba2_130m, qwen1_5_110b, qwen1_5_4b, seamless_m4t_large_v2,
                   starcoder2_7b, tinyllama_1_1b, tm_paper, zamba2_2_7b)  # noqa: F401


__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_configs",
           "register"]
