"""The dense half of ``repro.models.moe``: the SwiGLU MLP (also the JAX
package's shared expert and dense-layer FFN).

``MoECfg``, ``moe_defs`` and ``moe_apply`` (routed experts) come with the
MoE serving slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from .common import ParamDef

__all__ = ["mlp_defs", "mlp_apply"]


def mlp_defs(d_model: int, d_ff: int) -> dict:
    return {
        "w1": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w3": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w2": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x @ w1) * (x @ w3) @ w2`` in ``x``'s dtype."""
    dt = x.dtype
    h = torch.nn.functional.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))
    return h @ p["w2"].to(dt)
