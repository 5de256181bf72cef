"""Zamba2-2.7B [arXiv:2411.15242] — hybrid Mamba2 + shared attention.

54 Mamba2 layers (d_model 2560, ssm_state 64, head_dim 64 → 80 ssm heads);
one *shared* transformer block (32-head MHA + d_ff 10240 MLP) applied every
6 mamba layers (9 applications, shared weights).
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    supports_long=True,        # SSM backbone → sub-quadratic
    notes="Shared attention block (single weight set, 9 applications); "
          "attention KV cached per application site.",
))
