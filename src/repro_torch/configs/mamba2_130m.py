"""Mamba2-130M [arXiv:2405.21060]. 24L, d_model 768, attention-free SSD,
ssm_state 128, head_dim 64 (24 ssm heads), vocab 50280 (padded 50432).

24 ssm heads / 3352-wide in_proj don't divide TP=16 — and a 130M model has
no business being tensor-parallel — so model-axis rules are overridden to
replicate (pure DP/FSDP); see DESIGN.md §4."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    supports_long=True,        # SSM: O(1) decode state
    rules_overrides=(("ssm_inner", None), ("ssm_heads", None),
                     ("mlp", None)),
))
