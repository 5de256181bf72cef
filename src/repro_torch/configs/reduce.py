"""Reduced same-family configs for CPU smoke tests (a copy of
``repro.configs.reduce``).

Keeps every structural feature (MoE routing, MLA, superblocks, shared
attention, enc-dec, prefix stubs) at toy width/depth so one forward step
runs on CPU in seconds.  The full configs run on the card.
"""

from __future__ import annotations

import dataclasses

from .base import ModelConfig

__all__ = ["reduced"]


def reduced(cfg: ModelConfig) -> ModelConfig:
    r: dict = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        vocab_size=512,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
    )
    if cfg.family == "dense":
        r.update(n_layers=2, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2)
        if cfg.window:
            r.update(window=16)
        if cfg.prefix_len:
            r.update(prefix_len=8)
    elif cfg.family == "moe" and not cfg.use_mla:   # llama4
        r.update(n_layers=4, global_every=2, n_heads=4, n_kv_heads=2,
                 chunk=16, n_experts=4, top_k=1, moe_d_ff=128,
                 n_shared_experts=1, shared_d_ff=128)
    elif cfg.family == "moe":                        # deepseek
        r.update(n_layers=3, n_heads=4, first_dense=1, use_mla=True,
                 kv_lora=32, q_lora=48, rope_head_dim=8, nope_head_dim=16,
                 v_head_dim=16, n_experts=8, top_k=2, moe_d_ff=64,
                 n_shared_experts=2, shared_d_ff=128)
    elif cfg.family == "ssm":
        r.update(n_layers=2, ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    elif cfg.family == "hybrid":
        r.update(n_layers=4, shared_attn_every=2, n_heads=4, n_kv_heads=4,
                 ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    elif cfg.family == "encdec":
        r.update(n_layers=2, n_enc_layers=2, n_heads=4, n_kv_heads=4,
                 enc_len_ratio=cfg.enc_len_ratio)
    return dataclasses.replace(cfg, **r)
