"""Llama-4 Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model 5120, 40 q heads / 8 kv (GQA), expert d_ff 8192, vocab 202048,
MoE 16 routed experts top-1 + 1 shared expert.  Attention is Llama-4's
iRoPE layout: chunked-local (8192) on 3 of every 4 layers, full (NoPE)
on every 4th — which is what makes ``long_500k`` decode tractable
(ring-buffer caches on local layers).
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                 # shared-expert hidden
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    shared_d_ff=8192,
    chunk=8192,
    global_every=4,
    rope_theta=5e5,
    supports_long=True,
    notes="MoE top-1 + shared expert; chunked local attention (iRoPE), "
          "global every 4th layer. q heads 40 padded to 48 for TP=16.",
))
