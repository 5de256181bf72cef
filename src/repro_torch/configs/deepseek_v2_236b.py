"""DeepSeek-V2 236B [arXiv:2405.04434].

60L, d_model 5120, 128 heads, MLA (kv_lora 512, q_lora 1536, decoupled RoPE
key 64, nope 128, v 128), vocab 102400; MoE: 160 routed experts top-6 +
2 shared experts, expert d_ff 1536; first layer dense FFN (d_ff 12288).
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,                # first dense layer FFN
    vocab_size=102400,
    use_mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    moe_d_ff=1536,
    n_shared_experts=2,
    shared_d_ff=3072,          # 2 shared experts fused
    first_dense=1,
    supports_long=False,       # full attention — long_500k skipped (DESIGN.md)
    notes="MLA latent cache (kv_lora+rope_dim per token).",
))
