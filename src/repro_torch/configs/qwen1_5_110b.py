"""Qwen1.5-110B [hf:Qwen/Qwen1.5-110B]. 80L, d_model 8192, 64 q / 8 kv
(GQA), d_ff 49152, vocab 152064, QKV bias."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    supports_long=False,       # full attention — long_500k skipped
))
