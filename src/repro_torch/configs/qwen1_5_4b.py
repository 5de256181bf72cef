"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B]. 40L, d_model 2560, 20 heads MHA
(kv=20), d_ff 6912, vocab 151936, QKV bias.

20 heads don't divide TP=16: both q and kv padded to 32 (exact zero-masked
padding; see attention.py docstring)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    supports_long=False,       # full attention — long_500k skipped
))
