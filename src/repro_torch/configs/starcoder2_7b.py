"""StarCoder2-7B [arXiv:2402.19173]. 32L, d_model 4608, 36 q / 4 kv (GQA),
d_ff 18432, vocab 49152, RoPE, sliding window 4096.

The sliding window makes decode O(window) per token with a ring-buffer KV
cache, so this arch also runs ``long_500k`` (documented bonus cell —
DESIGN.md §5).  q heads 36 padded to 48 for TP=16.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    window=4096,
    supports_long=True,
))
