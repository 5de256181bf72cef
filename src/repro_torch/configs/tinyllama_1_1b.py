"""TinyLlama-1.1B [arXiv:2401.02385]. 22L, d_model 2048, 32 q / 4 kv (GQA),
d_ff 5632, vocab 32000 — llama2-architecture small model; also the
end-to-end training example (examples/train_lm.py)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    supports_long=False,       # full attention — long_500k skipped
))
