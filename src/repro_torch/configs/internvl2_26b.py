"""InternVL2-26B language backbone (InternLM2-20B) [arXiv:2404.16821].

48L, d_model 6144, 48 q heads / 8 kv (GQA), d_ff 16384, vocab 92553
(padded 92672).  The InternViT-6B vision frontend is a STUB per the brief:
``input_specs`` provides precomputed patch embeddings (B, 256, d_model)
prepended to the token sequence.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    prefix_len=256,
    supports_long=False,       # full attention — long_500k skipped
    notes="VLM: patch-embedding prefix stub; bidirectional prefix attention "
          "approximated causal (decoder-only backbone).",
))
