"""SeamlessM4T-Large-v2 text backbone [arXiv:2308.11596] — enc-dec.

24L encoder + 24L decoder, d_model 1024, 16 heads MHA, d_ff 8192,
vocab 256206 (padded to 256256 for TP).  The speech frontend
(w2v-BERT conformer) is a STUB per the brief: ``input_specs`` provides
precomputed frame embeddings (B, seq_len // 4, d_model).
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,               # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    enc_len_ratio=4,
    supports_long=False,       # full attention — long_500k skipped
    notes="Audio frontend stubbed (frame embeddings). Decoder has self+cross "
          "attention; decode caches self-KV ring + static cross-KV.",
))
