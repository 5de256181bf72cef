"""Seeded synthetic datasets (numpy) and the resumable host-sharded LM
loader, as in :mod:`repro.data`."""

from .datasets import iris_like, lm_token_stream, mnist_like
from .pipeline import ShardedLoader

__all__ = ["iris_like", "mnist_like", "lm_token_stream", "ShardedLoader"]
