"""Core TM numerics: popcount algorithms and the Tsetlin machine model."""
