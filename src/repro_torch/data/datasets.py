"""Seeded synthetic datasets, numpy only (the port's own copy of
``repro.data.datasets``; the offline container has no real datasets).

- ``iris_like``: 3-class, 4-feature Gaussian draw using the *published*
  per-class feature moments of Fisher's Iris (UCI), so quantile-binned
  booleanization and TM accuracy land in the paper's regime (Table I).
- ``mnist_like``: 10-class, 28×28 images built from per-class stroke
  prototypes + bit-flip noise; threshold booleanization (>75) matches
  the paper's §IV-B.  Dimensionality identical to MNIST (784).

- ``lm_token_stream``: a Zipf-unigram + hashed n-gram token stream for
  LM training.

All draw from ``np.random.default_rng(seed)`` exactly as the JAX
package does, so the same seed gives the same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["iris_like", "mnist_like", "lm_token_stream"]

# Published per-class (mean, std) for sepal-length, sepal-width,
# petal-length, petal-width — Fisher (1936) / UCI summary statistics.
_IRIS_MOMENTS = {
    0: ([5.006, 3.428, 1.462, 0.246], [0.352, 0.379, 0.174, 0.105]),  # setosa
    1: ([5.936, 2.770, 4.260, 1.326], [0.516, 0.314, 0.470, 0.198]),  # versicolor
    2: ([6.588, 2.974, 5.552, 2.026], [0.636, 0.322, 0.552, 0.275]),  # virginica
}


def iris_like(n_per_class: int = 50, seed: int = 0
              ) -> tuple[np.ndarray, np.ndarray]:
    """→ (X float (3n,4), y int (3n,)) shuffled."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c, (mu, sd) in _IRIS_MOMENTS.items():
        xs.append(rng.normal(mu, sd, size=(n_per_class, 4)))
        ys.append(np.full(n_per_class, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def _digit_prototype(c: int) -> np.ndarray:
    """Crude 28×28 stroke prototype per digit class (deterministic)."""
    img = np.zeros((28, 28), np.float32)

    def line(r0, c0, r1, c1, w=2):
        n = max(abs(r1 - r0), abs(c1 - c0)) + 1
        for t in np.linspace(0.0, 1.0, 2 * n):
            r = int(round(r0 + (r1 - r0) * t))
            cc = int(round(c0 + (c1 - c0) * t))
            img[max(0, r - w // 2):r + w // 2 + 1,
                max(0, cc - w // 2):cc + w // 2 + 1] = 255.0

    def arc(cy, cx, rad, a0, a1, w=2):
        for a in np.linspace(a0, a1, 90):
            r = int(round(cy + rad * np.sin(a)))
            cc = int(round(cx + rad * np.cos(a)))
            if 0 <= r < 28 and 0 <= cc < 28:
                img[max(0, r - w // 2):r + w // 2 + 1,
                    max(0, cc - w // 2):cc + w // 2 + 1] = 255.0

    if c == 0:
        arc(14, 14, 8, 0, 2 * np.pi)
    elif c == 1:
        line(4, 14, 24, 14)
    elif c == 2:
        arc(9, 14, 5, np.pi, 2.5 * np.pi); line(13, 18, 23, 8); line(23, 8, 23, 20)
    elif c == 3:
        arc(9, 13, 5, np.pi * 0.8, 2.4 * np.pi); arc(19, 13, 5, np.pi * 1.6, 3.1 * np.pi)
    elif c == 4:
        line(4, 18, 16, 18); line(4, 18, 14, 6); line(14, 6, 14, 22); line(16, 18, 24, 18)
    elif c == 5:
        line(5, 8, 5, 20); line(5, 8, 13, 8); arc(17, 13, 5.5, np.pi * 1.3, 2.9 * np.pi)
    elif c == 6:
        arc(17, 13, 6, 0, 2 * np.pi); arc(10, 16, 9, np.pi * 0.9, np.pi * 1.5)
    elif c == 7:
        line(5, 6, 5, 21); line(5, 21, 23, 10)
    elif c == 8:
        arc(9, 14, 5, 0, 2 * np.pi); arc(19, 14, 6, 0, 2 * np.pi)
    else:
        arc(10, 14, 5.5, 0, 2 * np.pi); line(15, 19, 24, 15)
    return img


def mnist_like(n_per_class: int = 100, seed: int = 0, flip: float = 0.06,
               jitter: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """→ (X float (10n, 784) grayscale 0..255, y int). Threshold at 75 to
    booleanize per the paper."""
    rng = np.random.default_rng(seed)
    protos = [_digit_prototype(c) for c in range(10)]
    xs, ys = [], []
    for c in range(10):
        for _ in range(n_per_class):
            dx, dy = rng.integers(-jitter, jitter + 1, 2)
            img = np.roll(np.roll(protos[c], dx, 0), dy, 1)
            noise = rng.random((28, 28))
            img = np.where(noise < flip, 255.0 - img, img)
            xs.append(img.reshape(-1))
            ys.append(c)
    x = np.stack(xs).astype(np.float32)
    y = np.asarray(ys, np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def lm_token_stream(n_tokens: int, vocab_size: int, seed: int = 0,
                    order: int = 2) -> np.ndarray:
    """Deterministic Zipf-unigram + hashed n-gram token stream (int32).

    Learnable structure: next token = hash(prev ``order`` tokens) with prob
    0.75 (so a real LM's loss decreases), else a Zipf draw.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    out = np.empty(n_tokens, np.int64)
    out[:order] = rng.choice(vocab_size, size=order, p=probs)
    zipf_draws = rng.choice(vocab_size, size=n_tokens, p=probs)
    use_ngram = rng.random(n_tokens) < 0.75
    mult = np.int64(6364136223846793005)
    with np.errstate(over="ignore"):   # wrap-around is the hash function
        for i in range(order, n_tokens):
            if use_ngram[i]:
                h = np.int64(1442695040888963407)
                for j in range(order):
                    h = h * mult + out[i - 1 - j]
                out[i] = np.abs(h) % vocab_size
            else:
                out[i] = zipf_draws[i]
    return out.astype(np.int32)
