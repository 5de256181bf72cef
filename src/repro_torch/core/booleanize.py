"""Booleanization of raw features, following the paper's §IV-B (port of
``repro.core.booleanize``).

- Iris: each raw feature → quantile binning into ``n_bins`` one-hot
  Boolean features (the paper uses 3 bins → 12 Boolean features).
- MNIST: a global grayscale threshold (the paper uses 75).

The fitting and binning are numpy host logic, kept as the JAX package
has them; :func:`to_literals` builds the TM's literal tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["QuantileBooleanizer", "threshold_booleanize", "to_literals"]


@dataclasses.dataclass
class QuantileBooleanizer:
    """Quantile-bin each feature into a one-hot code of ``n_bins`` bits."""

    n_bins: int = 3
    edges_: np.ndarray | None = None  # (n_features, n_bins - 1)

    def fit(self, x: np.ndarray) -> "QuantileBooleanizer":
        qs = np.linspace(0.0, 1.0, self.n_bins + 1)[1:-1]
        self.edges_ = np.quantile(np.asarray(x, np.float64), qs, axis=0).T
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.edges_ is None:
            raise RuntimeError("call fit() first")
        x = np.asarray(x, np.float64)
        # bin index per feature: count of edges below the value
        idx = (x[:, :, None] > self.edges_[None, :, :]).sum(-1)  # (B, F)
        onehot = np.eye(self.n_bins, dtype=np.int8)[idx]  # (B, F, n_bins)
        return onehot.reshape(x.shape[0], -1)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    @property
    def n_boolean_features(self) -> int:
        if self.edges_ is None:
            raise RuntimeError("call fit() first")
        return self.edges_.shape[0] * self.n_bins


def threshold_booleanize(x, threshold: float = 75.0) -> np.ndarray:
    """Paper's MNIST booleanization: ``x > threshold`` → int8 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (np.asarray(x) > threshold).astype(np.int8)


def to_literals(x_bool) -> torch.Tensor:
    """Boolean features → literal vector ``[x, ¬x]`` of length 2F (TM
    input), int8; a tensor stays on its device, numpy goes to the CPU."""
    x = x_bool if isinstance(x_bool, torch.Tensor) else \
        torch.as_tensor(np.asarray(x_bool))
    x = x.to(torch.int8)
    return torch.cat([x, 1 - x], dim=-1)
