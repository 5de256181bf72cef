"""Seeded synthetic datasets (numpy), as in :mod:`repro.data`."""

from .datasets import iris_like, mnist_like

__all__ = ["iris_like", "mnist_like"]
