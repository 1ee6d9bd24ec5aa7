"""Datasets, evaluation and state carried over from the JAX package."""

from . import convert, datasets, evaluation  # noqa: F401
