"""Datasets, evaluation, index files (index_io, invlists_io), the factory,
the benchmark grid and state carried over from the JAX package."""

from . import (  # noqa: F401
    benchmark,
    convert,
    datasets,
    evaluation,
    factory,
    index_io,
    invlists_io,
)
