"""Datasets, evaluation, index files (index_io, invlists_io), the factory,
the benchmark grid, autotune, ivflib, cooperative cancellation (interrupt)
and state carried over from the JAX package."""

from . import (  # noqa: F401
    autotune,
    benchmark,
    convert,
    datasets,
    evaluation,
    factory,
    index_io,
    interrupt,
    invlists_io,
    ivflib,
)
