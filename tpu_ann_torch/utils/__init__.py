"""Datasets, evaluation, index files (index_io, invlists_io), the factory,
the benchmark grid, autotune, ivflib, cooperative cancellation (interrupt),
state carried over from the JAX package, the contrib tools, memory and
energy accounting, the native host helpers, the RPC serving layer
(rpc, client_server), the offline build pipeline, the descriptor-driven
benchmark framework (bench_fw) and the IVF analyzers."""

from . import (  # noqa: F401
    analyzers,
    autotune,
    bench_fw,
    benchmark,
    client_server,
    contrib,
    convert,
    datasets,
    evaluation,
    factory,
    index_io,
    interrupt,
    invlists_io,
    ivflib,
    memory,
    native,
    offline_pipeline,
    rpc,
)
