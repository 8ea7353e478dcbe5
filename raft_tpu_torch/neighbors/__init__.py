"""Nearest-neighbor indexes: brute force, IVF-Flat, IVF-BQ, IVF-PQ,
CAGRA, tiered IVF-Flat, IVF-PQ and IVF-BQ, and int8 quantized kNN, with
the graph builders (cluster-join, NN-descent), refine, the index helpers
and the CAGRA ⇄ hnswlib file interop.

The modules load on first access (``raft_tpu_torch.neighbors.ivf_pq``),
as the JAX package's ``neighbors`` names them; importing them all here
would cycle through ``ops``, whose kernels' wrappers read
``neighbors.filters``.
"""

import importlib

__all__ = [
    "brute_force",
    "cagra",
    "cluster_join",
    "hnsw",
    "ivf_bq",
    "ivf_flat",
    "ivf_helpers",
    "ivf_pq",
    "nn_descent",
    "quantized",
    "refine",
    "tiered",
]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
