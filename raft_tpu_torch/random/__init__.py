"""RNG + data generators (reference ``raft/random/``); the port of
``raft_tpu/random``."""

from raft_tpu_torch.random.rng import (
    GeneratorType,
    RngState,
    uniform,
    uniform_int,
    normal,
    lognormal,
    gumbel,
    logistic,
    laplace,
    exponential,
    rayleigh,
    bernoulli,
    scaled_bernoulli,
    permute,
    sample_without_replacement,
    subsample,
)
from raft_tpu_torch.random.generators import (
    make_blobs,
    make_regression,
    rmat,
    multi_variable_gaussian,
)

__all__ = [
    "GeneratorType",
    "RngState",
    "uniform",
    "uniform_int",
    "normal",
    "lognormal",
    "gumbel",
    "logistic",
    "laplace",
    "exponential",
    "rayleigh",
    "bernoulli",
    "scaled_bernoulli",
    "permute",
    "sample_without_replacement",
    "subsample",
    "make_blobs",
    "make_regression",
    "rmat",
    "multi_variable_gaussian",
]
