"""Random generation — port of ``raft_tpu/random/rng.py`` (reference
``random/rng.cuh``, ``random/rng_state.hpp:28-52``).

The JAX package threads a counter-based key; here an :class:`RngState`
hands out one ``torch.Generator`` a draw, seeded from ``(seed, counter)``,
on the device the draw runs on. The distribution surface is the same:
uniform, uniformInt, normal, lognormal, gumbel, logistic, laplace,
exponential, rayleigh, bernoulli, scaled_bernoulli, sample-without-
replacement, permute. Draws are reproducible for a seed on one device;
they never equal ``jax.random``'s bit for bit, and a CUDA generator draws
other values than a CPU one.

Every draw takes ``device=``: where it runs when ``rng`` is a seed or an
:class:`RngState` (None: the default handle's device, ``cuda``). A
``torch.Generator`` draws on its own device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Union

import numpy as np
import torch

from raft_tpu_torch.core.resources import ensure_resources


class GeneratorType(enum.IntEnum):
    """Mirrors ``random/rng_state.hpp`` (PCG default, Philox). Both map to
    PyTorch's generator of the device (Philox on CUDA); the distinction is
    kept for API parity."""

    Pcg = 0
    Philox = 1


def _device(device) -> torch.device:
    if device is None:
        return ensure_resources(None).device
    return torch.device(device)


def _mix(seed: int, counter: int) -> int:
    """A 63-bit generator seed from (seed, counter): ``fold_in``'s role."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), int(counter)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class RngState:
    """Seed + generator selector (``random::RngState``). Each
    :meth:`key` is a fresh generator seeded from ``(seed, counter)``;
    ``advance`` mirrors the reference's subsequence advancing for
    reproducible parallel draws."""

    seed: int = 0
    type: GeneratorType = GeneratorType.Pcg
    _counter: int = 0

    def key(self, device=None) -> torch.Generator:
        g = torch.Generator(device=_device(device))
        g.manual_seed(_mix(self.seed, self._counter))
        self._counter += 1
        return g

    def advance(self, n: int = 1) -> None:
        self._counter += n


Rng = Union[RngState, torch.Generator, int]


def _key_of(rng: Rng, device=None) -> torch.Generator:
    """The generator a draw takes: the next of an :class:`RngState`, a
    fresh one seeded by an int, or a ``torch.Generator`` itself."""
    if isinstance(rng, RngState):
        return rng.key(device)
    if isinstance(rng, torch.Generator):
        return rng
    g = torch.Generator(device=_device(device))
    g.manual_seed(_mix(int(rng), 0))
    return g


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _uniform01(g: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.rand(_shape(shape), generator=g, device=g.device,
                      dtype=dtype)


def _open01(g: torch.Generator, shape, dtype) -> torch.Tensor:
    """Uniform draws in (0, 1): the log-transforms' inputs."""
    tiny = torch.finfo(dtype).tiny
    return _uniform01(g, shape, dtype).clamp_(min=tiny)


def uniform(rng, shape, low=0.0, high=1.0, dtype=torch.float32, *,
            device=None):
    g = _key_of(rng, device)
    return low + (high - low) * _uniform01(g, shape, dtype)


def uniform_int(rng, shape, low, high, dtype=torch.int32, *, device=None):
    g = _key_of(rng, device)
    return torch.randint(int(low), int(high), _shape(shape), generator=g,
                         device=g.device, dtype=dtype)


def normal(rng, shape, mu=0.0, sigma=1.0, dtype=torch.float32, *,
           device=None):
    g = _key_of(rng, device)
    return mu + sigma * torch.randn(_shape(shape), generator=g,
                                    device=g.device, dtype=dtype)


def lognormal(rng, shape, mu=0.0, sigma=1.0, dtype=torch.float32, *,
              device=None):
    return torch.exp(normal(rng, shape, mu, sigma, dtype, device=device))


def gumbel(rng, shape, mu=0.0, beta=1.0, dtype=torch.float32, *,
           device=None):
    u = _open01(_key_of(rng, device), shape, dtype)
    return mu - beta * torch.log(-torch.log(u))


def logistic(rng, shape, mu=0.0, scale=1.0, dtype=torch.float32, *,
             device=None):
    u = _open01(_key_of(rng, device), shape, dtype)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def laplace(rng, shape, mu=0.0, scale=1.0, dtype=torch.float32, *,
            device=None):
    u = _uniform01(_key_of(rng, device), shape, dtype) - 0.5
    tiny = torch.finfo(dtype).tiny
    return mu - scale * torch.sign(u) * torch.log(
        torch.clamp(1.0 - 2.0 * u.abs(), min=tiny))


def exponential(rng, shape, lam=1.0, dtype=torch.float32, *, device=None):
    u = _uniform01(_key_of(rng, device), shape, dtype)
    return -torch.log1p(-u) / lam


def rayleigh(rng, shape, sigma=1.0, dtype=torch.float32, *, device=None):
    u = _uniform01(_key_of(rng, device), shape, dtype)
    return sigma * torch.sqrt(-2.0 * torch.log1p(-u))


def bernoulli(rng, shape, prob=0.5, *, device=None):
    return _uniform01(_key_of(rng, device), shape, torch.float32) < prob


def scaled_bernoulli(rng, shape, prob=0.5, scale=1.0, dtype=torch.float32,
                     *, device=None):
    b = bernoulli(rng, shape, prob, device=device)
    return torch.where(b, torch.tensor(scale, dtype=dtype, device=b.device),
                       torch.tensor(-scale, dtype=dtype, device=b.device))


def permute(rng, n: int, *, device=None) -> torch.Tensor:
    """Random permutation of [0, n) (``random::permute``)."""
    g = _key_of(rng, device)
    return torch.randperm(n, generator=g, device=g.device).to(torch.int32)


def sample_without_replacement(
    rng,
    n_samples: int,
    population: int,
    weights=None,
    *,
    device=None,
) -> torch.Tensor:
    """Sample ``n_samples`` distinct indices from [0, population)
    (``random::sample_without_replacement``; weighted via Gumbel-top-k,
    the largest keys first, ties to the smaller index)."""
    g = _key_of(rng, device)
    if weights is None:
        return torch.randperm(population, generator=g,
                              device=g.device)[:n_samples].to(torch.int32)
    w = torch.as_tensor(weights, dtype=torch.float32).to(g.device)
    keys = torch.log(w) + gumbel(g, (population,))
    order = torch.sort(keys, descending=True, stable=True).indices
    return order[:n_samples].to(torch.int32)


def subsample(rng, population: int, n_samples: int, *,
              device=None) -> torch.Tensor:
    """Deterministic-stride subsample used for trainset selection
    (role of ``detail/ivf_pq_build.cuh:1537-1607`` subsampling)."""
    dev = rng.device if isinstance(rng, torch.Generator) else _device(device)
    if n_samples >= population:
        return torch.arange(population, device=dev, dtype=torch.int32)
    stride = population // n_samples
    return (torch.arange(n_samples, device=dev) * stride).to(torch.int32)

