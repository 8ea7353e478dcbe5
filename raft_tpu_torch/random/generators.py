"""Synthetic data generators — port of ``raft_tpu/random/generators.py``:
``make_blobs``, ``make_regression``, RMAT graphs, multi-variable gaussian
(reference ``random/make_blobs.cuh``, ``random/make_regression.cuh``,
``random/rmat_rectangular_generator.cuh``,
``random/multi_variable_gaussian.cuh``). Each draws on the generator's
device (``device=`` as in :mod:`raft_tpu_torch.random.rng`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.random.rng import _key_of, _mix


def _split(rng, device, n: int):
    """``n`` generators from one draw key (``jax.random.split``'s role):
    seeded from the key's first ``n`` 63-bit draws."""
    g = _key_of(rng, device)
    seeds = torch.randint(0, 2**62, (n,), generator=g, device=g.device)
    out = []
    for s in seeds.tolist():
        h = torch.Generator(device=g.device)
        h.manual_seed(_mix(s, 1))
        out.append(h)
    return out


def make_blobs(
    rng,
    n_samples: int,
    n_features: int,
    n_clusters: int = 3,
    cluster_std: float = 1.0,
    center_box: Tuple[float, float] = (-10.0, 10.0),
    centers=None,
    shuffle: bool = True,
    dtype=torch.float32,
    *,
    device=None,
):
    """Isotropic Gaussian blobs (``random::make_blobs``). Returns (X,
    labels int32, centers).

    Examples
    --------
    >>> from raft_tpu_torch import random as rrandom
    >>> X, labels, centers = rrandom.make_blobs(
    ...     rrandom.RngState(0), 30, 4, n_clusters=3, device="cpu")
    >>> (tuple(X.shape), tuple(labels.shape), tuple(centers.shape))
    ((30, 4), (30,), (3, 4))
    """
    k_centers, k_labels, k_noise, k_shuffle = _split(rng, device, 4)
    dev = k_centers.device
    if centers is None:
        lo, hi = center_box
        centers = lo + (hi - lo) * torch.rand(
            (n_clusters, n_features), generator=k_centers, device=dev,
            dtype=dtype)
    else:
        centers = torch.as_tensor(centers).to(device=dev, dtype=dtype)
        n_clusters = centers.shape[0]
    labels = torch.randint(0, n_clusters, (n_samples,), generator=k_labels,
                           device=dev)
    x = torch.randn((n_samples, n_features), generator=k_noise, device=dev,
                    dtype=dtype)
    x.mul_(cluster_std).add_(centers[labels])
    if shuffle:
        perm = torch.randperm(n_samples, generator=k_shuffle, device=dev)
        x, labels = x[perm], labels[perm]
    return x, labels.to(torch.int32), centers


def make_regression(
    rng,
    n_samples: int,
    n_features: int,
    n_informative: Optional[int] = None,
    n_targets: int = 1,
    bias: float = 0.0,
    noise: float = 0.0,
    shuffle: bool = True,
    dtype=torch.float32,
    *,
    device=None,
):
    """Random linear regression problem (``random::make_regression``).
    Returns (X, y, coef)."""
    n_informative = n_informative if n_informative is not None else n_features
    k_x, k_w, k_noise, k_shuffle = _split(rng, device, 4)
    dev = k_x.device
    x = torch.randn((n_samples, n_features), generator=k_x, device=dev,
                    dtype=dtype)
    coef = torch.zeros((n_features, n_targets), dtype=dtype, device=dev)
    coef[:n_informative] = 100.0 * torch.rand(
        (n_informative, n_targets), generator=k_w, device=dev, dtype=dtype)
    y = x @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape, generator=k_noise, device=dev,
                                    dtype=dtype)
    if shuffle:
        perm = torch.randperm(n_samples, generator=k_shuffle, device=dev)
        x, y = x[perm], y[perm]
    return x, y, coef


def rmat(
    rng,
    r_scale: int,
    c_scale: int,
    n_edges: int,
    theta=None,
    *,
    device=None,
) -> torch.Tensor:
    """RMAT rectangular graph generator
    (``random::rmat_rectangular_generator``): recursively pick quadrants by
    (a,b,c,d) probabilities, one bit per level — vectorized over edges.
    Returns int32 (n_edges, 2) [src, dst]."""
    g = _key_of(rng, device)
    dev = g.device
    if theta is None:
        theta = [0.57, 0.19, 0.19, 0.05]
    theta = torch.as_tensor(theta, dtype=torch.float32).reshape(-1)[:4]
    cdf = torch.cumsum(theta / theta.sum(), 0).to(dev)
    max_scale = max(r_scale, c_scale)
    # quadrant draw per (edge, level) by inverting the quadrant CDF
    u = torch.rand((n_edges, max_scale), generator=g, device=dev)
    draws = torch.searchsorted(cdf[:3].contiguous(), u.contiguous(),
                               right=True)
    # quadrant 0,1,2,3 -> (row_bit, col_bit) = (q >> 1, q & 1)
    row_bits = draws >> 1
    col_bits = draws & 1
    lvl = torch.arange(max_scale, device=dev)
    r_pow = torch.where(lvl < r_scale, 2 ** (r_scale - 1 - lvl).clamp(min=0),
                        torch.zeros_like(lvl))
    c_pow = torch.where(lvl < c_scale, 2 ** (c_scale - 1 - lvl).clamp(min=0),
                        torch.zeros_like(lvl))
    src = (row_bits * r_pow[None, :]).sum(dim=1)
    dst = (col_bits * c_pow[None, :]).sum(dim=1)
    return torch.stack([src, dst], dim=1).to(torch.int32)


def multi_variable_gaussian(rng, mean, cov, n_samples: int, *,
                            device=None) -> torch.Tensor:
    """Draw from N(mean, cov) (``random::multi_variable_gaussian``) via
    Cholesky (``torch.linalg.cholesky``)."""
    g = _key_of(rng, device)
    dev = g.device
    mean = torch.as_tensor(mean).to(device=dev, dtype=torch.float32)
    cov = torch.as_tensor(cov).to(device=dev, dtype=torch.float32)
    chol = torch.linalg.cholesky(cov)
    z = torch.randn((n_samples, mean.shape[0]), generator=g, device=dev)
    return mean[None, :] + z @ chol.T
