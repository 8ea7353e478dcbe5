"""The port's plain ``fused_knn`` against the JAX package's Pallas kernel
(``raft_tpu.ops.fused_topk.fused_knn``, interpret mode) on the same
inputs, for all six metrics; and the plain ``stream_read_sum`` against
the JAX package's ``stream_read_sum`` (interpret mode).

Tolerances: on integer-valued inputs every product and sum is exact in
any order, so ids must be EXACTLY equal (smallest id first on ties,
duplicates and zero distances included) and distances equal to float32
rounding of the epilog (rtol 1e-6). The +-1 inputs give every row the
same norm, so cosine orders by the exact inner product alone (XLA's
rsqrt on the CPU is not correctly rounded, so cosine values of rows with
other norms can differ by one ulp between the packages). On Gaussian
inputs distances agree to rtol 1e-5 / atol 1e-4 x scale, and ids are
equal except where neighbouring distances lie within that tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.ops.fused_topk import fused_knn as j_fused_knn
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.ops.fused_topk import (
    finish,
    fused_knn,
    fused_knn_plain,
    min_space_distances,
    split_tf32_ip,
    stream_read_sum,
    stream_read_sum_plain,
    tf32_round,
)

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

METRICS = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
           DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
           DistanceType.InnerProduct, DistanceType.CosineExpanded]
N, D = 301, 24           # ragged n: not a multiple of the 128-row tile


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _reference(q, x, k, metric):
    d, i = j_fused_knn(q, x, k, JD(int(metric)), tile=128, interpret=True)
    return np.asarray(d), np.asarray(i)


def _port(q, x, k, metric):
    d, i = fused_knn(torch.from_numpy(q), torch.from_numpy(x), k, metric)
    return d.numpy(), i.numpy()


@pytest.fixture(scope="module")
def pm1_data():
    rng = np.random.default_rng(0)
    x = _pm1(rng, (N, D))
    x[150] = x[7]                 # duplicates: the smallest id must win
    x[300] = x[7]
    q = _pm1(rng, (9, D))
    q[0] = x[7]                   # distance 0 to three rows
    return q, x


@pytest.mark.parametrize("k", [1, 7, 32])
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_integer_inputs_ids_exact(pm1_data, metric, k):
    q, x = pm1_data
    wd, wi = _reference(q, x, k, metric)
    gd, gi = _port(q, x, k, metric)
    assert np.array_equal(gi, wi)
    # cosine: one ulp of XLA's rsqrt around 1 (e.g. -3e-8 against 0)
    np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-6)
    if metric in (DistanceType.L2Expanded, DistanceType.L2Unexpanded):
        assert gd[0, 0] == 0
        assert list(gi[0, :3]) == [7, 150, 300][:k]


def test_small_integer_inputs_l2_ids_exact():
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 4, (N, D)).astype(np.float32)
    q = rng.integers(-3, 4, (11, D)).astype(np.float32)
    wd, wi = _reference(q, x, 16, DistanceType.L2Expanded)
    gd, gi = _port(q, x, 16, DistanceType.L2Expanded)
    assert np.array_equal(gi, wi)
    assert np.array_equal(gd, wd)


def _agree_within_tolerance(gd, gi, wd, wi, scale):
    tol = 1e-4 * scale
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=tol)
    # an id may differ only where the reference's neighbouring
    # distances lie within the tolerance (a near tie)
    for r, c in zip(*np.nonzero(gi != wi)):
        near = np.abs(wd[r] - wd[r, c]) <= tol + 1e-5 * abs(wd[r, c])
        assert near.sum() >= 2, (r, c)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_gaussian_inputs_within_tolerance(metric):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((7, D)).astype(np.float32)
    wd, wi = _reference(q, x, 10, metric)
    gd, gi = _port(q, x, 10, metric)
    _agree_within_tolerance(gd, gi, wd, wi, scale=2.0 * D)


def test_bf16_dataset_matches_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)   # exact in bf16
    q = rng.standard_normal((5, D)).astype(np.float32)   # rounds to bf16
    wd, wi = j_fused_knn(q, jnp.asarray(x, jnp.bfloat16), 8, JD.L2Expanded,
                         tile=128, interpret=True)
    gd, gi = fused_knn(torch.from_numpy(q),
                       torch.from_numpy(x).to(torch.bfloat16), 8,
                       DistanceType.L2Expanded)
    _agree_within_tolerance(gd.numpy(), gi.numpy(), np.asarray(wd),
                            np.asarray(wi), scale=2.0 * 16 * D)


def test_precomputed_norms_and_cpu_dispatch():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-3, 4, (N, D)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-3, 4, (6, D)).astype(np.float32))
    norms = (x * x).sum(dim=1)
    a = fused_knn(q, x, 5, dataset_norms=norms)
    b = fused_knn_plain(q, x, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_rejects_bad_arguments():
    x = torch.zeros((10, 4))
    with pytest.raises(RaftError):
        fused_knn(torch.zeros((2, 4)), x, 11)
    with pytest.raises(RaftError):
        fused_knn(torch.zeros((2, 5)), x, 3)
    with pytest.raises(RaftError):
        fused_knn(torch.zeros((2, 4)), x, 3, DistanceType.L1)


@pytest.mark.parametrize("shape", [(1, 128), (37, 100), (300, 128),
                                   (1000, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_read_sum_plain_matches_reference(dtype, shape):
    """Column sums against the JAX package's Pallas ``stream_read_sum`` in
    interpret mode, ragged shapes included. Integer-valued data: every
    partial sum is an integer below 2^24, so both are exact in any order
    and equal; on Gaussian data they agree to float32 rounding of the
    sums (the orders differ)."""
    import jax.numpy as jnp

    from raft_tpu.ops.fused_topk import stream_read_sum as j_stream

    rng = np.random.default_rng(sum(shape))
    for x, exact in ((rng.integers(-8, 9, shape).astype(np.float32), True),
                     (rng.standard_normal(shape).astype(np.float32), False)):
        want = np.asarray(j_stream(jnp.asarray(x, getattr(jnp, dtype)),
                                   interpret=True))
        got = stream_read_sum_plain(
            torch.from_numpy(x).to(getattr(torch, dtype)))
        assert got.dtype == torch.float32 and got.shape == (1, shape[1])
        if exact:
            assert np.array_equal(got.numpy(), want)
        else:
            scale = np.abs(x).sum(axis=0, keepdims=True)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=float(scale.max()) * 1e-6)


def test_stream_read_sum_cpu_dispatch_and_checks():
    x = torch.arange(12.0).reshape(4, 3)
    before = stream_read_sum.launches
    assert torch.equal(stream_read_sum(x), torch.tensor([[18.0, 22.0, 26.0]]))
    assert stream_read_sum.launches == before
    with pytest.raises(RaftError):
        stream_read_sum(torch.zeros(5))


# ---------------------------------------------------------------------------
# the kernel's float32 product: the 3xTF32 split (plain model)
# ---------------------------------------------------------------------------

F64_BOUND = 4e-6   # |d - d64| / (|q|^2 + |x|^2), the card tests' bound


def _bound_data(kind: str, shape_q=(256, 128), shape_x=(8192, 128)):
    rng = np.random.default_rng(11)
    q = rng.standard_normal(shape_q)
    x = rng.standard_normal(shape_x)
    if kind == "offset":          # large norms, as SIFT's
        q, x = q + 10.0, x + 10.0
    return q.astype(np.float32), x.astype(np.float32)


def _relative_error(ip: torch.Tensor, q: np.ndarray, x: np.ndarray) -> float:
    """max |d - d64| / (|q|^2 + |x|^2) of the L2 distances the kernel's
    float32 epilog makes from ``ip`` (norms in float32, as _prepare
    computes them) against float64 distances."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    qn64 = (q64 * q64).sum(1)[:, None]
    xn64 = (x64 * x64).sum(1)[None, :]
    d64 = qn64 + xn64 - 2.0 * (q64 @ x64.T)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    d = min_space_distances(ip, (qt * qt).sum(1), (xt * xt).sum(1),
                            DistanceType.L2Expanded)
    return float((np.abs(d.double().numpy() - d64) / (qn64 + xn64)).max())


def test_tf32_round_is_rna():
    """To nearest with ties away from zero at 10 explicit mantissa bits;
    small integers and values already in TF32 are unchanged."""
    one = 1.0
    cases = {one + 2.0 ** -11: one + 2.0 ** -10,      # a tie: away
             one + 2.0 ** -12: one,                   # under half: down
             one + 3 * 2.0 ** -12: one + 2.0 ** -10,  # over half: up
             -(one + 2.0 ** -11): -(one + 2.0 ** -10),
             1234.0: 1234.0, -7.0: -7.0, 0.0: 0.0}
    got = tf32_round(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    r = tf32_round(x)
    assert bool((r.view(torch.int32) & 0x1FFF == 0).all())
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("kind", ["gaussian", "offset"])
def test_split_tf32_within_float64_bound(kind):
    q, x = _bound_data(kind)
    ip = split_tf32_ip(torch.from_numpy(q), torch.from_numpy(x))
    assert _relative_error(ip, q, x) <= F64_BOUND


@pytest.mark.parametrize("kind", ["gaussian", "offset"])
def test_one_tf32_pass_misses_the_float64_bound(kind):
    """The bound has teeth: one TF32 pass (both operands rounded, float32
    sums) misses it on the same data."""
    q, x = _bound_data(kind)
    ip = tf32_round(torch.from_numpy(q)) @ tf32_round(torch.from_numpy(x)).T
    assert _relative_error(ip, q, x) > F64_BOUND


def test_split_tf32_is_exact_on_small_integers():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-8, 9, (17, 96)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-8, 9, (300, 96)).astype(np.float32))
    assert torch.equal(split_tf32_ip(q, x), q @ x.T)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("kind", ["gaussian", "offset"])
def test_split_tf32_knn_matches_reference(kind, metric):
    """kNN over the model's products (the kernel's epilog, a stable sort,
    the shared final step) against the JAX package's kernel in interpret
    mode on the same numpy inputs."""
    q, x = _bound_data(kind, (7, D), (N, D))
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    dist = min_space_distances(split_tf32_ip(qt, xt), (qt * qt).sum(1),
                               (xt * xt).sum(1), metric)
    sd, pos = torch.sort(dist, dim=1, stable=True)
    gd, gi = finish(sd[:, :10], pos[:, :10].to(torch.int32), metric)
    wd, wi = _reference(q, x, 10, metric)
    scale = float(2.0 * np.abs(x).max() ** 2 * D)
    _agree_within_tolerance(gd.numpy(), gi.numpy(), wd, wi, scale=scale)
