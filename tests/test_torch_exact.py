"""The port's shared exact-distance helpers (``neighbors/_exact``) against
the JAX package's. The dedup mask is integer logic: equal. Distances on
integer-valued data are exact in both (equal); on Gaussian data the
products are summed in other orders: rtol 1e-5."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import _exact as j_exact
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import _exact as t_exact

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_candidate_mask_equals_jax(seed):
    rng = np.random.default_rng(seed)
    cand = rng.integers(-1, 30, (9, 48)).astype(np.int32)
    buf = rng.integers(-2, 30, (9, 20)).astype(np.int32)
    buf[:, 15:] = -2                            # dead slots
    want = np.asarray(j_exact.dedup_candidate_mask(jnp.asarray(cand),
                                                   jnp.asarray(buf)))
    got = t_exact.dedup_candidate_mask(torch.from_numpy(cand),
                                       torch.from_numpy(buf))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("integer", [True, False], ids=["int", "gauss"])
def test_gathered_distances_matches_jax(metric, integer):
    rng = np.random.default_rng(3)
    if integer:
        x = rng.integers(-5, 6, (300, 40)).astype(np.float32)
        q = rng.integers(-5, 6, (12, 40)).astype(np.float32)
    else:
        x = rng.standard_normal((300, 40)).astype(np.float32)
        q = rng.standard_normal((12, 40)).astype(np.float32)
    cand = rng.integers(-1, 300, (12, 25)).astype(np.int32)
    want = np.asarray(j_exact.gathered_distances(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(cand), JD(int(metric))))
    got = t_exact.gathered_distances(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(cand),
        metric).numpy()
    np.testing.assert_array_equal(np.isinf(got), cand < 0)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        fin = cand >= 0
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)
