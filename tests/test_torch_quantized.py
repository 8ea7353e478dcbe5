"""The port's int8 scalar-quantized kNN against
``raft_tpu.neighbors.quantized``: the affine quantizer and codes, the
search through the int32 Gram product and the affine expansion, ``knn``
and the file both ways. The parity data are integers spanning exactly
[-127, 127], so the quantizer's scale is 1 and its zero 0: every code is
its value and every squared distance an exact integer in both packages
(ids equal; distances to rtol 1e-6: XLA's CPU sqrt is an ulp off on a
few inputs); the recall check runs on Gaussian data."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import quantized as j_q
from raft_tpu_torch import Resources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import quantized as t_q

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
METRICS = ("L2Expanded", "L2SqrtExpanded", "InnerProduct")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    centers = rng.standard_normal((12, 24)) * 3
    x = (centers[rng.integers(0, 12, 2000)]
         + rng.standard_normal((2000, 24))).astype(np.float32)
    q = (centers[rng.integers(0, 12, 40)]
         + rng.standard_normal((40, 24))).astype(np.float32)
    return x, q


@pytest.mark.parametrize("metric", METRICS)
def test_build_and_search_equal_reference(metric):
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (2000, 24)).astype(np.float32)
    x[0, 0], x[1, 1] = -127.0, 127.0
    q = rng.integers(-127, 128, (40, 24)).astype(np.float32)
    ji = j_q.build(None, x, JD[metric])
    ti = t_q.build(CPU, x, DistanceType[metric])
    assert ti.scale == ji.scale and ti.zero == ji.zero
    np.testing.assert_array_equal(np.asarray(ji.codes), ti.codes.numpy())
    np.testing.assert_array_equal(np.asarray(ji.row_sums),
                                  ti.row_sums.numpy())
    for tile in (32768, 300):
        jd, jix = j_q.search(None, ji, q, 10, db_tile=tile)
        td, tix = t_q.search(CPU, ti, q, 10, db_tile=tile)
        np.testing.assert_array_equal(np.asarray(jix), tix.numpy())
        np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-6)


def test_knn_recall_and_file_both_ways(data):
    x, q = data
    d, i = t_q.knn(CPU, x, q, 10)
    truth = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(i.numpy(), truth)])
    assert recall >= 0.95
    ti = t_q.build(CPU, x, DistanceType.InnerProduct)
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    j_q.save(j_q.build(None, x, JD.InnerProduct), jbuf)
    t_q.save(ti, tbuf)
    assert jbuf.getvalue() == tbuf.getvalue()
    back = t_q.load(CPU, io.BytesIO(jbuf.getvalue()))
    assert torch.equal(back.codes, ti.codes) and back.metric == ti.metric
    with pytest.raises(Exception, match="k must be"):
        t_q.search(CPU, ti, q, 0)
