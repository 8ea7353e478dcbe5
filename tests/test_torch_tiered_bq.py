"""Tiered IVF-BQ in the port against the JAX package, on the CPU.

The JAX package builds the RaBitQ index (the rerank plane kept); its
arrays cross into the port with ``tiered.from_numpy_bq`` and a given
hot/cold split of the five record planes. The JAX side is driven through
its tiered *body* (``_tiered_bq_search_fn``, jitted) on the same planes
split with numpy, never through its tiered containers, and through its
all-device ``ivf_bq.search`` (the fused ``xla`` engine). The port's
tiered search equals its own all-device search bit for bit (ids,
distances). Against the JAX package, on integer-valued data, the ids are
equal and the exact distances agree to rtol 1e-5 plus 1e-6 (‖q‖² + max
‖x‖²), the tolerance ``tests/test_torch_ivf_bq.py`` states for the
expanded form ‖q‖² + ‖x‖² − 2<q, x> (on Gaussian data its cancellation
flips the order of near ties, ~1e-4 apart, between the packages).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_bq as j_bq
from raft_tpu.neighbors import tiered as j_tiered
from raft_tpu.ops.bq_scan import auto_query_bits as j_auto_query_bits
from raft_tpu_torch import Resources
from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.neighbors import ivf_bq, tiered
from raft_tpu_torch.ops import tier_scan

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N_LISTS, N, DIM = 16, 2500, 32
_FIELDS = ("centers", "rotation", "codes", "rnorm", "cfac", "errw",
           "indices", "list_sizes")
_PLANES = ("codes", "rnorm", "cfac", "errw", "data")

SPLITS = {
    "all-hot": (list(range(N_LISTS)), []),
    "half-cold": (list(range(8)), list(range(8, N_LISTS))),
    "alternate": (list(range(0, N_LISTS, 2)), list(range(1, N_LISTS, 2))),
    "all-cold": ([], list(range(N_LISTS))),
}

# (metric, bits, filter)
CASES = [("L2Expanded", 1, None), ("InnerProduct", 1, "shared"),
         ("L2SqrtExpanded", 2, "per_query"), ("L2Expanded", 3, "shared")]


@pytest.fixture(scope="module")
def data():
    """Clustered integer-valued rows and queries: every exact distance is
    an exact integer in both packages, so near ties cannot flip by the
    summation order and the ids are held exactly."""
    rng = np.random.default_rng(11)
    centers = rng.integers(-12, 13, (20, DIM))
    x = (centers[rng.integers(0, 20, N)]
         + rng.integers(-3, 4, (N, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 20, 30)]
         + rng.integers(-3, 4, (30, DIM))).astype(np.float32)
    return x, q


_JAX = {}


def _jax_index(x, metric: str, bits: int):
    key = (metric, bits)
    if key not in _JAX:
        _JAX[key] = j_bq.build(None, j_bq.IvfBqIndexParams(
            n_lists=N_LISTS, bits=bits, metric=JD[metric]), x)
    return _JAX[key]


def _fields(ji) -> dict:
    out = {f: np.asarray(getattr(ji, f)) for f in _FIELDS}
    out.update(metric=int(ji.metric), data=np.asarray(ji.data))
    return out


def _filter(kind, q, seed=3):
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    n_words = -(-N // 32)
    shape = (n_words,) if kind == "shared" else (q, n_words)
    return rng.integers(-2**31, 2**31, shape).astype(np.int32)


def _jax_tiered(ji, hot_lists, cold_lists, q, fw, *, n_probes, k,
                row_probes=None):
    """The JAX tiered body on numpy-split planes; an empty tier gets one
    block no slot map names (XLA cannot index a zero-length axis)."""
    hot_lists = np.asarray(hot_lists, np.int64)
    cold_lists = np.asarray(cold_lists, np.int64)
    hots, colds = [], []
    for name in _PLANES:
        plane = np.asarray(getattr(ji, name))
        hots.append(plane[hot_lists] if len(hot_lists) else plane[:1])
        colds.append(plane[cold_lists] if len(cold_lists) else plane[:1])
    hmap, cmap = tiered._slot_maps(hot_lists.astype(np.int32),
                                   cold_lists.astype(np.int32), N_LISTS)
    args = (jnp.asarray(q), ji.centers, ji.rotation,
            *map(jnp.asarray, hots), *map(jnp.asarray, colds),
            jnp.asarray(hmap), jnp.asarray(cmap), ji.indices, ji.data_norms,
            None if fw is None else jnp.asarray(fw))
    qb = j_auto_query_bits(int(ji.cfac.shape[2]))
    kw = dict(n_probes=n_probes, k=k, metric=ji.metric, scan_engine="xla",
              epsilon=3.0, query_bits=qb)
    if row_probes is None:
        return j_tiered._tiered_bq_search(*args, coarse_algo="exact", **kw)
    return j_tiered._tiered_bq_search_ragged_fn(
        args[0], jnp.asarray(row_probes), *args[1:], **kw)


def _close(got, jd, jix, x, q):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jix))
    scale = float((q * q).sum(axis=1).max() + (x * x).sum(axis=1).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_search_bq_equals_the_jax_body_and_all_device_search(data, case,
                                                             split):
    x, q = data
    metric, bits, filt = case
    ji = _jax_index(x, metric, bits)
    hot_lists, cold_lists = SPLITS[split]
    flat = ivf_bq.from_numpy(**_fields(ji), res=CPU)
    t = tiered.from_numpy_bq(_fields(ji), hot_lists, cold_lists, res=CPU)
    assert (t.n_hot, t.n_cold, t.bits) == (len(hot_lists), len(cold_lists),
                                           bits)
    fw = _filter(filt, q.shape[0])
    tfw = None if fw is None else torch.from_numpy(fw)
    sp = ivf_bq.IvfBqSearchParams(n_probes=5, scan_engine="torch")
    jd, jix = j_bq.search(None, j_bq.IvfBqSearchParams(
        n_probes=5, scan_engine="xla"), ji, q, 10,
        sample_filter=None if fw is None else jnp.asarray(fw))
    for epoch in range(3):
        got = tiered.search_bq(CPU, sp, t, q, 10, sample_filter=tfw)
        want = ivf_bq.search(CPU, sp, flat, q, 10, sample_filter=tfw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        _close(got, jd, jix, x, q)
        _close(got, *_jax_tiered(ji, t.hot_lists, t.cold_lists, q, fw,
                                 n_probes=5, k=10), x, q)
        assert (got[1] >= 0).sum() > 100
        if t.n_hot and t.n_cold:
            tiered.apply_plan(t, [int(t.cold_lists[epoch])],
                              [int(t.hot_lists[-1 - epoch])], width=1)


def test_rows_reranked_equal_the_all_device_scan(data):
    """The plain fused engine reads each probed list's five planes from
    its tier: the same survivors (rows reranked per query) as the
    all-device planes."""
    from raft_tpu_torch.ops.bq_scan import auto_query_bits, bq_list_major_scan

    x, q = data
    ji = _jax_index(x, "L2Expanded", 1)
    flat = ivf_bq.from_numpy(**_fields(ji), res=CPU)
    t = tiered.from_numpy_bq(_fields(ji), *SPLITS["alternate"], res=CPU)
    qf = torch.from_numpy(q)
    probes = ivf_bq.coarse_probes(flat, qf, 6)[0]
    qrot = qf @ flat.rotation.T
    crot = flat.centers @ flat.rotation.T
    kw = dict(k=10, metric=flat.metric, epsilon=3.0, engine="torch",
              query_bits=auto_query_bits(1))
    want = bq_list_major_scan(qf, qrot, crot, flat.codes, flat.rnorm,
                              flat.cfac, flat.errw, flat.indices, flat.data,
                              flat.data_norms, probes, **kw)
    hots, colds, hmap, cmap, _ = t.tier_planes()
    got = bq_list_major_scan(qf, qrot, crot, *hots[:4], t.indices, hots[4],
                             t.data_norms, probes, None, colds, hmap, cmap,
                             **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(RaftError, match="plain fused engine"):
        bq_list_major_scan(qf, qrot, crot, *hots[:4], t.indices, hots[4],
                           t.data_norms, probes, None, colds, hmap, cmap,
                           **dict(kw, engine="cuda"))


def test_ragged_body_and_executor_plans(data):
    x, q = data
    ji = _jax_index(x, "L2Expanded", 1)
    hot_lists, cold_lists = SPLITS["half-cold"]
    t = tiered.from_numpy_bq(_fields(ji), hot_lists, cold_lists, res=CPU)
    budgets = np.array([1, 4, 8, 8, 0, 3, 6, 2] * 2, np.int32)
    fn, arrays, static = tiered.serving_plan_bq(
        ivf_bq.IvfBqSearchParams(n_probes=8), t, 10)
    assert static["scan_engine"] == "torch"
    del static["coarse_algo"]
    got = tiered._tiered_bq_search_ragged_fn(
        torch.from_numpy(q[:16]), torch.from_numpy(budgets), *arrays, None,
        **static)
    _close(got, *_jax_tiered(ji, hot_lists, cold_lists, q[:16], None,
                             n_probes=8, k=10, row_probes=budgets), x,
           q[:16])
    assert (got[1][budgets == 0] == -1).all()
    sp = ivf_bq.IvfBqSearchParams(n_probes=5)
    want = tiered.search_bq(CPU, sp, t, q, 10)
    ex = SearchExecutor(CPU, probe_accounting=True, ragged_tile=32)
    served = ex.search(t, q, 10, params=sp)
    assert torch.equal(served[1], want[1])
    assert torch.equal(served[0], want[0])
    assert int(ex.probe_frequencies()[ex.probe_label(t)].sum()) == 30 * 5
    ragged = ex.search_ragged(t, [q[:4], q[4:11]], [10, 10],
                              params_list=[sp, sp])
    for (d, i), blk in zip(ragged, (q[:4], q[4:11])):
        solo = tiered.search_bq(CPU, sp, t, blk, 10)
        assert torch.equal(i, solo[1]) and torch.equal(d, solo[0])
    assert ex.ragged_executables("tiered_ivf_bq") == 1


def test_engines_and_build_rules(data):
    x, q = data
    ji = _jax_index(x, "L2Expanded", 1)
    flat = ivf_bq.from_numpy(**_fields(ji), res=CPU)
    for engine in ("auto", "cuda", "torch"):
        assert tier_scan.resolve_tier_bq_engine(engine) == "torch"
    with pytest.raises(RaftError, match="scan_engine"):
        tier_scan.resolve_tier_bq_engine("rank")
    t = tiered.build_tiered_bq(flat, hot_fraction=0.5)
    assert t.n_hot == N_LISTS // 2
    m = flat.max_list_size
    words = flat.codes.shape[2]
    assert t.block_bytes == m * (4 * words + 4 + 4 * t.bits + 4 + 4 * DIM)
    codes_only = ivf_bq.from_numpy(**{**_fields(ji), "data": None}, res=CPU)
    with pytest.raises(RaftError, match="store_vectors"):
        tiered.build_tiered_bq(codes_only)
    halves = ivf_bq.from_numpy(**_fields(ji), res=CPU)
    halves = type(halves)(**{**halves.__dict__,
                             "data": halves.data.to(torch.float16)})
    with pytest.raises(RaftError, match="f32"):
        tiered.build_tiered_bq(halves)
