"""The serving path on the card: ``SearchExecutor`` plans captured as CUDA
graphs and replayed, against eager plan entries and the direct searches.
A CUDA graph has no CPU mode, so every test here needs a CUDA device and
skips without one. The file imports no JAX: run it with ``--noconftest``
(tests/conftest.py imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_serving.py

Captured, eager and direct results must be equal bit for bit (ids and
distances) for brute force (both routes), IVF-Flat, IVF-BQ and CAGRA at
batches 1, 10, 500 and 4,097 (past the top bucket: tiled), and for the
tiered index, whose plans run eagerly on the card too. After warmup no
plan is captured again; two same-shape indexes served alternately by one
executor each get their own rows (the cache key holds the addresses a
graph bakes in); every replay adds its capture's kernel launches to the
wrappers' counters; a host sync inside a captured body raises. The ragged
plans: packed tiles of mixed budgets and k replay one captured graph per
tile and equal each request's bucketed replay bit for bit; a warmup
captures one graph per configured tile and traffic none; the tiered
ragged plan runs eagerly and matches; a host sync in a ragged body
raises at capture."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import executor
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_bq, ivf_flat
from raft_tpu_torch.neighbors import tiered
from raft_tpu_torch.ops.beam_search import beam_search
from raft_tpu_torch.ops.bq_scan import bq_list_major_scan
from raft_tpu_torch.ops.fused_topk import fused_knn
from raft_tpu_torch.ops.ivf_scan import list_major_scan

pytestmark = pytest.mark.cuda

N, D, N_LISTS, K = 20000, 64, 64, 10
BATCHES = (1, 10, 500, 4097)
FAMILIES = ("brute_force", "ivf_flat", "ivf_bq", "cagra", "tiered")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def res(dev):
    return Resources(device=dev)


@pytest.fixture(scope="module")
def data(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    centers = torch.randn(256, D, generator=g, device=dev) * 2
    lab = torch.randint(0, 256, (N + 4097,), generator=g, device=dev)
    pts = centers[lab] + torch.randn(N + 4097, D, generator=g, device=dev)
    return pts[:N].contiguous(), pts[N:].contiguous()


@pytest.fixture(scope="module")
def indexes(res, data):
    x, _ = data
    flat = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS),
                          x)
    return {
        "brute_force": brute_force.build(res, x),
        "ivf_flat": flat,
        "ivf_bq": ivf_bq.build(res, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS),
                               x),
        "cagra": cagra.build(res, cagra.CagraIndexParams(
            graph_degree=32, intermediate_graph_degree=64,
            build_algo=cagra.BuildAlgo.CLUSTER_JOIN), x),
        "tiered": tiered.build_tiered(flat, hot_fraction=0.5),
    }


def _params(name):
    return {"brute_force": None,
            "ivf_flat": ivf_flat.IvfFlatSearchParams(n_probes=16),
            "ivf_bq": ivf_bq.IvfBqSearchParams(n_probes=16),
            "cagra": cagra.CagraSearchParams(itopk_size=64,
                                             search_width=4),
            "tiered": tiered.TieredSearchParams(n_probes=16)}[name]


def _direct(res, name, index, q):
    p = _params(name)
    if name == "brute_force":
        return brute_force.search(res, index, q, K)
    mod = {"ivf_flat": ivf_flat, "ivf_bq": ivf_bq, "cagra": cagra,
           "tiered": tiered}[name]
    return mod.search(res, p, index, q, K)


def _equal(got, want, what):
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]), f"{what}: ids differ"
    assert torch.equal(got[0], want[0]), f"{what}: distances differ"


@pytest.mark.parametrize("name", FAMILIES)
def test_captured_eager_and_direct_equal(res, data, indexes, name):
    _, qs = data
    index, p = indexes[name], _params(name)
    cap = SearchExecutor(res)
    eager = SearchExecutor(res, capture=False)
    assert cap.capture and not eager.capture
    for b in BATCHES:
        q = qs[:b]
        want = _direct(res, name, index, q)
        _equal(cap.search(index, q, K, params=p), want, f"{name} b={b}")
        _equal(eager.search(index, q, K, params=p), want,
               f"{name} eager b={b}")
    costs = cap.executable_costs().values()
    captured = [c for c in costs if c["captured"]]
    if name == "tiered":
        assert not captured     # eager on the card: the staging plan
    else:
        # every captured plan launches a kernel, but brute force's scan
        # route (buckets past 512), which is plain PyTorch
        assert captured and all(c["launches"] >= 1 for c in captured
                                if c["family"] != "bf_scan")


@pytest.mark.parametrize("name", FAMILIES)
def test_zero_captures_after_warmup(res, data, indexes, name):
    _, qs = data
    index, p = indexes[name], _params(name)
    ex = SearchExecutor(res, max_bucket=512)
    ex.warmup(index, k=K, params=p)
    built = ex.stats.compile_count
    assert built == len(ex.buckets)
    rng = np.random.default_rng(1)
    for b in rng.integers(1, 513, 12):
        q = qs[:int(b)]
        _equal(ex.search(index, q, K, params=p), _direct(res, name, index, q),
               f"{name} b={b}")
    assert ex.stats.compile_count == built


@pytest.mark.parametrize("name", ["ivf_flat", "cagra"])
def test_zero_and_repeated_pad_rows_agree(res, data, indexes, name,
                                          monkeypatch):
    _, qs = data
    index, p = indexes[name], _params(name)
    edge = SearchExecutor(res)
    want = [edge.search(index, qs[:b], K, params=p) for b in (1, 10, 300)]
    pad = executor._pad
    monkeypatch.setattr(executor, "_pad",
                        lambda t, rows, mode: pad(t, rows, "zero"))
    zero = SearchExecutor(res)
    for b, w in zip((1, 10, 300), want):
        _equal(w, zero.search(index, qs[:b], K, params=p), f"{name} b={b}")


@pytest.mark.parametrize("metric", [m for m in DistanceType
                                    if m != DistanceType.Precomputed],
                         ids=lambda m: m.name)
def test_brute_force_every_metric_captured_equals_direct(res, data, metric):
    """Brute-force plans of every metric of the pairwise module: the
    fused route (its metrics, batch <= 512) and the tiled scan, captured,
    eager and direct equal bit for bit; the rows each metric is defined
    on (nonnegative sum-1 rows for KL, JensenShannon and Hellinger, 0/1
    rows for the binary metrics, 2-D (lat, lon) for Haversine)."""
    x, qs = data
    if metric in (DistanceType.KLDivergence, DistanceType.JensenShannon,
                  DistanceType.HellingerExpanded):
        x, qs = (t.abs() / t.abs().sum(1, keepdim=True) for t in (x, qs))
    elif metric in (DistanceType.JaccardExpanded, DistanceType.DiceExpanded,
                    DistanceType.RusselRaoExpanded,
                    DistanceType.HammingUnexpanded):
        x, qs = (x > 0).float(), (qs > 0).float()
    elif metric == DistanceType.Haversine:
        x, qs = x[:, :2].contiguous() * 0.3, qs[:, :2].contiguous() * 0.3
    index = brute_force.build(res, x, metric, 3.0)
    cap = SearchExecutor(res)
    eager = SearchExecutor(res, capture=False)
    for b in (10, 500, 600):
        q = qs[:b]
        want = brute_force.search(res, index, q, K)
        _equal(cap.search(index, q, K), want, f"{metric.name} b={b}")
        _equal(eager.search(index, q, K), want, f"{metric.name} eager b={b}")
    assert any(c["captured"] for c in cap.executable_costs().values())


@pytest.mark.parametrize("name", ["brute_force", "ivf_flat", "ivf_bq"])
def test_same_shape_indexes_keep_their_own_rows(res, data, indexes, name):
    """Two indexes of equal shapes, served alternately by one executor:
    each replay reads its own index (the key holds the graphs' baked-in
    addresses), and each index's result equals its direct search."""
    x, qs = data
    index, p = indexes[name], _params(name)
    shuffled = x[torch.randperm(N, device=x.device)].contiguous()
    if name == "brute_force":
        other = brute_force.build(res, shuffled)
    elif name == "ivf_flat":
        other = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS), shuffled)
    else:
        other = ivf_bq.build(res, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS),
                             shuffled)
    ex = SearchExecutor(res)
    q = qs[:10]
    for idx in (index, other, index, other):
        _equal(ex.search(idx, q, K, params=p), _direct(res, name, idx, q),
               name)
    assert ex.stats.compile_count == 2


@pytest.mark.parametrize("name,wrapper", [
    ("brute_force", fused_knn), ("ivf_flat", list_major_scan),
    ("ivf_bq", bq_list_major_scan), ("cagra", beam_search)])
def test_launches_counted_per_replay(res, data, indexes, name, wrapper):
    _, qs = data
    index, p = indexes[name], _params(name)
    ex = SearchExecutor(res)
    ex.warmup(index, buckets=(16,), k=K, params=p)
    before = wrapper.launches
    for _ in range(5):
        ex.search(index, qs[:12], K, params=p)
    (info,) = ex.executable_costs().values()
    assert info["launches"] >= 1
    assert wrapper.launches - before == 5 * info["launches"]


def test_probe_accounting_counts_in_the_graph(res, data, indexes):
    _, qs = data
    ex = SearchExecutor(res, probe_accounting=True)
    p = _params("ivf_flat")
    for _ in range(3):
        _equal(ex.search(indexes["ivf_flat"], qs[:13], K, params=p),
               _direct(res, "ivf_flat", indexes["ivf_flat"], qs[:13]),
               "accounting")
    (plane,) = ex.probe_frequencies().values()
    assert plane.sum() == 3 * 13 * 16
    assert ex.stats.compile_count == 1


def test_a_host_sync_in_a_captured_body_raises(res, data, indexes,
                                               monkeypatch):
    """The capture is the test of the repair: a body that reads the
    device on the host (here a boolean-mask index, as ``unique_lists``
    once did) fails to capture, and the executor raises. The failure
    leaves the thread's stream, the launch counts and the CUDA
    generator as they were: random draws and later captures work."""
    from raft_tpu_torch.ops import ivf_scan

    real = ivf_scan.unique_lists

    def synced(probes, n_lists):
        flat = probes.reshape(-1)
        flat[flat >= 0]          # data-dependent shape: a host sync
        return real(probes, n_lists)

    monkeypatch.setattr(ivf_scan, "unique_lists", synced)
    _, qs = data
    ex = SearchExecutor(res)
    stream = torch.cuda.current_stream()
    launches = list_major_scan.launches
    with pytest.raises(Exception):
        ex.search(indexes["ivf_flat"], qs[:10], K,
                  params=_params("ivf_flat"))
    torch.cuda.synchronize()
    assert torch.cuda.current_stream() == stream
    # the eager warm-up run launched the scan once; the capture adds none
    assert list_major_scan.launches == launches + 1
    assert torch.isfinite(torch.randn(64, device="cuda")).all()
    monkeypatch.setattr(ivf_scan, "unique_lists", real)
    _equal(ex.search(indexes["ivf_flat"], qs[:10], K,
                     params=_params("ivf_flat")),
           _direct(res, "ivf_flat", indexes["ivf_flat"], qs[:10]),
           "after a failed capture")


# -- the ragged plan family ---------------------------------------------------

RAGGED_TILE = 256
# per-request (n_probes or max_iterations, k) inside one params class:
# IVF n_probes 9..16 -> 16, CAGRA max_iterations 33..64 -> 64, k 10..16 -> 16
RAGGED_MIX = {"ivf_flat": ((16, 10), (12, 16), (9, 10), (14, 16)),
              "ivf_bq": ((16, 10), (12, 16), (9, 10), (14, 16)),
              "tiered": ((16, 10), (12, 16), (9, 10), (14, 16)),
              "cagra": ((40, 10), (64, 16), (33, 10), (48, 16))}


def _ragged_params(name, budget):
    if name == "cagra":
        return cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                       max_iterations=budget)
    return {"ivf_flat": ivf_flat.IvfFlatSearchParams,
            "ivf_bq": ivf_bq.IvfBqSearchParams,
            "tiered": tiered.TieredSearchParams}[name](n_probes=budget)


def _ragged_requests(qs, name, seed, n):
    """n requests of 1-40 rows at random offsets, each with one of the
    family's (budget, k) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        m = int(rng.integers(1, 41))
        at = int(rng.integers(0, qs.shape[0] - m))
        budget, k = RAGGED_MIX[name][j % len(RAGGED_MIX[name])]
        out.append((qs[at:at + m], k, _ragged_params(name, budget)))
    return out


@pytest.mark.parametrize("name", ["ivf_flat", "ivf_bq", "cagra"])
def test_ragged_replays_equal_bucketed_replays(res, data, indexes, name):
    """Packed tiles of mixed budgets and k, replayed from one captured
    graph, equal each request's own bucketed replay bit for bit; the one
    capture per tile happens at warmup, and 50 more packed dispatches
    capture nothing."""
    _, qs = data
    index = indexes[name]
    reqs = _ragged_requests(qs, name, 11, 50 * 4)
    ex = SearchExecutor(res, ragged_tile=RAGGED_TILE)
    ex.warmup_ragged(index, k=reqs[0][1], params=reqs[0][2])
    assert ex.stats.compile_count == 1 and ex.ragged_executables() == 1
    (cost,) = ex.executable_costs().values()
    assert cost["captured"] and cost["launches"] >= 1
    bucketed = SearchExecutor(res)
    want = [bucketed.search(index, q, k, params=p) for q, k, p in reqs]
    got = []
    for j in range(0, len(reqs), 4):
        group = reqs[j:j + 4]
        got += ex.search_ragged(index, [q for q, _, _ in group],
                                [k for _, k, _ in group],
                                params_list=[p for _, _, p in group])
    for j, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"{name} ragged request {j}")
    assert ex.stats.compile_count == 1


def test_ragged_dual_tile_captures_one_graph_per_tile(res, data, indexes):
    _, qs = data
    ex = SearchExecutor(res, ragged_tile=RAGGED_TILE, ragged_tile_small=64)
    p = _ragged_params("ivf_flat", 16)
    ex.warmup_ragged(indexes["ivf_flat"], k=K, params=p)
    costs = ex.executable_costs().values()
    assert sorted(c["bucket"] for c in costs) == [64, RAGGED_TILE]
    assert all(c["captured"] for c in costs)
    for rows in (5, 64, 65, 300):
        (got,) = ex.search_ragged(indexes["ivf_flat"], [qs[:rows]], K,
                                  params_list=p)
        _equal(got, SearchExecutor(res).search(indexes["ivf_flat"],
                                               qs[:rows], K, params=p),
               f"dual tile rows={rows}")
    assert ex.stats.compile_count == 2


def test_ragged_tiered_plan_runs_eagerly_and_matches(res, data, indexes):
    _, qs = data
    reqs = _ragged_requests(qs, "tiered", 12, 40)
    ex = SearchExecutor(res, ragged_tile=RAGGED_TILE)
    ex.warmup_ragged(indexes["tiered"], k=reqs[0][1], params=reqs[0][2])
    (cost,) = ex.executable_costs().values()
    assert not cost["captured"]
    for j in range(0, len(reqs), 4):
        group = reqs[j:j + 4]
        got = ex.search_ragged(indexes["tiered"], [q for q, _, _ in group],
                               [k for _, k, _ in group],
                               params_list=[p for _, _, p in group])
        for (q, k, p), g in zip(group, got):
            _equal(g, tiered.search(res, p, indexes["tiered"], q, k),
                   "tiered ragged")
    assert ex.stats.compile_count == 1


def test_ragged_launches_counted_per_replay(res, data, indexes):
    _, qs = data
    ex = SearchExecutor(res, ragged_tile=RAGGED_TILE)
    p = _ragged_params("ivf_bq", 16)
    ex.warmup_ragged(indexes["ivf_bq"], k=K, params=p)
    (info,) = ex.executable_costs().values()
    before = bq_list_major_scan.launches
    for rows in (3, 256, 300):       # 1 + 1 + 2 tiles
        ex.search_ragged(indexes["ivf_bq"], [qs[:rows]], K, params_list=p)
    assert bq_list_major_scan.launches - before == 4 * info["launches"]


def test_a_host_sync_in_a_ragged_body_raises(res, data, indexes,
                                             monkeypatch):
    """A host read in the ragged body (here on the budget plane, as a
    ``.item()`` would be) fails the capture, and the executor raises
    rather than running the plan eagerly."""
    from raft_tpu_torch.neighbors import ivf_flat as flat_mod

    real = flat_mod.ragged_probes

    def synced(probes, row_probes, n_lists):
        int(row_probes.max())     # a host sync
        return real(probes, row_probes, n_lists)

    monkeypatch.setattr(flat_mod, "ragged_probes", synced)
    _, qs = data
    ex = SearchExecutor(res, ragged_tile=RAGGED_TILE)
    p = _ragged_params("ivf_flat", 16)
    with pytest.raises(Exception):
        ex.search_ragged(indexes["ivf_flat"], [qs[:10]], K, params_list=p)
    torch.cuda.synchronize()
    assert ex.ragged_executables() == 0
    assert torch.isfinite(torch.randn(64, device="cuda")).all()
    monkeypatch.setattr(flat_mod, "ragged_probes", real)
    (got,) = ex.search_ragged(indexes["ivf_flat"], [qs[:10]], K,
                              params_list=p)
    _equal(got, _direct(res, "ivf_flat", indexes["ivf_flat"], qs[:10]),
           "after a failed ragged capture")
