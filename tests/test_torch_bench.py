"""The port's ANN benchmark harness (``raft_tpu_torch.bench``) against the
JAX package's (``raft_tpu.bench``) on the same inputs, on the CPU.

Datasets, configs, the two CPU competitors' files and the CSV export
must be byte for byte the JAX package's; recall must be equal where the
algorithm is deterministic (brute force, IVF-Flat probing every list,
hnswlib, the numpy IVF-Flat), and within 0.02 for the other IVF-Flat
entries (the two builds draw from different generators). Index caches
written by the JAX runner must serve the port's runner. The JAX
references are built once per module.
"""

from __future__ import annotations

import importlib
import json
import shutil

import numpy as np
import pytest
import torch

from raft_tpu.bench import datasets as j_ds
from raft_tpu.bench import hnsw_cpu as j_hnsw
from raft_tpu.bench import ivf_flat_cpu as j_ivfc
from raft_tpu.bench import runner as j_run
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu_torch.bench import datasets as t_ds
from raft_tpu_torch.bench import hnsw_cpu as t_hnsw
from raft_tpu_torch.bench import ivf_flat_cpu as t_ivfc
from raft_tpu_torch.bench import prims as t_prims
from raft_tpu_torch.bench import runner as t_run
from raft_tpu_torch.distance.types import DistanceType

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

t_main = importlib.import_module("raft_tpu_torch.bench.__main__").main

N, DIM, NQ, K = 600, 16, 40, 10
KINDS = ("random", "blobs")

# every family the runner can cross with the JAX runner's caches, plus
# brute force (exact) — small enough for the CPU
SWEEP = {"algos": [
    {"name": "raft_brute_force", "build": {}, "search": [{}]},
    {"name": "raft_ivf_flat", "build": {"n_lists": 16},
     "search": [{"n_probes": 4}, {"n_probes": 8}, {"n_probes": 16}]},
    {"name": "raft_cagra",
     "build": {"graph_degree": 16, "intermediate_graph_degree": 24,
               "build_algo": "cluster_join"},
     "search": [{"itopk_size": 32}]},
    {"name": "hnswlib", "build": {"M": 8, "ef_construction": 40},
     "search": [{"ef": 16}, {"ef": 64}]},
    {"name": "ivf_flat_cpu",
     "build": {"n_lists": 16, "train_iters": 5, "trainset_fraction": 0.5},
     "search": [{"n_probes": 2}, {"n_probes": 16}]},
]}
EXACT = {("raft_brute_force", None), ("raft_ivf_flat", 16),
         ("hnswlib", None), ("ivf_flat_cpu", None)}


# -- datasets -----------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(kind, metric) -> (JAX tree, port tree), made on first use."""
    root = tmp_path_factory.mktemp("trees")
    made = {}

    def get(kind, metric):
        if (kind, metric) not in made:
            kw = dict(n=N, dim=DIM, n_queries=NQ, k=K, metric=metric, seed=3,
                      kind=kind)
            made[kind, metric] = (
                j_ds.make_dataset(root / "jax", f"{kind}-{metric}", **kw),
                t_ds.make_dataset(root / "port", f"{kind}-{metric}",
                                  device="cpu", **kw))
        return made[kind, metric]
    return get


def _f64_dist(base, q, ids, metric):
    """float64 distances of rows ``ids`` from query ``q`` under ``metric``
    (the metric.txt name)."""
    x = base[ids].astype(np.float64)
    qq = q.astype(np.float64)
    if metric == "inner_product":
        return x @ qq
    if metric == "angular":
        return 1.0 - (x @ qq) / (np.linalg.norm(x, axis=1)
                                 * np.linalg.norm(qq))
    d2 = ((x - qq) ** 2).sum(axis=1)
    return np.sqrt(d2) if metric == "euclidean" else d2


@pytest.mark.parametrize("metric", sorted(t_ds.METRICS))
@pytest.mark.parametrize("kind", KINDS)
def test_make_dataset_matches_jax(trees, kind, metric):
    """Same draws, same files; ground truth equal but at float ties.

    A distance's tolerance is rtol 1e-5 plus four float32 units of
    |q|^2 + |x|^2 (the rounding of the expanded form both packages take,
    its products summed in other orders; euclidean compares squares);
    two ids at one slot are a tie when their float64 distances are
    within it."""
    from raft_tpu_torch.io import read_bin

    jroot, troot = trees(kind, metric)
    for name in ("base.fbin", "query.fbin", "metric.txt"):
        assert (troot / name).read_bytes() == (jroot / name).read_bytes(), name
    base = read_bin(troot / "base.fbin")
    queries = read_bin(troot / "query.fbin")
    ji = read_bin(jroot / "groundtruth.neighbors.ibin")
    ti = read_bin(troot / "groundtruth.neighbors.ibin")
    jd = read_bin(jroot / "groundtruth.distances.fbin").astype(np.float64)
    td = read_bin(troot / "groundtruth.distances.fbin").astype(np.float64)
    assert ti.shape == ji.shape == (NQ, K)
    room = 4 * 2.0 ** -24 * ((queries.astype(np.float64) ** 2).sum(1)[:, None]
                             + (base[ji].astype(np.float64) ** 2).sum(-1))
    if metric == "angular":
        room = 4 * 2.0 ** -24 * np.ones_like(jd)
    sq = metric == "euclidean"
    want = jd ** 2 if sq else jd
    tol = 1e-5 * np.abs(want) + room
    assert (np.abs((td ** 2 if sq else td) - want) <= tol).all()
    for r, c in zip(*np.nonzero(ti != ji)):
        a, b = _f64_dist(base, queries[r], [ti[r, c], ji[r, c]], metric)
        if sq:
            a, b = a * a, b * b
        assert abs(a - b) <= tol[r, c], (kind, metric, r, c)


def test_entry_points_default_to_the_card(tmp_path):
    """No card and no ``device="cpu"``: the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        t_ds.make_dataset(tmp_path, "x", n=50, dim=4, n_queries=2, k=2)
    with pytest.raises(RuntimeError, match="cuda"):
        t_prims.run_prims("tiny", name_filter="norm_rows", budget_s=0.01)
    with pytest.raises(RuntimeError, match="cuda"):
        t_run.run_benchmark(tmp_path / "x", SWEEP, tmp_path / "out")


# -- configs and cache keys ---------------------------------------------------


def _bundled():
    port = sorted((t_run.pathlib.Path(t_run.__file__).parent / "conf")
                  .glob("*.json"))
    assert len(port) == 15
    return port


@pytest.mark.parametrize("path", _bundled(), ids=lambda p: p.stem)
def test_bundled_configs_equal_jax(path):
    jpath = (j_run.pathlib.Path(j_run.__file__).parent / "conf" / path.name)
    assert path.read_bytes() == jpath.read_bytes()
    cfg = json.loads(path.read_text())
    assert t_run.normalize_config(cfg) == j_run.normalize_config(cfg)


def test_reference_schema_normalizes_as_jax():
    cfg = {"index": [
        {"algo": "raft_bfknn", "build_param": {}, "search_params": [{}]},
        {"algo": "raft_ivf_flat", "build_param": {"nlist": 64, "ratio": 4,
                                                  "niter": 5},
         "search_params": [{"nprobe": 8}, {"nprobe": 16, "junk": 1}]},
        {"algo": "raft_cagra",
         "build_param": {"graph_degree": 32, "graph_build_algo": "NN_DESCENT"},
         "search_params": [{"itopk": 64, "search_width": 2}]},
        {"algo": "hnswlib", "build_param": {"M": 12, "efConstruction": 100},
         "search_params": [{"ef": 10}]},
        {"algo": "faiss_gpu_ivf_flat", "build_param": {"nlist": 8}},
    ]}
    assert t_run.normalize_config(cfg) == j_run.normalize_config(cfg)
    for bad in ({}, {"index": [{"algo": "ggnn"}]}):
        with pytest.raises(ValueError):
            t_run.normalize_config(bad)
        with pytest.raises(ValueError):
            j_run.normalize_config(bad)
    assert set(t_run.ALGO_REGISTRY) == set(j_run.ALGO_REGISTRY)


@pytest.mark.parametrize("args", [
    ("raft_ivf_flat", "sift-128", 1000, 128, "euclidean", {"n_lists": 64}),
    ("raft_cagra", "my data/v2", 7, 3, "angular",
     {"graph_degree": 32, "build_algo": "NN_DESCENT", "x": 0.5}),
    ("hnswlib", "d", 10, 2, "inner_product",
     {"ef_construction": 200, "M": 16}),
    ("ivf_flat_cpu", "blobs-100000-128", 100000, 128, "sqeuclidean", {}),
])
def test_index_cache_key_equals_jax(args):
    assert t_run._index_cache_key(*args) == j_run._index_cache_key(*args)


# -- the CPU competitors ------------------------------------------------------


@pytest.fixture(scope="module")
def competitor_data():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((800, 24)).astype(np.float32)
    q = rng.standard_normal((30, 24)).astype(np.float32)
    return x, q


_COMPETITOR_METRICS = ("L2Expanded", "L2SqrtExpanded", "InnerProduct")


@pytest.mark.parametrize("metric", _COMPETITOR_METRICS)
def test_hnsw_cpu_equals_jax(competitor_data, metric, tmp_path):
    x, q = competitor_data
    assert t_hnsw.available() and j_hnsw.available()
    ti = t_hnsw.build(x, DistanceType[metric], M=8, ef_construction=40)
    ji = j_hnsw.build(x, JD[metric], M=8, ef_construction=40)
    td, tid = t_hnsw.search(ti, q, 10, ef=32)
    jd, jid = j_hnsw.search(ji, q, 10, ef=32)
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_array_equal(td, jd)
    t_hnsw.save(ti, tmp_path / "t.bin")
    j_hnsw.save(ji, tmp_path / "j.bin")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    back = t_hnsw.load(tmp_path / "j.bin", x.shape[1], DistanceType[metric])
    np.testing.assert_array_equal(t_hnsw.search(back, q, 10, ef=32)[1], jid)


@pytest.mark.parametrize("metric", _COMPETITOR_METRICS)
def test_ivf_flat_cpu_equals_jax(competitor_data, metric, tmp_path):
    x, q = competitor_data
    ti = t_ivfc.build(x, DistanceType[metric], n_lists=12, train_iters=4,
                      trainset_fraction=0.5)
    ji = j_ivfc.build(x, JD[metric], n_lists=12, train_iters=4,
                      trainset_fraction=0.5)
    for p in (1, 3, 12):
        td, tid = t_ivfc.search(ti, q, 10, n_probes=p)
        jd, jid = j_ivfc.search(ji, q, 10, n_probes=p)
        np.testing.assert_array_equal(tid, jid)
        np.testing.assert_array_equal(td, jd)
    t_ivfc.save(ti, tmp_path / "t.bin")
    j_ivfc.save(ji, tmp_path / "j.bin")
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    back = t_ivfc.load(tmp_path / "j.bin", x.shape[1], DistanceType[metric])
    np.testing.assert_array_equal(t_ivfc.search(back, q, 10, n_probes=3)[1],
                                  j_ivfc.search(ji, q, 10, n_probes=3)[1])


# -- the runner ---------------------------------------------------------------


def _combo(row):
    return (row["algo"], json.dumps(row["build_params"], sort_keys=True),
            json.dumps(row["search_params"], sort_keys=True))


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """One tiny blobs tree swept by both runners, then the port's runner
    on a copy of the JAX runner's index caches."""
    root = tmp_path_factory.mktemp("sweep")
    data = j_ds.make_dataset(root, "tiny", n=N, dim=DIM, n_queries=NQ, k=K,
                             seed=5, kind="blobs")
    jrows = j_run.run_benchmark(data, SWEEP, root / "jax", k=K,
                                search_iters=1)
    trows = t_run.run_benchmark(data, SWEEP, root / "port", k=K,
                                search_iters=1, device="cpu")
    shutil.copytree(root / "jax" / "indexes", root / "cached" / "indexes")
    crows = t_run.run_benchmark(data, SWEEP, root / "cached", k=K,
                                search_iters=1, device="cpu",
                                require_cached_index=True)
    return dict(root=root, data=data, jax=jrows, port=trows, cached=crows)


def test_runner_rows_match_jax(sweep):
    jrows, trows = sweep["jax"], sweep["port"]
    assert [_combo(r) for r in trows] == [_combo(r) for r in jrows]
    for t, j in zip(trows, jrows):
        assert set(t) == set(j)
        assert t["backend"] == "cpu" and not t["build_cached"]
        key = (t["algo"], t["search_params"].get("n_probes")
               if t["algo"] == "raft_ivf_flat" else None)
        if key in EXACT:
            assert t["recall"] == j["recall"], (t, j)
        elif t["algo"] == "raft_ivf_flat":
            assert abs(t["recall"] - j["recall"]) <= 0.02, (t, j)
        assert t["recall"] > 0.5


def test_jax_caches_serve_the_port(sweep):
    """Every cached family (IVF-Flat, CAGRA, hnswlib, numpy IVF-Flat)
    loads from the JAX runner's file and gives the JAX row's recall."""
    cached = {_combo(r): r for r in sweep["cached"]}
    seen = set()
    for j in sweep["jax"]:
        if j["algo"] == "raft_brute_force":
            continue
        c = cached[_combo(j)]
        assert c["build_cached"], c
        assert c["recall"] == j["recall"], (c, j)
        seen.add(j["algo"])
    assert seen == {"raft_ivf_flat", "raft_cagra", "hnswlib", "ivf_flat_cpu"}


def test_export_csv_equals_jax(sweep, tmp_path):
    shutil.copy(sweep["root"] / "jax" / "results.jsonl", tmp_path)
    t = t_run.export_csv(tmp_path, tmp_path / "t.csv")
    j = j_run.export_csv(tmp_path, tmp_path / "j.csv")
    assert t.read_text() == j.read_text()
    assert len(t.read_text().splitlines()) == len(sweep["jax"]) + 1


def test_resume_skips_only_rows_of_the_same_backend(sweep, tmp_path):
    config = {"algos": [SWEEP["algos"][0], SWEEP["algos"][4]]}
    first = t_run.run_benchmark(sweep["data"], config, tmp_path, k=K,
                                search_iters=1, device="cpu")
    assert len(first) == 3
    # the brute-force row as if measured on the card: not this sweep's
    lines = (tmp_path / "results.jsonl").read_text().splitlines()
    rows = [json.loads(line) for line in lines]
    rows[0]["backend"] = "cuda"
    (tmp_path / "results.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    again = t_run.run_benchmark(sweep["data"], config, tmp_path, k=K,
                                search_iters=1, device="cpu", resume=True)
    assert [_combo(r) for r in again] == [_combo(r) for r in first[1:]] + [
        _combo(first[0])]
    on_disk = [json.loads(line) for line in
               (tmp_path / "results.jsonl").read_text().splitlines()]
    assert [r["backend"] for r in on_disk] == ["cuda", "cpu", "cpu", "cpu"]


def test_force_rebuild_with_require_cached_index_raises(sweep, tmp_path):
    with pytest.raises(ValueError, match="contradictory"):
        t_run.run_benchmark(sweep["data"], SWEEP, tmp_path, device="cpu",
                            force_rebuild=True, require_cached_index=True)
    with pytest.raises(RuntimeError, match="require_cached_index"):
        t_run.run_benchmark(sweep["data"], {"algos": [SWEEP["algos"][1]]},
                            tmp_path, device="cpu", search_iters=1,
                            require_cached_index=True)


def test_cli_round_trip(tmp_path, capsys):
    """get-dataset -> run -> data-export -> plot through ``main(argv)``."""
    assert t_main(["get-dataset", "--kind", "random", "--n", "300", "--dim",
                   "8", "--n-queries", "5", "--k", "10", "--out-dir",
                   str(tmp_path / "ds"), "--device", "cpu"]) == 0
    tree = tmp_path / "ds" / "random-300-8"
    assert tree.is_dir()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"algos": [
        SWEEP["algos"][0], SWEEP["algos"][4]]}))
    capsys.readouterr()
    assert t_main(["run", "--dataset", str(tree), "--config", str(cfg),
                   "--out-dir", str(tmp_path / "res"), "-k", "5",
                   "--batch-size", "2", "--search-iters", "1",
                   "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines()]
    assert [r["algo"] for r in rows] == ["raft_brute_force", "ivf_flat_cpu",
                                         "ivf_flat_cpu"]
    assert rows[0]["recall"] == 1.0 and rows[0]["batch_size"] == 2
    assert all(r["backend"] == "cpu" for r in rows)
    assert t_main(["data-export", "--results", str(tmp_path / "res")]) == 0
    assert (tmp_path / "res" / "results.csv").exists()
    pytest.importorskip("matplotlib")
    assert t_main(["plot", "--results", str(tmp_path / "res")]) == 0
    png = (tmp_path / "res" / "recall_vs_qps.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit):
        t_main(["run", "--dataset", str(tree), "--config", "no-such-conf"])


# -- the per-primitive suite --------------------------------------------------


def test_prims_run_every_case_on_the_cpu():
    from raft_tpu.bench import prims as j_prims

    want_keys = set(j_prims.run_prims("tiny", "norm_rows", 0.01)[0])
    recs = t_prims.run_prims("tiny", budget_s=0.01, device="cpu")
    assert [r["prim"] for r in recs] == [p.name for p in j_prims._REGISTRY]
    assert len(recs) == 21
    for r in recs:
        assert "error" not in r, r
        assert set(r) == want_keys, r
        assert r["backend"] == "cpu" and r["ms"] > 0


def test_prims_peaks_are_the_cards():
    """The H100 SXM data sheet's figures, not another chip's."""
    assert t_prims.PEAK_BW == 3.35e12
    assert t_prims.PEAK_FLOPS == 989.4e12
