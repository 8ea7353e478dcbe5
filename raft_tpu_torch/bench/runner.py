"""Benchmark orchestration — analog of ``raft-ann-bench/run``
(``run/__main__.py:48-120``): an algorithm registry (the ``algos.yaml``
role), JSON param-sweep configs, build+search timing, recall against
groundtruth, and JSON-lines results the exporter/plotter consume.

The reference shells out to gbench executables; here algorithms are
in-process wrappers over the framework APIs (``bench/ann/src/common/
ann_types.hpp:79`` ``ANN<T>`` interface analog). Port of
``raft_tpu/bench/runner.py``: the wrappers take a
:class:`~raft_tpu_torch.Resources` on the run's device (``"cuda"`` by
default) where the JAX package passes ``None``; the base and query sets
are placed on the device once, so the timed loop holds searches only;
a row's ``backend`` is the torch device type (``"cuda"``/``"cpu"``), and
completion is anchored on a ``torch.cuda.synchronize`` plus a
one-element fetch. The index cache's file names and files are the JAX
runner's, so a cache written by either package serves the other.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from raft_tpu_torch.bench.datasets import METRICS
from raft_tpu_torch.core.logger import warn as _log_warn
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.io import read_bin
from raft_tpu_torch.utils.recall import eval_recall


@dataclasses.dataclass
class AlgoWrapper:
    """The ``ANN<T>`` interface (``ann_types.hpp:79-93``): build once,
    search per search-param set. ``save``/``load`` (optional) enable the
    reference harness's build/search separation with on-disk index files
    (``benchmark.hpp`` build phase saves, search phase loads) — a rerun
    on the same dataset+build-params reloads instead of rebuilding.
    ``host`` marks a CPU competitor: it takes and returns numpy arrays
    and ignores the handle."""

    name: str
    build: Callable[..., Any]     # (res, base, metric, **params) -> index
    search: Callable[..., Any]    # (res, index, queries, k, **params) -> (d, i)
    save: Callable[..., None] = None   # (index, path)
    load: Callable[..., Any] = None    # (res, path, base, metric, **params)
    host: bool = False


def _brute_force_build(res, base, metric, **params):
    from raft_tpu_torch.neighbors import brute_force

    return brute_force.build(res, base, metric)


def _brute_force_search(res, index, queries, k, **params):
    from raft_tpu_torch.neighbors import brute_force

    return brute_force.search(res, index, queries, k)


def _ivf_flat_build(res, base, metric, *, n_lists=1024, **params):
    from raft_tpu_torch.neighbors import ivf_flat

    p = ivf_flat.IvfFlatIndexParams(n_lists=n_lists, metric=metric, **params)
    return ivf_flat.build(res, p, base)


def _ivf_flat_search(res, index, queries, k, *, n_probes=32, **params):
    from raft_tpu_torch.neighbors import ivf_flat

    p = ivf_flat.IvfFlatSearchParams(n_probes=n_probes, **params)
    return ivf_flat.search(res, p, index, queries, k)


def _ivf_pq_build(res, base, metric, *, n_lists=1024, pq_dim=0, pq_bits=8,
                  **params):
    from raft_tpu_torch.neighbors import ivf_pq

    p = ivf_pq.IvfPqIndexParams(n_lists=n_lists, pq_dim=pq_dim,
                                pq_bits=pq_bits, metric=metric, **params)
    # keep the raw dataset alongside: the refine re-ranking pass needs it
    # (the reference's bench wrapper does the same for refine_ratio > 1)
    return {"index": ivf_pq.build(res, p, base), "base": base,
            "metric": metric}


def _search_with_refine(search_fn, res, bundle, queries, k, params,
                        refine_ratio):
    """Shared over-fetch + exact re-rank wrapper (the reference bench
    wrappers' refine_ratio semantics), used by the PQ, BQ and CAGRA
    entries."""
    from raft_tpu_torch.neighbors.refine import refine

    if refine_ratio > 1.0:
        k0 = max(k, int(k * refine_ratio))
        _, cand = search_fn(res, params, bundle["index"], queries, k0)
        return refine(res, bundle["base"], queries, cand, k,
                      bundle["metric"])
    return search_fn(res, params, bundle["index"], queries, k)


def _ivf_pq_search(res, bundle, queries, k, *, n_probes=32,
                   refine_ratio=1.0, **params):
    from raft_tpu_torch.neighbors import ivf_pq

    p = ivf_pq.IvfPqSearchParams(n_probes=n_probes, **params)
    return _search_with_refine(ivf_pq.search, res, bundle, queries, k, p,
                               refine_ratio)


def _ivf_bq_build(res, base, metric, *, n_lists=1024, **params):
    from raft_tpu_torch.neighbors import ivf_bq

    p = ivf_bq.IvfBqIndexParams(n_lists=n_lists, metric=metric, **params)
    return {"index": ivf_bq.build(res, p, base), "base": base,
            "metric": metric}


def _ivf_bq_search(res, bundle, queries, k, *, n_probes=32,
                   refine_ratio=4.0, **params):
    from raft_tpu_torch.neighbors import ivf_bq

    p = ivf_bq.IvfBqSearchParams(n_probes=n_probes, **params)
    return _search_with_refine(ivf_bq.search, res, bundle, queries, k, p,
                               refine_ratio)


def _cagra_build(res, base, metric, *, graph_degree=64,
                 intermediate_graph_degree=128, **params):
    from raft_tpu_torch.neighbors import cagra

    if "build_algo" in params:
        # native configs carry the enum value; reference confs spell it
        # graph_build_algo: "IVF_PQ"/"NN_DESCENT" (raft_benchmark.cu:153)
        params["build_algo"] = cagra.BuildAlgo(
            str(params["build_algo"]).lower())
    p = cagra.CagraIndexParams(
        graph_degree=graph_degree,
        intermediate_graph_degree=intermediate_graph_degree,
        metric=metric, **params)
    # keep the RAW base for refine — with storage_dtype the index holds
    # a quantized copy, and re-ranking against that recovers nothing
    return {"index": cagra.build(res, p, base), "base": base,
            "metric": metric}


def _cagra_search(res, bundle, queries, k, *, itopk_size=64,
                  max_iterations=0, refine_ratio=1.0, **params):
    from raft_tpu_torch.neighbors import cagra

    p = cagra.CagraSearchParams(itopk_size=itopk_size,
                                max_iterations=max_iterations, **params)
    return _search_with_refine(cagra.search, res, bundle, queries, k, p,
                               refine_ratio)


def _quantized_build(res, base, metric, **params):
    from raft_tpu_torch.neighbors import quantized

    if params:
        raise ValueError(f"raft_quantized build takes no params, got {params}")
    return quantized.build(res, base, metric)


def _quantized_search(res, index, queries, k, **params):
    from raft_tpu_torch.neighbors import quantized

    if params:
        raise ValueError(f"raft_quantized search takes no params, got {params}")
    return quantized.search(res, index, queries, k)


def _ivf_flat_save(index, path):
    from raft_tpu_torch.neighbors import ivf_flat

    ivf_flat.save(index, path)


def _ivf_flat_load(res, path, base, metric, **params):
    from raft_tpu_torch.neighbors import ivf_flat

    return ivf_flat.load(res, path)


def _bundle_save(mod_name):
    def save_fn(bundle, path):
        import importlib

        importlib.import_module(mod_name).save(bundle["index"], path)
    return save_fn


def _bundle_load(mod_name):
    def load_fn(res, path, base, metric, **params):
        import importlib

        index = importlib.import_module(mod_name).load(res, path)
        return {"index": index, "base": base, "metric": metric}
    return load_fn


def _cagra_save(bundle, path):
    from raft_tpu_torch.neighbors import cagra

    cagra.save(bundle["index"], path, include_dataset=True)


def _hnswlib_build(res, base, metric, *, M=16, ef_construction=200,
                   **params):
    from raft_tpu_torch.bench import hnsw_cpu

    if params:
        raise ValueError(f"hnswlib build takes M/ef_construction, "
                         f"got {params}")
    return hnsw_cpu.build(base, metric, M=M,
                          ef_construction=ef_construction)


def _hnswlib_search(res, index, queries, k, *, ef=64, **params):
    from raft_tpu_torch.bench import hnsw_cpu

    if params:
        raise ValueError(f"hnswlib search takes ef, got {params}")
    return hnsw_cpu.search(index, np.asarray(queries), k, ef=ef)


def _hnswlib_save(index, path):
    from raft_tpu_torch.bench import hnsw_cpu

    hnsw_cpu.save(index, path)


def _hnswlib_load(res, path, base, metric, **params):
    from raft_tpu_torch.bench import hnsw_cpu

    return hnsw_cpu.load(path, base.shape[1], metric)


def _ivf_flat_cpu_build(res, base, metric, *, n_lists=1024, train_iters=10,
                        trainset_fraction=0.1, **params):
    from raft_tpu_torch.bench import ivf_flat_cpu

    if params:
        raise ValueError(f"ivf_flat_cpu build takes n_lists/train_iters/"
                         f"trainset_fraction, got {params}")
    return ivf_flat_cpu.build(np.asarray(base), metric, n_lists=n_lists,
                              train_iters=train_iters,
                              trainset_fraction=trainset_fraction)


def _ivf_flat_cpu_search(res, index, queries, k, *, n_probes=32, **params):
    from raft_tpu_torch.bench import ivf_flat_cpu

    if params:
        raise ValueError(f"ivf_flat_cpu search takes n_probes, "
                         f"got {params}")
    return ivf_flat_cpu.search(index, np.asarray(queries), k,
                               n_probes=n_probes)


def _ivf_flat_cpu_save(index, path):
    from raft_tpu_torch.bench import ivf_flat_cpu

    ivf_flat_cpu.save(index, path)


def _ivf_flat_cpu_load(res, path, base, metric, **params):
    from raft_tpu_torch.bench import ivf_flat_cpu

    return ivf_flat_cpu.load(path, base.shape[1], metric)


ALGO_REGISTRY: Dict[str, AlgoWrapper] = {
    "raft_brute_force": AlgoWrapper("raft_brute_force",
                                    _brute_force_build, _brute_force_search),
    "raft_ivf_flat": AlgoWrapper("raft_ivf_flat",
                                 _ivf_flat_build, _ivf_flat_search,
                                 _ivf_flat_save, _ivf_flat_load),
    "raft_ivf_pq": AlgoWrapper(
        "raft_ivf_pq", _ivf_pq_build, _ivf_pq_search,
        _bundle_save("raft_tpu_torch.neighbors.ivf_pq"),
        _bundle_load("raft_tpu_torch.neighbors.ivf_pq")),
    "raft_ivf_bq": AlgoWrapper(
        "raft_ivf_bq", _ivf_bq_build, _ivf_bq_search,
        _bundle_save("raft_tpu_torch.neighbors.ivf_bq"),
        _bundle_load("raft_tpu_torch.neighbors.ivf_bq")),
    "raft_cagra": AlgoWrapper("raft_cagra", _cagra_build, _cagra_search,
                              _cagra_save,
                              _bundle_load("raft_tpu_torch.neighbors.cagra")),
    "raft_quantized": AlgoWrapper("raft_quantized",
                                  _quantized_build, _quantized_search),
    # the comparison baseline (the reference's hnswlib competitor role,
    # cpp/bench/ann/src/hnswlib/hnswlib_wrapper.h) — native C++ HNSW
    # on the host CPU, not a device algorithm
    "hnswlib": AlgoWrapper("hnswlib", _hnswlib_build, _hnswlib_search,
                           _hnswlib_save, _hnswlib_load, host=True),
    # second comparison series (the reference's FAISS competitor role,
    # cpp/bench/ann/src/faiss/faiss_benchmark.cu) — from-scratch numpy
    # IVF-Flat exact scan on the host CPU, not a device algorithm
    "ivf_flat_cpu": AlgoWrapper("ivf_flat_cpu", _ivf_flat_cpu_build,
                                _ivf_flat_cpu_search, _ivf_flat_cpu_save,
                                _ivf_flat_cpu_load, host=True),
}


def save_index_atomic(algo: AlgoWrapper, index: Any,
                      cache: pathlib.Path) -> None:
    """Write an index cache file atomically (tmp + rename) so a crash
    mid-save can never leave a half-written file at the cache path.
    The one write protocol of the cache: a script that prebuilds
    indexes off the measurement device calls it too."""
    cache.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_suffix(".tmp")
    algo.save(index, str(tmp))
    tmp.replace(cache)


def _index_cache_key(algo: str, dataset_name: str, n: int, dim: int,
                     metric_name: str,
                     build_params: Dict[str, Any]) -> str:
    """Deterministic readable filename for a (dataset, algo, build
    params) combination — the role of the reference's per-index
    ``index.file`` naming in its conf files. ``dataset_name`` is in the
    key so same-shaped datasets can't reuse each other's indexes."""
    parts = [algo, dataset_name, f"{n}x{dim}", metric_name]
    for key in sorted(build_params):
        parts.append(f"{key}={build_params[key]}")
    raw = "-".join(parts)
    return re.sub(r"[^A-Za-z0-9_.=-]", "_", raw)


def _leaves(x) -> list:
    """The tensors and arrays of a result: a tuple, list or dict of them
    (a search's ``(d, i)``, a bundle), or one."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x] if isinstance(x, (torch.Tensor, np.ndarray)) else []


def _block(x, device: torch.device):
    """Wait for the device's queued work AND fetch one element of x, so
    completion is anchored on a host read (the JAX runner's contract:
    one element, negligible transfer)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for leaf in _leaves(x):
        if isinstance(leaf, torch.Tensor) and leaf.numel():
            leaf.reshape(-1)[:1].cpu()
            break
    return x


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# reference raft-ann-bench param spellings → this framework's
_BUILD_KEY_MAP = {
    "nlist": "n_lists",
    "niter": "kmeans_n_iters",
    "pq_dim": "pq_dim",
    "pq_bits": "pq_bits",
    "graph_degree": "graph_degree",
    "intermediate_graph_degree": "intermediate_graph_degree",
    "graph_build_algo": "build_algo",   # reference conf spelling
    "M": "M",                           # hnswlib spellings
    "efConstruction": "ef_construction",
}
_SEARCH_KEY_MAP = {
    "nprobe": "n_probes",
    "n_probes": "n_probes",
    "itopk": "itopk_size",
    "itopk_size": "itopk_size",
    "search_width": "search_width",
    "max_iterations": "max_iterations",
    "refine_ratio": "refine_ratio",
    "ef": "ef",                         # hnswlib spelling
}
_ALGO_ALIASES = {"raft_bfknn": "raft_brute_force"}


def normalize_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Accept the reference's ``conf/*.json`` schema (an ``index`` list
    with ``build_param``/``search_params``, ``run/conf/`` files) as well
    as the native ``algos`` schema; translate raft and hnswlib param
    spellings (nlist/nprobe/itopk/ratio/M/efConstruction/ef/…) and drop
    competitor entries with no wrapper here (faiss/ggnn benchmark OTHER
    libraries; hnswlib maps onto the native C++ baseline)."""
    if "algos" in config:
        return config
    if "index" not in config:
        raise ValueError("config needs an 'algos' or 'index' section")
    algos = []
    for entry in config["index"]:
        algo = _ALGO_ALIASES.get(entry["algo"], entry["algo"])
        if algo not in ALGO_REGISTRY:
            continue  # competitor wrapper (hnswlib/faiss/...)
        build = {}
        for key, val in entry.get("build_param", {}).items():
            if key == "ratio":  # subsample ratio → trainset fraction
                build["kmeans_trainset_fraction"] = 1.0 / max(val, 1)
            elif key in _BUILD_KEY_MAP:
                build[_BUILD_KEY_MAP[key]] = val
        search = []
        for sp in entry.get("search_params", [{}]):
            search.append({_SEARCH_KEY_MAP[k]: v for k, v in sp.items()
                           if k in _SEARCH_KEY_MAP})
        algos.append({"name": algo, "build": build, "search": search})
    if not algos:
        raise ValueError("config contained no raft algorithms")
    return {"algos": algos}


def run_benchmark(
    dataset_dir,
    config: Dict[str, Any],
    out_dir,
    *,
    k: int = 10,
    batch_size: int = 0,
    max_base_rows: int = 0,
    search_iters: int = 3,
    force_rebuild: bool = False,
    resume: bool = False,
    only_algos=None,
    require_cached_index: bool = False,
    device: str = "cuda",
) -> List[Dict[str, Any]]:
    """Run every (algo, build-params, search-params) combination in
    ``config`` against the dataset tree; write JSON-lines results.

    ``resume=True`` appends to an existing ``results.jsonl`` and skips
    combinations already recorded there (same dataset/algo/build/
    search/k/batch/search_iters, and the same ``backend``), so an
    interrupted sweep continues where it stopped instead of redoing finished measurements. ``only_algos``
    (iterable of names) restricts the sweep to those algo entries — the
    piece-at-a-time pattern: one process per family bounds what a crash
    can lose. ``require_cached_index=True`` raises instead of building
    when a saveable algo's index cache misses — the guard for runs
    where an index build on the measurement device is not acceptable
    (e.g. a sweep on a measurement device where index builds are not
    acceptable). ``device`` is where the framework's algorithms build
    and search (``"cuda"`` by default: it raises on a box without a
    card unless ``"cpu"`` is asked for); the CPU competitors run on the
    host either way. A row's ``backend`` is that device's type.

    Config schema (the reference's ``conf/*.json`` shape)::

        {"algos": [{"name": "raft_ivf_flat",
                    "build": {"n_lists": 1024},
                    "search": [{"n_probes": 16}, {"n_probes": 64}]}]}
    """
    if search_iters < 1:
        raise ValueError(f"search_iters must be >= 1, got {search_iters}")
    if force_rebuild and require_cached_index:
        raise ValueError(
            "force_rebuild and require_cached_index are contradictory: "
            "one demands a fresh build, the other forbids building")
    config = normalize_config(config)
    res = Resources(device=device)
    dataset_dir = pathlib.Path(dataset_dir)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    base = read_bin(dataset_dir / "base.fbin")
    queries = read_bin(dataset_dir / "query.fbin")
    if queries.shape[0] == 0:
        raise ValueError("query set is empty — qps would be undefined")
    gt = read_bin(dataset_dir / "groundtruth.neighbors.ibin")
    metric_name = (dataset_dir / "metric.txt").read_text().strip() \
        if (dataset_dir / "metric.txt").exists() else "euclidean"
    metric = METRICS[metric_name]
    if max_base_rows:
        base = base[:max_base_rows]
        gt = None  # groundtruth invalidated by truncation
    if batch_size <= 0:
        batch_size = queries.shape[0]

    def _combo_key(algo_name, build_params, search_params):
        return json.dumps(
            [dataset_dir.name, int(max_base_rows), algo_name,
             build_params, search_params, k, batch_size, search_iters],
            sort_keys=True)

    if only_algos is not None:
        only_algos = {a.strip() for a in only_algos}
        in_config = {a["name"] for a in config["algos"]}
        unknown = only_algos - in_config
        if unknown:
            raise ValueError(
                f"only_algos entries {sorted(unknown)} not in the "
                f"config (it has {sorted(in_config)})")

    done = set()
    results = []
    out_file = out_dir / "results.jsonl"
    backend = res.device.type
    # each set goes to the device once: the timed loop holds searches only
    on_device = (res.put(base), res.put(queries))

    def _same_sweep(row):
        """Row belongs to this sweep's identity (dataset, depth, k,
        batch, iters) — the shared predicate for both the resume
        done-guard and the legacy-row cleanup.  .get defaults: rows
        written before the search_iters / max_base_rows fields existed
        carry the values those defaults had (3 / 0) — without this,
        resuming over a legacy results.jsonl re-measures every
        combination and the export doubles up."""
        return (row.get("dataset") == dataset_dir.name
                and row.get("max_base_rows", 0) == int(max_base_rows)
                and row.get("k") == k
                and row.get("batch_size") == batch_size
                and row.get("search_iters", 3) == search_iters)

    # combos whose pre-backend-field rows this run has superseded: once
    # the replacement row is FLUSHED, the legacy row is dropped in the
    # end-of-run rewrite below (never before — a crash between an
    # eager rewrite and the re-measurement would lose measured data)
    superseded = set()
    if resume and out_file.exists():
        legacy_seen = set()
        with open(out_file) as fh:
            for line in fh:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # truncated tail from a killed run
                if not _same_sweep(row):
                    continue
                # a row measured on another backend (e.g. a CPU
                # rehearsal sharing the out_dir) must not satisfy this
                # sweep; a missing backend field does NOT imply this
                # backend (unlike search_iters there is no known
                # default), so legacy rows are re-measured once and the
                # stale line cleaned up after its replacement lands
                if "backend" not in row:
                    legacy_seen.add(_combo_key(row.get("algo"),
                                               row.get("build_params"),
                                               row.get("search_params")))
                elif row.get("backend") == backend:
                    done.add(_combo_key(row.get("algo"),
                                        row.get("build_params"),
                                        row.get("search_params")))
                    # returned/printed rows honor only_algos: a
                    # per-family step must not replay other families
                    if (only_algos is None
                            or row.get("algo") in only_algos):
                        results.append(row)
        # a legacy row whose combo already has a backend-bearing row is
        # provably superseded even though this run won't re-measure it
        # (e.g. the run that replaced it crashed before its own cleanup)
        superseded |= legacy_seen & done
        if done:
            _log_warn("resume: %d finished combination(s) found in %s",
                      len(done), out_file)
    with open(out_file, "a" if resume else "w") as fh:
        for algo_cfg in config["algos"]:
            if only_algos is not None and \
                    algo_cfg["name"] not in only_algos:
                continue
            algo = ALGO_REGISTRY[algo_cfg["name"]]
            build_params = algo_cfg.get("build", {})
            pending = [sp for sp in algo_cfg.get("search", [{}])
                       if _combo_key(algo.name, build_params, sp)
                       not in done]
            if not pending:
                continue  # every search combo finished in a prior run
            from raft_tpu_torch.core import interruptible

            interruptible.yield_()  # cancellation point per algo entry
            if algo.name == "hnswlib":
                # the CPU baseline needs the native toolchain; a host
                # without it (bare wheel install) must lose the
                # comparison series, not the whole sweep
                from raft_tpu_torch.bench import hnsw_cpu

                if not hnsw_cpu.available():
                    _log_warn("skipping hnswlib: native HNSW library "
                              "unavailable (no C++ toolchain?)")
                    continue
            base_in, queries_in = ((base, queries) if algo.host
                                   else on_device)
            cache = None
            if algo.save is not None and algo.load is not None:
                key = _index_cache_key(
                    algo.name, dataset_dir.name, base.shape[0],
                    base.shape[1], metric_name, build_params)
                cache = out_dir / "indexes" / f"{key}.bin"
            index = None
            build_cached = False
            t0 = time.perf_counter()
            if (cache is not None and cache.exists()
                    and not force_rebuild):
                try:
                    index = _block(algo.load(res, str(cache), base_in,
                                             metric, **build_params),
                                   res.device)
                    build_cached = True
                except Exception as e:  # noqa: BLE001 — truncated file
                    # from a crash mid-save: fall through to a fresh
                    # build, but say so (a silent fall-through would
                    # hide a never-hitting cache)
                    _log_warn("index cache load failed (%s: %s) — "
                              "rebuilding", cache.name, e)
                    index = None
            if index is None:
                if require_cached_index and cache is not None:
                    raise RuntimeError(
                        f"require_cached_index: no cached index for "
                        f"{algo.name} {build_params} (expected "
                        f"{cache}); prebuild it off-device first")
                index = _block(algo.build(res, base_in, metric,
                                          **build_params), res.device)
            build_s = time.perf_counter() - t0
            if cache is not None and not build_cached:
                # save AFTER timing: the write (which for cagra includes
                # the dataset copy) must not inflate build_seconds, and
                # a save failure must not discard the finished build
                try:
                    save_index_atomic(algo, index, cache)
                except Exception as e:  # noqa: BLE001
                    _log_warn("index cache save failed (%s: %s) — "
                              "continuing without cache", cache.name, e)

            for search_params in pending:
                interruptible.yield_()  # cancellation point per combo
                # warm every batch shape, including a ragged final batch
                # (kernel builds, first launches, allocator growth), so
                # none of it lands in the timed loop
                _block(algo.search(res, index, queries_in[:batch_size], k,
                                   **search_params), res.device)
                tail = queries.shape[0] % batch_size
                if tail:
                    _block(algo.search(res, index, queries_in[-tail:], k,
                                       **search_params), res.device)
                # recall pass (untimed): fetch every batch's indices
                all_i = []
                for s in range(0, queries.shape[0], batch_size):
                    _, i = algo.search(res, index,
                                       queries_in[s : s + batch_size], k,
                                       **search_params)
                    all_i.append(_host(i))
                # timed pass: dispatch everything, sync once at the end —
                # a per-batch fetch would wait on each batch in turn
                _block(None, res.device)
                t0 = time.perf_counter()
                n_done = 0
                out = None
                for _ in range(search_iters):
                    for s in range(0, queries.shape[0], batch_size):
                        qb = queries_in[s : s + batch_size]
                        out = algo.search(res, index, qb, k, **search_params)
                        n_done += qb.shape[0]
                _block(out, res.device)
                dt = time.perf_counter() - t0
                qps = n_done / dt
                got = np.concatenate(all_i)[: queries.shape[0]]
                rec = (eval_recall(gt[:, :k], got)[0]
                       if gt is not None else float("nan"))
                row = {
                    "dataset": dataset_dir.name,
                    "max_base_rows": int(max_base_rows),
                    "backend": backend,
                    "algo": algo.name,
                    "build_params": build_params,
                    "search_params": search_params,
                    "k": k,
                    "batch_size": batch_size,
                    "search_iters": search_iters,
                    "build_seconds": round(build_s, 4),
                    "build_cached": build_cached,
                    "qps": round(qps, 2),
                    "recall": None if np.isnan(rec) else round(float(rec), 4),
                }
                results.append(row)
                fh.write(json.dumps(row) + "\n")
                fh.flush()
                superseded.add(_combo_key(algo.name, build_params,
                                          search_params))
    if resume and superseded:
        _drop_superseded_legacy_rows(out_file, _same_sweep, _combo_key,
                                     superseded)
    return results


def _drop_superseded_legacy_rows(out_file, same_sweep, combo_key,
                                 superseded) -> None:
    """Rewrite ``results.jsonl`` without pre-backend-field rows whose
    combos were re-measured this run.  Runs only AFTER the replacement
    rows are flushed: a legacy row's backend is unknowable, so resume
    re-measures its combo, and keeping both would double up the
    export/plot — but dropping before the replacement lands would turn
    a mid-sweep crash into silent data loss."""
    kept, dropped = [], 0
    for line in out_file.read_text().splitlines(keepends=True):
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue  # truncated tail from a killed run
        if ("backend" not in row and same_sweep(row)
                and combo_key(row.get("algo"), row.get("build_params"),
                              row.get("search_params")) in superseded):
            dropped += 1
            continue
        kept.append(line)
    if dropped:
        tmp = out_file.with_suffix(".jsonl.tmp")
        tmp.write_text("".join(kept))
        tmp.replace(out_file)
        _log_warn("resume: dropped %d pre-backend-field row(s) from %s "
                  "(re-measured this run with the backend field)",
                  dropped, out_file)


def _load_rows(results_dir: pathlib.Path) -> List[Dict[str, Any]]:
    rows = []
    for f in sorted(results_dir.glob("*.jsonl")):
        for line in f.read_text().splitlines():
            if line.strip():
                rows.append(json.loads(line))
    return rows


def export_csv(results_dir, out_path=None) -> pathlib.Path:
    """JSON-lines → CSV — the ``data_export`` subcommand."""
    import csv

    results_dir = pathlib.Path(results_dir)
    out_path = pathlib.Path(out_path or results_dir / "results.csv")
    rows = _load_rows(results_dir)
    if not rows:
        raise FileNotFoundError(f"no results under {results_dir}")
    cols = ["dataset", "backend", "algo", "build_params", "search_params",
            "k", "batch_size", "search_iters", "build_seconds",
            "build_cached", "qps", "recall"]
    with open(out_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=cols)
        w.writeheader()
        for r in rows:
            # .get: rows from pre-cache runs lack build_cached
            w.writerow({c: json.dumps(r.get(c)) if isinstance(r.get(c), dict)
                        else r.get(c) for c in cols})
    return out_path


def plot_results(results_dir, out_path=None) -> pathlib.Path:
    """Recall-vs-QPS pareto plot — the ``plot`` subcommand
    (``plot/__main__.py``; the reference's published artifact shape)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results_dir = pathlib.Path(results_dir)
    out_path = pathlib.Path(out_path or results_dir / "recall_vs_qps.png")
    rows = _load_rows(results_dir)
    # rows measured at different search_iters (smoke vs full depth) are
    # distinct series — mixing them would zigzag the pareto line
    depths = {r.get("search_iters") for r in rows}
    series = sorted({(r["algo"], r.get("search_iters")) for r in rows},
                    key=lambda t: (t[0], str(t[1])))
    fig, ax = plt.subplots(figsize=(7, 5))
    for algo, depth in series:
        label = algo if len(depths) == 1 else f"{algo} (iters={depth})"
        pts = sorted(
            [(r["recall"], r["qps"]) for r in rows
             if r["algo"] == algo and r.get("search_iters") == depth
             and r["recall"] is not None]
        )
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker="o", label=label)
    ax.set_xlabel(f"recall@k")
    ax.set_ylabel("QPS")
    ax.set_yscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
