"""Dataset preparation — analog of ``raft-ann-bench/get_dataset``
(hdf5 → big-ann bin conversion) plus a synthetic generator for
air-gapped runs; port of ``raft_tpu/bench/datasets.py``.

Layout convention (the reference's, ``run/__main__.py``):
``<dir>/<name>/base.fbin``, ``query.fbin``, ``groundtruth.neighbors.ibin``,
``groundtruth.distances.fbin``. The data are the JAX package's draws from
the same numpy generator, so the same arguments write the same base and
query files; the ground truth is the port's exact brute force on
``device``.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.io import write_bin

# metric.txt name → framework metric; shared by the runner and the
# groundtruth generator so the accepted sets can't drift apart
METRICS = {
    "euclidean": DistanceType.L2SqrtExpanded,
    "sqeuclidean": DistanceType.L2Expanded,
    "inner_product": DistanceType.InnerProduct,
    "angular": DistanceType.CosineExpanded,
}


def _groundtruth(base: np.ndarray, queries: np.ndarray, k: int,
                 metric: str = "euclidean", device: str = "cuda"):
    """Exact groundtruth via the port's own brute force on ``device``
    (k > 64 takes the tiled scan, k <= 64 the fused kernel on the card)."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force

    d, i = brute_force.knn(Resources(device=device), base, queries, k,
                           METRICS[metric])
    return d.cpu().numpy(), i.cpu().numpy()


def make_dataset(
    out_dir,
    name: str,
    n: int = 100_000,
    dim: int = 128,
    n_queries: int = 1000,
    k: int = 100,
    metric: str = "euclidean",
    seed: int = 0,
    kind: str = "blobs",
    device: str = "cuda",
) -> pathlib.Path:
    """Generate a synthetic dataset tree with exact groundtruth.

    ``kind``: "random" (iid gaussian — worst case for ANN) or "blobs"
    (clustered — the realistic regime). ``device`` runs the ground
    truth's search (``"cuda"`` by default; raises on a box without a
    card unless ``"cpu"`` is asked for)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        base = rng.standard_normal((n, dim)).astype(np.float32)
        queries = rng.standard_normal((n_queries, dim)).astype(np.float32)
    elif kind == "blobs":
        n_centers = max(10, int(np.sqrt(n) / 4))
        centers = rng.standard_normal((n_centers, dim)).astype(np.float32) * 4
        who = rng.integers(0, n_centers, n)
        base = centers[who] + rng.standard_normal((n, dim)).astype(np.float32)
        whoq = rng.integers(0, n_centers, n_queries)
        queries = centers[whoq] + rng.standard_normal(
            (n_queries, dim)).astype(np.float32)
    else:
        raise ValueError(f"unknown dataset kind {kind!r}")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{sorted(METRICS)}")

    root = pathlib.Path(out_dir) / name
    root.mkdir(parents=True, exist_ok=True)
    write_bin(root / "base.fbin", base)
    write_bin(root / "query.fbin", queries)
    gd, gi = _groundtruth(base, queries, k, metric, device)
    write_bin(root / "groundtruth.neighbors.ibin", gi.astype(np.int32))
    write_bin(root / "groundtruth.distances.fbin", gd.astype(np.float32))
    (root / "metric.txt").write_text(metric + "\n")
    return root


def convert_hdf5(hdf5_path, out_dir, name: Optional[str] = None) -> pathlib.Path:
    """Convert an ann-benchmarks HDF5 file (train/test/neighbors/distances
    datasets) into the bin-file tree — ``get_dataset/__main__.py``'s
    ``hdf5_to_fbin`` role. ``h5py`` is imported here, on use."""
    import h5py

    hdf5_path = pathlib.Path(hdf5_path)
    name = name or hdf5_path.stem
    root = pathlib.Path(out_dir) / name
    root.mkdir(parents=True, exist_ok=True)
    with h5py.File(hdf5_path, "r") as f:
        write_bin(root / "base.fbin", np.asarray(f["train"], np.float32))
        write_bin(root / "query.fbin", np.asarray(f["test"], np.float32))
        if "neighbors" in f:
            write_bin(root / "groundtruth.neighbors.ibin",
                      np.asarray(f["neighbors"], np.int32))
        if "distances" in f:
            write_bin(root / "groundtruth.distances.fbin",
                      np.asarray(f["distances"], np.float32))
        metric = f.attrs.get("distance", "euclidean")
        if isinstance(metric, bytes):
            metric = metric.decode()
    (root / "metric.txt").write_text(str(metric) + "\n")
    return root
