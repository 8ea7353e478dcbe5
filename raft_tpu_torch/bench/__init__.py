"""ANN benchmark harness — analog of ``python/raft-ann-bench``: dataset
preparation, run orchestration from JSON configs, CSV export, and
recall-vs-QPS plotting; port of ``raft_tpu/bench``. The framework's
algorithms run on the card unless ``--device cpu`` (``device="cpu"``)
is asked for; the two CPU competitors (``hnswlib``, ``ivf_flat_cpu``)
run on the host.

CLI::

    python -m raft_tpu_torch.bench get-dataset --kind random --n 100000 ...
    python -m raft_tpu_torch.bench run --dataset data/random-100k \
        --config conf.json
    python -m raft_tpu_torch.bench data-export --results results/
    python -m raft_tpu_torch.bench plot --results results/ --out plot.png
    python -m raft_tpu_torch.bench.prims --size small
"""

from raft_tpu_torch.bench.datasets import convert_hdf5, make_dataset
from raft_tpu_torch.bench.runner import ALGO_REGISTRY, run_benchmark

__all__ = [
    "ALGO_REGISTRY",
    "convert_hdf5",
    "make_dataset",
    "run_benchmark",
]
