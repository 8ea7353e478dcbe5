"""raft_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points never quietly leave the device asked for."""

from __future__ import annotations

import ast
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "raft_tpu")


def _port_sources():
    files = sorted((ROOT / "raft_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_prefix_is_by_package_not_by_string():
    # raft_tpu_torch starts with "raft_tpu" but is the port itself
    assert not _forbidden("raft_tpu_torch.ops.fused_topk")
    assert _forbidden("raft_tpu.ops.fused_topk")
    assert _forbidden("raft_tpu")


def test_import_leaves_jax_unloaded():
    code = ("import sys, raft_tpu_torch, raft_tpu_torch.neighbors.ivf_flat, "
            "raft_tpu_torch.neighbors.brute_force, raft_tpu_torch.ops._build, "
            "raft_tpu_torch.neighbors.ivf_bq, raft_tpu_torch.neighbors.refine, "
            "raft_tpu_torch.matrix.select_k, raft_tpu_torch.neighbors.cagra, "
            "raft_tpu_torch.neighbors.nn_descent, "
            "raft_tpu_torch.neighbors.cluster_join, "
            "raft_tpu_torch.neighbors._exact, raft_tpu_torch.ops.beam_search, "
            "raft_tpu_torch.neighbors.tiered, raft_tpu_torch.ops.tier_scan, "
            "raft_tpu_torch.core.memwatch, raft_tpu_torch.serving.placement, "
            "raft_tpu_torch.serving.prefetch, raft_tpu_torch.neighbors.ivf_pq, "
            "raft_tpu_torch.core.executor, raft_tpu_torch.serving.batcher, "
            "raft_tpu_torch.serving.harness, raft_tpu_torch.serving.metrics, "
            "raft_tpu_torch.distance, raft_tpu_torch.cluster, "
            "raft_tpu_torch.neighbors.ball_cover, "
            "raft_tpu_torch.neighbors.epsilon_neighborhood, "
            "raft_tpu_torch.spatial, raft_tpu_torch.utils, "
            "raft_tpu_torch.core.interruptible, raft_tpu_torch.io, "
            "raft_tpu_torch.io.binfile, raft_tpu_torch.neighbors._streaming, "
            "raft_tpu_torch.comms, raft_tpu_torch.comms.comms, "
            "raft_tpu_torch.comms.bootstrap, raft_tpu_torch.distributed, "
            "raft_tpu_torch.distributed.ivf, raft_tpu_torch.distributed.bq, "
            "raft_tpu_torch.distributed.knn, "
            "raft_tpu_torch.distributed.kmeans, "
            "raft_tpu_torch.distributed.sharded_ann, "
            "raft_tpu_torch.distributed.checkpoint, raft_tpu_torch.random, "
            "raft_tpu_torch.linalg, raft_tpu_torch.matrix, "
            "raft_tpu_torch.label, raft_tpu_torch.stats, "
            "raft_tpu_torch.sparse, raft_tpu_torch.spectral, "
            "raft_tpu_torch.solver, raft_tpu_torch.core.logger, "
            "raft_tpu_torch.core.operators, raft_tpu_torch.bench, "
            "raft_tpu_torch.bench.runner, raft_tpu_torch.bench.prims, "
            "raft_tpu_torch.bench.hnsw_cpu, raft_tpu_torch.bench.__main__; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'raft_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is valid here")
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import brute_force

    with pytest.raises(RuntimeError, match="cuda"):
        Resources(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        brute_force.knn(None, np.eye(4, dtype=np.float32),
                        np.eye(4, dtype=np.float32)[:1], 1)


def test_kernel_build_needs_nvcc():
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc is installed here")
    from raft_tpu_torch.ops import _build

    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
