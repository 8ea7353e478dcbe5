"""The ANN benchmark harness on the card, at a size below ``chip_smoke.py``'s
``bench`` phase, whose checks it shares: the runner over every
device family of the bundled ``blobs-100000-128`` config on a 20,000 x
128 blobs tree made on the card, each kernel-backed family held against
its plain engine on the runner's own cached index at the config's
parameters, and the per-primitive suite at ``tiny`` with no error
record. Every test needs a CUDA device and skips without one; the file
imports no JAX, so run it with ``--noconftest``:

    python -m pytest --noconftest -q tests/test_torch_cuda_bench.py
"""

from __future__ import annotations

import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.bench import datasets, prims, runner  # noqa: E402

pytestmark = pytest.mark.cuda

DEVICE_ALGOS = ("raft_brute_force", "raft_ivf_flat", "raft_ivf_pq",
                "raft_ivf_bq", "raft_cagra", "raft_quantized")


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the runner's families launch the "
                    "port's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    root = tmp_path_factory.mktemp("bench")
    tree = datasets.make_dataset(root / "ds", "blobs-20000-128", n=20_000,
                                 dim=128, n_queries=1000, k=100, seed=1,
                                 device="cuda")
    config = json.loads((pathlib.Path(runner.__file__).parent / "conf"
                         / f"{cs.BENCH_CONFIG}.json").read_text())
    cs.reset_launches()
    rows = runner.run_benchmark(tree, config, root / "res", k=10,
                                search_iters=1, only_algos=DEVICE_ALGOS,
                                device="cuda")
    launches = {name: fn.launches for name, fn in cs._counted().items()}
    return tree, root / "res", rows, launches


def test_runner_sweeps_every_device_family(swept):
    _, _, rows, launches = swept
    assert {r["algo"] for r in rows} == set(DEVICE_ALGOS)
    assert all(r["backend"] == "cuda" and not r["build_cached"]
               for r in rows)
    by = {(r["algo"], json.dumps(r["search_params"], sort_keys=True)): r
          for r in rows}
    # the fused kernel (3xTF32) and the truth's tiled scan may order a
    # float tie differently: one slot in 10,000 at most
    assert by["raft_brute_force", "{}"]["recall"] >= 0.9999
    assert by["raft_ivf_flat", '{"n_probes": 256}']["recall"] >= 0.999
    assert max(r["recall"] for r in rows if r["algo"] == "raft_cagra") > 0.9
    for name in cs.BENCH_KERNELS:
        assert launches[name] > 0, (name, launches)


def test_families_equal_their_plain_engines(swept):
    tree, results, _, _ = swept
    out = cs.bench_kernel_checks(torch, str(tree), str(results))
    assert out["fused_knn"] < 1e-2
    assert out["ivf_pq_scan"] == 0.0


def test_groundtruth_agrees_with_float64(swept):
    g = cs.bench_groundtruth(torch, str(swept[0]), seed=0)
    assert g["sampled"] == cs.BENCH_GT_SAMPLE and g["k"] == 100


def test_prims_tiny_on_the_card(swept):
    recs = prims.run_prims("tiny", budget_s=0.05, device="cuda")
    assert [r["prim"] for r in recs] == prims.names()
    assert not [r for r in recs if "error" in r]
    assert all(r["backend"] == "cuda" for r in recs)
