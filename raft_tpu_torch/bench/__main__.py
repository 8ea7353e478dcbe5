"""CLI for the ANN benchmark harness — the ``raft-ann-bench`` command
surface (``run/__main__.py:70``: run / get-dataset / data-export / plot);
port of ``raft_tpu/bench/__main__.py`` with ``--device`` on the
subcommands that compute (``cuda`` by default)."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="raft_tpu_torch.bench",
        description="GPU ANN benchmark harness (raft-ann-bench analog)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("get-dataset", help="generate or convert a dataset")
    p.add_argument("--out-dir", default="datasets")
    p.add_argument("--name", default=None)
    p.add_argument("--kind", choices=["random", "blobs"], default="blobs")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--n-queries", type=int, default=1000)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--metric", default="euclidean")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hdf5", default=None,
                   help="convert this ann-benchmarks HDF5 instead")
    p.add_argument("--device", default="cuda",
                   help="torch device of the ground truth's search "
                        "(default cuda)")

    p = sub.add_parser("run", help="run benchmarks from a JSON config")
    p.add_argument("--dataset", required=True, help="dataset directory")
    p.add_argument("--config", required=True,
                   help="JSON config path, or the name of a bundled config "
                        "under raft_tpu_torch/bench/conf (e.g. "
                        "sift-128-euclidean)")
    p.add_argument("--out-dir", default="results")
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--search-iters", type=int, default=3)
    p.add_argument("--force-rebuild", action="store_true",
                   help="rebuild indexes even if a cached index file "
                        "exists under <out-dir>/indexes/")
    p.add_argument("--resume", action="store_true",
                   help="append to an existing results.jsonl, skipping "
                        "already-recorded combinations")
    p.add_argument("--algos", default=None,
                   help="comma-separated algo names to run (default all "
                        "in the config)")
    p.add_argument("--require-cached-index", action="store_true",
                   help="fail instead of building when a saveable "
                        "algo's index cache misses (for measurement "
                        "devices where builds are not acceptable)")
    p.add_argument("--device", default="cuda",
                   help="torch device the framework's algorithms build "
                        "and search on (default cuda; the CPU "
                        "competitors run on the host)")

    p = sub.add_parser("data-export", help="results JSONL -> CSV")
    p.add_argument("--results", required=True)
    p.add_argument("--out", default=None)

    p = sub.add_parser("plot", help="recall-vs-QPS plot")
    p.add_argument("--results", required=True)
    p.add_argument("--out", default=None)

    args = parser.parse_args(argv)

    if args.cmd == "get-dataset":
        from raft_tpu_torch.bench.datasets import convert_hdf5, make_dataset

        if args.hdf5:
            root = convert_hdf5(args.hdf5, args.out_dir, args.name)
        else:
            name = args.name or f"{args.kind}-{args.n}-{args.dim}"
            root = make_dataset(
                args.out_dir, name, n=args.n, dim=args.dim,
                n_queries=args.n_queries, k=args.k, metric=args.metric,
                seed=args.seed, kind=args.kind, device=args.device,
            )
        print(root)
    elif args.cmd == "run":
        from raft_tpu_torch.bench.runner import run_benchmark

        cfg_path = pathlib.Path(args.config)
        if not cfg_path.exists():
            bundled = (pathlib.Path(__file__).parent / "conf"
                       / f"{args.config}.json")
            if bundled.exists():
                cfg_path = bundled
            else:
                parser.error(f"config {args.config!r} not found (no such "
                             f"file and no bundled conf/{args.config}.json)")
        config = json.loads(cfg_path.read_text())
        rows = run_benchmark(
            args.dataset, config, args.out_dir, k=args.k,
            batch_size=args.batch_size, search_iters=args.search_iters,
            force_rebuild=args.force_rebuild, resume=args.resume,
            only_algos=(args.algos.split(",") if args.algos else None),
            require_cached_index=args.require_cached_index,
            device=args.device,
        )
        for r in rows:
            print(json.dumps(r))
    elif args.cmd == "data-export":
        from raft_tpu_torch.bench.runner import export_csv

        print(export_csv(args.results, args.out))
    elif args.cmd == "plot":
        from raft_tpu_torch.bench.runner import plot_results

        print(plot_results(args.results, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
