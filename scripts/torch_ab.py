#!/usr/bin/env python3
"""Time one checkout of raft_tpu_torch on the card, for A/B comparisons of
two commits in one call (parent, change, change, parent):

    python3 scripts/torch_ab.py --root <checkout> --tag <name>

On SIFT-1M's shape (1,000,000 x 128 float32, clustered data from --seed,
as chip_smoke.py makes it) it builds IVF-Flat (n_lists 1024), the tiered
index over it (hot_fraction 0.5) and CAGRA (the blobs-1M-128 config's
first raft_cagra entry), then prints one JSON line: the median request ms
(host clock, ending in a synchronize) of IVF-Flat at (n_probes, batch)
(32, 10), (32, 500), (128, 10), (128, 500), tiered at (128, 10) and
(128, 500), CAGRA at (itopk 64, batch) 10 and 500; the device time per
request of the package's scan, seed, merge and beam kernels (torch.profiler)
at the (128, 500), (128, 10) and CAGRA requests; the card's name and
power limit. It imports raft_tpu_torch from --root only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_flat, tiered
    from raft_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build_all()
    res = Resources(device="cuda", seed=args.seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    centers = torch.randn(4096, 128, generator=g, device="cuda") * 1.5
    lab = torch.randint(0, 4096, (1_010_000,), generator=g, device="cuda")
    pts = centers[lab] + torch.randn(1_010_000, 128, generator=g,
                                     device="cuda")
    x, queries = pts[:1_000_000].contiguous(), pts[1_000_000:].contiguous()
    index = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=1024),
                           x)
    tier = tiered.build_tiered(index, hot_fraction=0.5)
    cg = cagra.build(res, cagra.CagraIndexParams(
        graph_degree=32, intermediate_graph_degree=64,
        build_algo=cagra.BuildAlgo.CLUSTER_JOIN), x)
    torch.cuda.synchronize()

    def requests(fn, batch, n=None):
        n = n or (1000 if batch == 10 else 5000)
        times = []
        for s in range(0, n, batch):
            t0 = time.perf_counter()
            fn(queries[s:s + batch])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    def device_us(fn, q, reps=5):
        fn(q)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(q)
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if "raft_tpu_torch" in e.key:
                name = e.key.split("(")[0].split("::")[-1]
                out[name] = round(e.device_time_total / reps, 1)
        return out

    out = {"tag": args.tag, "card": card}
    for p in (32, 128):
        sp = ivf_flat.IvfFlatSearchParams(n_probes=p)
        for b in (10, 500):
            out[f"ivf_flat_ms_p{p}_b{b}"] = requests(
                lambda q, sp=sp: ivf_flat.search(res, sp, index, q, 10), b)
    tsp = tiered.TieredSearchParams(n_probes=128)
    for b in (10, 500):
        out[f"tiered_ms_p128_b{b}"] = requests(
            lambda q: tiered.search(res, tsp, tier, q, 10), b, 1000)
    csp = cagra.CagraSearchParams(itopk_size=64, search_width=4)
    for b in (10, 500):
        out[f"cagra_ms_itopk64_b{b}"] = requests(
            lambda q: cagra.search(res, csp, cg, q, 10), b)
    sp = ivf_flat.IvfFlatSearchParams(n_probes=128)
    for b in (10, 500):
        out[f"ivf_flat_kernels_us_p128_b{b}"] = device_us(
            lambda q: ivf_flat.search(res, sp, index, q, 10), queries[:b])
        out[f"cagra_kernels_us_itopk64_b{b}"] = device_us(
            lambda q: cagra.search(res, csp, cg, q, 10), queries[:b])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
