#!/usr/bin/env python3
"""Device time by kernel of raft_tpu_torch's two selection kernels, on the
card, for one checkout (A/B comparisons put two checkouts in one call):

    python3 scripts/torch_kernel_profile.py --root <checkout> --tag <name>

Shapes (data made on the card from --seed, as chip_smoke.py makes it):
``select_k_tiles`` at 64 x 2^20 (Gaussian, k = 64), at 2048 x 2048 (the
squared distances of 2,048 clustered rows to each other, an infinite
diagonal, k = 64) and at the main path's (64, 1,000,000), k = 10 slab;
``fused_knn`` at the brute-force request (q = 500, n = 1,000,000, d =
128, k = 10), float32 and bfloat16. For each: the median ms of CUDA
events around the wrapper, and torch.profiler's device µs per call by
kernel name (so a kernel's partial pass and its merge show apart). Prints
one JSON line with the card's name and power limit. Imports
raft_tpu_torch from --root only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

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

    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.fused_topk import fused_knn, select_k_tiles

    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(["fused_knn", "select_k"])
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    centers = torch.randn(4096, 128, generator=g, device="cuda") * 1.5
    lab = torch.randint(0, 4096, (1_010_000,), generator=g, device="cuda")
    pts = centers[lab] + torch.randn(1_010_000, 128, generator=g,
                                     device="cuda")
    x, queries = pts[:1_000_000].contiguous(), pts[1_000_000:].contiguous()
    xn = (x * x).sum(dim=1)

    def events_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def device_us(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = e.key.split("(")[0].split("<")[0].split("::")[-1]
                out[name] = round(out.get(name, 0.0)
                                  + e.device_time_total / reps, 1)
        return out

    gv = torch.Generator(device="cuda")
    gv.manual_seed(7)
    wide = torch.randn(64, 1 << 20, generator=gv, device="cuda")
    x2 = x[:2048]
    n2 = (x2 * x2).sum(dim=1)
    slab2 = torch.clamp(n2[:, None] + n2[None, :] - 2.0 * (x2 @ x2.T),
                        min=0.0)
    slab2.fill_diagonal_(float("inf"))
    q64 = queries[:64]
    slab_main = ((q64 * q64).sum(dim=1, keepdim=True) + xn[None, :]
                 - 2.0 * (q64 @ x.T))
    q500 = queries[:500]
    xb = x.to(torch.bfloat16)
    xbn = (xb.float() * xb.float()).sum(dim=1)
    cases = {
        "select_k 64x2^20 k=64": lambda: select_k_tiles(wide, 64),
        "select_k 2048x2048 k=64": lambda: select_k_tiles(slab2, 64),
        "select_k 64x1e6 k=10": lambda: select_k_tiles(slab_main, 10),
        "fused_knn f32 q=500 n=1e6 d=128 k=10": lambda: fused_knn(
            q500, x, 10, dataset_norms=xn),
        "fused_knn bf16 q=500 n=1e6 d=128 k=10": lambda: fused_knn(
            q500, xb, 10, dataset_norms=xbn),
    }
    out = {"tag": args.tag, "card": card}
    for name, fn in cases.items():
        out[name] = {"events_ms": events_ms(fn), "device_us": device_us(fn)}
        print(f"[{args.tag}] {name}: {out[name]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
