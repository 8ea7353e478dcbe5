#!/usr/bin/env python3
"""The serving batcher on the card, bucketed against ragged, in turns, with
the host time of each dispatch split by stage:

    python3 scripts/torch_ragged_ab.py [--seed 0] [--turns BRRBRB] [--no-collect]

An IVF-Flat index at SIFT-1M's shape (1,000,000 x 128, n_lists 1024; data
made on the card from --seed as chip_smoke.py makes it) behind two
captured executors: bucketed (the ladder 8..256 warmed for each
(n_probes, k) of the mix) and ragged (tiles 256 and 64). The mix is
chip_smoke.py's ragged A/B: 1-40 rows, n_probes {20, 24, 32}, k {10, 16}.
Each turn (B: bucketed, R: ragged) offers 2 s of that traffic from four
threads at the rate the bucketed executor serves it one at a time
(measured first), after a ``gc.collect()`` (so that every turn starts
from the same collector state; ``--no-collect`` leaves it out), and
prints the end-to-end p50/p99, dispatches, rows a
dispatch, pad waste, each batcher stage's p50/p99/max (queue wait,
assembly, execute, split; raw samples), the five slowest requests with
their completion time in the turn, and Python's collector pauses. Then
the executor alone: the host time of ``search_ragged`` on packed batches
of 3, 6 and 12 requests against ``search_blocks``/``search`` of the same
requests, and a cProfile of 200 ``search_ragged`` calls (top functions
by internal time). Prints the card's name and power limit first; results
go to stdout and one JSON line at the end.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import io
import json
import os
import pstats
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", default="BRRBRB")
    ap.add_argument("--no-collect", action="store_true",
                    help="do not run gc.collect() before each turn")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ragged_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from raft_tpu_torch import Resources, SearchExecutor
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serving import BatcherConfig, DynamicBatcher, metrics

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = Resources(device="cuda", seed=args.seed)
    x, queries = cs.make_data(torch, args.seed)
    index = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(
        n_lists=cs.N_LISTS), x)
    del x
    mix = [(ivf_flat.IvfFlatSearchParams(n_probes=n), k)
           for n in (20, 24, 32) for k in cs.RAGGED_KS]
    bex = SearchExecutor(res)
    ladder = tuple(b for b in cs.SERVE_LADDER if b <= cs.RAGGED_TILE)
    for p, k in mix:
        bex.warmup(index, buckets=ladder, k=k, params=p)
    rex = SearchExecutor(res, ragged_tile=cs.RAGGED_TILE,
                         ragged_tile_small=cs.RAGGED_TILE_SMALL)
    rex.warmup_ragged(index, k=16, params=mix[-1][0])
    draw = cs._ragged_draw(mix)
    rng = np.random.default_rng(args.seed + 199)
    rate = cs._serial_rate(torch, lambda r: bex.search(
        index, queries[r[1]:r[1] + r[0]], mix[r[2]][1],
        params=mix[r[2]][0]), [draw(rng) for _ in range(200)])
    print(f"one at a time the bucketed executor serves {rate:.1f} "
          "requests/s of the mix", flush=True)

    stages = (metrics.QUEUE_WAIT, metrics.ASSEMBLY, metrics.EXECUTE,
              metrics.SPLIT, metrics.E2E)
    turns = []
    for t, mode in enumerate(args.turns):
        ragged = mode == "R"
        ex = rex if ragged else bex
        built = ex.stats.compile_count
        metrics.reset()
        samples: dict = {name: [] for name in stages}
        ends: list = []
        observe = metrics.observe_stage
        t0 = time.perf_counter()

        def tap(name, seconds):
            if name in samples:
                samples[name].append(seconds)
                if name == metrics.E2E:
                    ends.append((seconds, time.perf_counter() - t0))
            observe(name, seconds)

        b = DynamicBatcher(ex, BatcherConfig(
            max_wait_s=0.002, full_batch_rows=cs.RAGGED_TILE, ragged=ragged))
        if not args.no_collect:
            gc.collect()
        metrics.observe_stage = tap
        try:
            with cs.gc_pauses() as pauses:
                run = cs._offer_load(torch, b, draw, lambda r: b.submit(
                    index, queries[r[1]:r[1] + r[0]], mix[r[2]][1],
                    params=mix[r[2]][0]), rate, args.seed + 200 + t)
        finally:
            metrics.observe_stage = observe
        if ex.stats.compile_count != built:
            print(f"turn {t} {mode}: plans captured under load")
            return 1
        calls = metrics.snapshot()["counters"].get(
            "serving.execute.calls", 0.0)
        rows = metrics.snapshot()["counters"].get(
            "serving.execute.rows", 0.0)
        rec = {"turn": t, "mode": "ragged" if ragged else "bucketed",
               "requests": len(run["out"]), "offered_rps": run["offered"],
               "p50_ms": run["p50_ms"], "p99_ms": run["p99_ms"],
               "dispatches": int(calls),
               "rows_per_dispatch": rows / calls if calls else 0.0,
               "pad_waste": metrics.derived()["pad_waste_fraction"],
               "gc_pauses": len(pauses),
               "gc_max_ms": max(pauses, default=0.0) * 1e3}
        for name in stages:
            v = np.asarray(samples[name]) * 1e3
            short = name.rsplit(".", 1)[1].replace("_seconds", "")
            rec[short] = {"p50": float(np.percentile(v, 50)),
                          "p99": float(np.percentile(v, 99)),
                          "max": float(v.max())}
        rec["slowest"] = [(round(s * 1e3, 3), round(at, 3))
                          for s, at in sorted(ends)[-5:]]
        turns.append(rec)
        print(json.dumps(rec), flush=True)

    # the executor alone: packed against one by one, and where the host
    # time of a packed call goes
    rng = np.random.default_rng(args.seed + 7)
    calls = {}
    for n in (3, 6, 12):
        reqs = [draw(rng) for _ in range(n)]
        blocks = [queries[at:at + m] for m, at, _ in reqs]
        ks = [mix[j][1] for _, _, j in reqs]
        ps = [mix[j][0] for _, _, j in reqs]

        def packed():
            rex.search_ragged(index, blocks, ks, params_list=ps)

        def solo():
            for q, k, p in zip(blocks, ks, ps):
                bex.search(index, q, k, params=p)

        out = {}
        for name, fn in (("packed", packed), ("one_by_one", solo)):
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(20):
                a = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - a) * 1e3)
            out[name] = float(np.median(ts))
        out["rows"] = int(sum(m for m, _, _ in reqs))
        calls[n] = out
        print(f"executor alone, {n} requests ({out['rows']} rows): packed "
              f"{out['packed']:.3f} ms, one by one {out['one_by_one']:.3f} "
              "ms (host clock, median of 20)", flush=True)
    reqs = [draw(rng) for _ in range(6)]
    blocks = [queries[at:at + m] for m, at, _ in reqs]
    ks = [mix[j][1] for _, _, j in reqs]
    ps = [mix[j][0] for _, _, j in reqs]
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(200):
        rex.search_ragged(index, blocks, ks, params_list=ps)
    torch.cuda.synchronize()
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(18)
    print(buf.getvalue(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "serial_rps": rate, "turns": turns,
                      "executor": calls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
