#!/usr/bin/env python3
"""Drive raft_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--phases env,build,kernels,main,serve,times]

(add ",profile" to the phases for a torch.profiler breakdown of one
request of each kind; it is not in the default run)

Phases, each printing its own lines; any failure ends the run with a
non-zero exit (nothing is caught and passed over):

1. env      the card's name and power limit (nvidia-smi), torch/CUDA
            versions; TF32 is switched off for matmul and cuDNN.
2. build    compiles every CUDA kernel of the port from csrc/ (nvcc,
            sm_90a), one nvcc per source in parallel.
3. kernels  each kernel against its plain PyTorch version on the card:
            fused_knn over six metrics, k in {1, 10, 64}, q in {1, 10,
            500}, a ragged n, float32 and bfloat16; the IVF scan with
            sentinel probe slots, -1 padding, a 1-D filter and IP; the
            IVF scan's work items on a list of 1,300 rows (three row
            chunks) probed by most queries, short, empty and padded
            lists, batch 1, 10 and 500, k in {1, 10, 128}, d 128
            (float32 and bfloat16), 100, 33 and 300; the
            IVF-BQ scan over bits 1, 2, 3 (query bits 4, 4, 8), L2 and
            IP, d = 100 (padded lanes), k in {1, 10, 128}, a 1-D filter,
            sentinel and repeated probes and a query that probes
            nothing, at batch 1, 10 and 500 with the wrapper's cluster
            size and (k = 10) every cluster size it can choose;
            select_k over min and max, k in {1, 10, 33, 64, 128}, n in
            {2048, 16384, 100003}, ties, +-inf and NaN rows, all-equal
            rows, a row finite only in its last chunk, float32, bfloat16
            and float16; the CAGRA beam search on a 30,000 x 128 index
            built on the card (cluster-join, degree 64, its first 32
            columns as the degree-32 graph) over L2, L2Sqrt and IP,
            float32, bfloat16 and int8, k in {1, 10, 64}, itopk in {32,
            64, 128, 256, 512}, search_width in {1, 4}, q in {1, 10,
            500}, seeds with -1 holes, ragged row_iters with a 0, two
            random samplings, BQ traversal off and at bits 1 and 2, and
            every cluster size (1-16) forced at q 1, 10 and 90. Ids
            must be equal on integer-valued data (every product exact);
            on Gaussian data distances agree to |dd| <= 1e-4 (1 + |d|)
            and 99% of ids agree. The IVF-BQ scan and the beam search
            take every sum in their plain versions' order
            (ops/bq_scan.tree_sum): their distances, ids and counts
            (rows reranked per query; live iterations, candidates and
            rows scored per query) must equal the plain versions' bit
            for bit. The tiered scan (hot lists on the card, cold lists
            in pinned host memory) on integer-valued and Gaussian data,
            L2 and IP, k in {1, 10, 128}, q in {1, 10, 500}, sentinel
            and repeated probes, -1 padding, a 1-D filter, and splits of
            all-but-one hot, all-but-one cold and alternating, then
            rings smaller than the probed cold set (several waves), a
            request that probes no cold list and an index with no cold
            tier: it equals its plain version (ids exactly on integer
            data) and the all-device scan kernel on the un-split planes
            bit for bit, and stages each probed cold list once; a
            pageable or device cold plane is refused, by the wrapper and
            by the C entry. stream_read_sum over float32 and bfloat16,
            n in {1, 1000, 2^22}, d in {100, 128}: on integer data equal
            to its plain version and the float64 sum; on Gaussian data
            both within 1e-6 sum|x| of the float64 sum per column (the
            summation orders differ).
4. main     SIFT-1M's shape (1,000,000 x 128 float32, 10,000 queries,
            k=10) on clustered data made from --seed. The IVF-Flat path:
            brute-force ground truth through the fused kernel in
            500-query requests; IVF-Flat build (n_lists=1024, the
            sift-128-euclidean config); two same-seed balanced k-means
            fits of all 1M rows and a second IVF-Flat build, each
            torch.equal to the first; search at n_probes 32 and 128,
            batch 10 and 500 (recall@10, median ms per batch);
            n_probes=1024 equals brute force ties aside; save -> load ->
            search is bit-identical. The tiered path on the same index:
            build_tiered(hot_fraction=0.5) (build s, hot and cold bytes,
            the cold plane pinned and modeled host-resident, device
            memory grown by the hot tier only); searches at n_probes 32
            and 128, batch 10 and 500, each equal to the all-device
            search bit for bit (ids and distances), with recall@10,
            median ms, the cold bytes each request probes and the bytes
            and waves it staged (tier.cold_bytes_staged, each probed
            cold list once); one
            placement epoch (batch-500 traffic at the centers of two
            cold lists, probe_histogram window, plan_epoch(max_swaps=4),
            apply_plan(width=4)): both lists hot, tier.swap_bytes = 2 x
            swaps x block bytes, searches still bit-identical; the dual
            roofline (stream_read_sum over the hot plane: device memory
            GB/s; a timed pinned -> device copy of the cold plane: host
            link GB/s), the ring copy's rate (bytes staged by three
            batch-500 requests over their copies' device time, from
            torch.profiler) against the link roofline, and each
            request's hot and cold GB/s against them. The all-device
            scan must not launch
            during the tiered searches. The IVF-BQ path on the same data:
            ivf_bq.build (n_lists=1024, bits 1, the vector plane kept);
            the same four searches (recall@10, median ms, rows
            reranked as a share of rows probed), each request then
            held against the plain scan on distances, ids and rows
            reranked; n_probes=1024 recall
            on 1,000 queries; save -> load -> search bit-identical; and
            matrix.select_k(k=10) over a (64, 1,000,000) slab of squared
            distances equals brute force's ids, ties aside. The CAGRA
            path on the same data: cagra.build with the blobs-1M-128
            config's first raft_cagra entry (graph_degree 32,
            intermediate 64, cluster_join) plus bq_bits=1 (build s, -1
            share of the graph, index bytes; the build must launch the
            wide-row select_k kernel 0 times); two same-seed builds on
            the first 200,000 rows (a cut for the time limit) with
            equal graphs and planes; search at itopk 64 and
            128, search_width 4, batch 10 and 500 (recall@10, median
            ms), BQ traversal off; at itopk 64 with it on (recall, rows
            scored exactly as a share of candidates); save -> load ->
            search bit-identical. It fails below recall@10 0.90 at itopk
            128, batch 500, or when BQ-on recall falls more than 0.02
            under BQ-off. Each path
            runs with every launch counter set to 0 just before it, and
            each of its kernels must have launched.
5. serve    the serving path on main's indexes: a SearchExecutor each
            for IVF-Flat (n_probes 32 and 128), IVF-BQ (n_probes 128),
            CAGRA (itopk 64, search_width 4) and brute force, its plans
            captured as CUDA graphs on the ladder 8..512; 200 requests of
            1-500 rows (drawn from --seed) each equal bit for bit to the
            direct search, and no capture after warmup; the tiered index
            (eager plans) on 50 such requests; a DynamicBatcher over the
            IVF-Flat executor fed by drive_open_loop from four threads,
            every result equal to its direct search (p50/p99 latency and
            batch occupancy printed); then the direct, eager-executor and
            captured median ms of the batch-10 and batch-500 requests,
            the direct request's device-busy share (torch.profiler) and
            the captured request's graph replay time (CUDA events). Its
            launches (replays included) add to the kernels line's.
6. times    per kernel at the main path's shapes: kernel ms (CUDA
            events, median after warm-up), its plain version's ms, the
            bound (the larger of bytes over 3.35 TB/s, host-link bytes
            over 64 GB/s (PCIe Gen5 x16, one direction), and operations
            over their type's peak: float32 at 67 TFLOP/s, popcount and
            other int32 at 16 and 64 per clock per SM over 132 SMs at
            1.98 GHz; the H100 SXM's published figures) and one PyTorch
            yardstick call's ms. The tiered scan's hot and cold GB/s
            are printed against the two rooflines of the main phase; the
            IVF-BQ scan is timed at every cluster size at batch 10 and
            500; the IVF scan and the beam walk also at batch 10 (the
            walk with its cluster size at both batches), matrix.select_k
            (AUTO) at the CAGRA build's shape and select_k at the main
            path's (64, 1,000,000), k = 10 slab; fused_knn on float32
            (bound: 3xTF32, three TF32 tensor-core products a multiply-add,
            at 494.7 TFLOP/s, the CUDA-core figure beside it) and on the
            same rows in bfloat16 (bf16 products at 989.4 TFLOP/s); the
            redesigned kernels print their earlier design's times beside
            theirs.
7. profile  (not in the default run) torch.profiler over five requests
            of each kind, the brute-force request first: device time by
            kernel name, and select_k's split between its memset and its
            kernel at the main path's call and at 64 x 2^20.

The line before the last is a JSON object with one record per kernel
(fused_knn, list_major_scan, bq_scan, select_k, beam_search, tier_scan,
stream_read_sum);
the last line is {"ok": true, "device": {...}}. Without a CUDA device,
or without the raft_tpu_torch package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
# PCIe Gen5 x16, one direction: half of the data sheet's 128 GB/s, which
# counts both
HOST_LINK_BYTES_PER_S = 64e9
# operations per second by type: float32 outside the tensor cores (data
# sheet); __popc and other 32-bit integer ops at 16 and 64 per clock per
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) over the SXM part's 132 SMs at its 1.98 GHz
# boost clock
_SM_CLOCKS_PER_S = 132 * 1.98e9
# and the dense tensor-core rates of the data sheet: TF32 494.7 TFLOP/s,
# bf16 989.4 TFLOP/s
PEAK_OPS_PER_S = {"f32": 67e12, "popc": 16 * _SM_CLOCKS_PER_S,
                  "int32": 64 * _SM_CLOCKS_PER_S, "tf32": 494.7e12,
                  "bf16": 989.4e12}
N_ROWS, DIM, N_QUERIES, K = 1_000_000, 128, 10_000, 10
N_LISTS = 1024
# the kernels' times in their earlier design (one block a query; cold rows
# read in place from pinned memory), at the same requests, as PERF.md
# records them (NVIDIA H100 80GB HBM3 at 700 W): bq_scan at n_probes 128
# by batch (torch.profiler at batch 10, CUDA events at batch 500),
# tier_scan at n_probes 128, batch 500
EARLIER_BQ_MS = {10: 9.5415, 500: 12.6976}
EARLIER_TIER_MS = 28.2238
# the IVF-Flat scan and the beam walk before their redesign, at n_probes
# 128 / itopk 64, batch 500 (PERF.md, the same card)
EARLIER_SCAN_MS = 6.2678
EARLIER_BEAM_MS = 0.3397
# fused_knn (CUDA-core products) at the brute-force request and select_k
# (one warp insertion a value) at its two shapes, k = 64, before their
# redesign (PERF.md, the same card)
EARLIER_KNN_MS = 7.9003
EARLIER_SELECT_MS = {"64x2^20": 0.5834, "2048x2048": 0.2145}
# the rows of the second CAGRA build that checks reproducibility: a cut of
# the 1M rows that keeps the run inside its time limit
CAGRA_REPRO_ROWS = 200_000


def cagra_params(cagra):
    """The blobs-1M-128 config's first raft_cagra entry, with bq_bits=1."""
    return cagra.CagraIndexParams(
        graph_degree=32, intermediate_graph_degree=64,
        build_algo=cagra.BuildAlgo.CLUSTER_JOIN, bq_bits=1)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call device times (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
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


def compare(name, got, want, exact_ids: bool):
    """Kernel (got) vs plain version (want): returns max |dd| over
    finite slots; fails on a mismatch beyond the stated tolerance."""
    import torch

    gd, gi = got
    wd, wi = want
    torch.cuda.synchronize()
    if gd.shape != wd.shape or gi.shape != wi.shape:
        fail(f"{name}: shape {tuple(gd.shape)} vs {tuple(wd.shape)}")
    fin = torch.isfinite(wd)
    if not torch.equal(fin, torch.isfinite(gd)):
        fail(f"{name}: filled slots differ")
    if not torch.equal(gd[~fin], wd[~fin]):
        fail(f"{name}: unfilled slots differ")
    err = (gd[fin] - wd[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    tol = 1e-4 * (1.0 + wd[fin].abs())
    if bool((err > tol).any()):
        fail(f"{name}: distance error {max_err} beyond 1e-4 (1 + |d|)")
    if exact_ids:
        if not torch.equal(gi, wi):
            bad = int((gi != wi).sum())
            fail(f"{name}: {bad} ids differ on integer-valued data")
    elif float((gi == wi).float().mean()) < 0.99:
        fail(f"{name}: fewer than 99% of ids agree")
    return max_err


# ---------------------------------------------------------------------------


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    log(card)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")
    log(f"[env] allow_tf32 before: matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log("[env] allow_tf32 set: matmul=False cudnn=False")
    return {"card": card}


def phase_build() -> None:
    from raft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        with open(path + ".log") as f:
            usage = [ln.strip() for ln in f if "registers" in ln]
        for ln in usage:
            log(f"[build] {name}: {ln}")
        _build.load(name)


def _int_data(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, shape).astype(np.float32)


def phase_kernels(torch, seed: int) -> None:
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.ops.fused_topk import (
        _SUPPORTED_METRICS,
        fused_knn,
        fused_knn_plain,
    )
    from raft_tpu_torch.ops.ivf_scan import list_major_scan

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n, d = 20_011, 128          # ragged: not a multiple of any tile
    checks = 0
    # integer-valued data: +-1 entries give every row the same norm, so
    # cosine orders exactly by the (exact) inner product, and many exact
    # ties test the smallest-id order; duplicate rows included
    x_int = np.where(rng.random((n, d)) < 0.5, -1.0, 1.0).astype(np.float32)
    x_int[777] = x_int[5]
    x_int[19_000] = x_int[5]
    q_int = np.where(rng.random((500, d)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    q_int[0] = x_int[5]         # distance 0 to three duplicate rows
    x_g = rng.standard_normal((n, d)).astype(np.float32)
    q_g = rng.standard_normal((500, d)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        for data, queries, exact in ((x_int, q_int, True), (x_g, q_g, False)):
            xt = torch.from_numpy(data).to(dev, dtype)
            for metric in _SUPPORTED_METRICS:
                for k in (1, 10, 64):
                    for q in (1, 10, 500):
                        qt = torch.from_numpy(queries[:q]).to(dev)
                        got = fused_knn(qt, xt, k, metric)
                        torch.cuda.synchronize()
                        want = fused_knn_plain(qt, xt, k, metric)
                        compare(f"fused_knn {metric.name} {dtype} k={k} "
                                f"q={q} exact={exact}", got, want, exact)
                        checks += 1
    log(f"[kernels] fused_knn: {checks} cases agree with the plain version")

    # IVF scan on a small packed index: 64 lists with -1 padding
    from raft_tpu_torch.neighbors._packing import pack_padded_lists, padded_extent

    n_lists, ns = 64, 12_000
    labels = torch.from_numpy(rng.integers(0, n_lists, ns)).to(dev)
    sizes = torch.bincount(labels, minlength=n_lists)
    m = padded_extent(sizes)
    cases = 0
    for data, exact in ((_int_data(rng, (ns, d)), True),
                        (rng.standard_normal((ns, d)).astype(np.float32),
                         False)):
        data[100] = data[7]
        ids = torch.arange(ns, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            (packed, indices), _ = pack_padded_lists(
                labels, n_lists, m,
                [(torch.from_numpy(data).to(dev, dtype), 0), (ids, -1)])
            pf = packed.to(torch.float32)
            norms = torch.where(indices >= 0, (pf * pf).sum(dim=2),
                                torch.full_like(indices, float("inf"),
                                                dtype=torch.float32))
            qf = torch.from_numpy(data[:300] + 0.5 if exact else
                                  data[:300] * 0.9).to(dev)
            probes = torch.from_numpy(
                rng.integers(0, n_lists, (300, 12))).to(dev, torch.int32)
            probes[::3, 5:] = n_lists                 # sentinel slots
            probes[1, 1] = probes[1, 0]               # repeated probe
            filt = torch.from_numpy(
                rng.integers(0, 2**31, -(-ns // 32))).to(dev, torch.int32)
            for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
                for fw in (None, filt):
                    for k in (1, 10, 128):
                        args = (qf, packed, norms, indices, probes, fw)
                        got = list_major_scan(*args, k=k, metric=metric,
                                              engine="cuda")
                        torch.cuda.synchronize()
                        want = list_major_scan(*args, k=k, metric=metric,
                                               engine="torch")
                        compare(f"list_major_scan {metric.name} {dtype} "
                                f"k={k} filter={fw is not None} "
                                f"exact={exact}", got, want, exact)
                        cases += 1
    log(f"[kernels] list_major_scan: {cases} cases agree with the plain "
        "version")
    kernels_scan_items(torch, seed)
    kernels_bq(torch, seed)
    kernels_select(torch, seed)
    kernels_beam(torch, seed)
    kernels_tier(torch, seed)
    kernels_stream(torch, seed)


def kernels_scan_items(torch, seed: int) -> None:
    """The IVF scan's work items across their shapes, on integer data
    (exact ids): a list of 1,300 rows (three 512-row chunks) probed by
    most queries (several query groups), short, empty and padded lists,
    batch 1, 10 and 500 (narrow and wide items), k in {1, 10, 128}, d
    128 (float32 and bfloat16), 100, 33 (element copies) and 300 (queries
    staged a stage at a time), L2 and IP."""
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.ops.ivf_scan import list_major_scan

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 9)
    sizes = [1300, 7, 0, 515, 64, 0, 200, 33]
    n_lists, m = len(sizes), max(sizes) + 9
    cases = 0
    for d, dtype in ((128, torch.float32), (128, torch.bfloat16),
                     (100, torch.float32), (33, torch.float32),
                     (300, torch.float32)):
        data = np.zeros((n_lists, m, d), np.float32)
        indices = np.full((n_lists, m), -1, np.int32)
        row = 0
        for lid, size in enumerate(sizes):
            data[lid, :size] = rng.integers(-3, 4, (size, d))
            indices[lid, :size] = np.arange(row, row + size)
            row += size
        pt = torch.from_numpy(data).to(dev, dtype)
        it = torch.from_numpy(indices).to(dev)
        pf = pt.to(torch.float32)
        norms = torch.where(it >= 0, (pf * pf).sum(dim=2),
                            torch.full_like(it, float("inf"),
                                            dtype=torch.float32))
        for q in (1, 10, 500):
            qf = torch.from_numpy(rng.integers(-3, 4, (q, d)).astype(
                np.float32)).to(dev)
            probes = rng.integers(0, n_lists, (q, 5)).astype(np.int32)
            probes[: q * 3 // 4, 0] = 0
            probes[::5, 3:] = n_lists
            probes = torch.from_numpy(probes).to(dev)
            for metric in (DistanceType.L2Expanded,
                           DistanceType.InnerProduct):
                for k in (1, 10, 128):
                    args = (qf, pt, norms, it, probes, None)
                    got = list_major_scan(*args, k=k, metric=metric,
                                          engine="cuda")
                    torch.cuda.synchronize()
                    want = list_major_scan(*args, k=k, metric=metric,
                                           engine="torch")
                    compare(f"list_major_scan items d={d} {dtype} q={q} "
                            f"k={k} {metric.name}", got, want, True)
                    cases += 1
    log(f"[kernels] list_major_scan work items: {cases} cases (long, short "
        "and empty lists, narrow and wide items, d 33-300) agree with the "
        "plain version, ids exactly")


def kernels_bq(torch, seed: int) -> None:
    """The IVF-BQ scan kernel against its plain version on a small index
    built on the card: d = 100, so dim_ext = 128 has padded lanes."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import ivf_bq
    from raft_tpu_torch.ops.bq_scan import auto_query_bits, bq_list_major_scan

    from raft_tpu_torch.ops.bq_scan import CLUSTER_SIZES, _bq_scan_cuda

    dev = torch.device("cuda")
    res = Resources(device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 1)
    n, d, n_lists, nq = 20_000, 100, 64, 500
    centers = rng.standard_normal((40, d)) * 3
    x = (centers[rng.integers(0, 40, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    qf = torch.from_numpy((centers[rng.integers(0, 40, nq)]
                           + rng.standard_normal((nq, d))).astype(
                               np.float32)).to(dev)
    probes = torch.from_numpy(rng.integers(0, n_lists, (nq, 12))).to(
        dev, torch.int32)
    probes[::3, 6:] = n_lists                     # sentinel slots
    probes[1, 1] = probes[1, 0]                   # repeated probe
    probes[4, :] = n_lists                        # a query probing nothing
    filt = torch.from_numpy(rng.integers(0, 2**31, -(-n // 32))).to(
        dev, torch.int32)
    cases = rows = 0
    chosen = {}
    for bits in (1, 2, 3):
        for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
            idx = ivf_bq.build(res, ivf_bq.IvfBqIndexParams(
                n_lists=n_lists, bits=bits, metric=metric), x)
            if idx.dim_ext != 128 or idx.size != n:
                fail(f"ivf_bq.build: dim_ext {idx.dim_ext}, size {idx.size}")
            qrot = qf @ idx.rotation.T
            crot = idx.centers @ idx.rotation.T
            for fw in (None, filt):
                args = (qf, qrot, crot, idx.codes, idx.rnorm, idx.cfac,
                        idx.errw, idx.indices, idx.data, idx.data_norms,
                        probes, fw)
                for k in (1, 10, 128):
                    kw = dict(k=k, metric=metric, epsilon=3.0,
                              query_bits=auto_query_bits(bits))
                    want = bq_list_major_scan(*args, engine="torch", **kw)
                    name = (f"bq_scan bits={bits} {metric.name} k={k} "
                            f"filter={fw is not None}")
                    # the wrapper's own cluster size at batch 1, 10, 500;
                    # at k = 10 every cluster size it can choose too
                    sizes = [None] + (list(CLUSTER_SIZES) if k == 10 else [])
                    for q in (1, 10, nq):
                        sub = [a[:q] if i in (0, 1, 10) else a
                               for i, a in enumerate(args)]
                        want_q = (want if q == nq else bq_list_major_scan(
                            *sub, engine="torch", **kw))
                        for c in sizes:
                            got = (bq_list_major_scan(*sub, engine="cuda",
                                                      **kw) if c is None
                                   else _bq_scan_cuda(*sub, cluster=c, **kw))
                            used = bq_list_major_scan.last_cluster
                            if c is None:
                                chosen[q] = used
                            elif used != c:
                                fail(f"{name} q={q}: cluster {c} asked, "
                                     f"{used} launched")
                            bq_equal(f"{name} q={q} cluster={used}", got,
                                     want_q)
                            if q > 4 and int(got[2][4]) != 0:
                                fail(f"{name}: a query that probes nothing "
                                     "reranked rows")
                            cases += 1
                            rows += int(got[2].sum())
    if chosen[10] <= 1:
        fail(f"bq_scan at batch 10 launched a cluster of {chosen[10]}")
    log(f"[kernels] bq_scan: {cases} cases equal the plain version bit for "
        f"bit ({rows} rows reranked in all, the same count per query); "
        f"every cluster size {list(CLUSTER_SIZES)} at batch 1, 10 and {nq}; "
        f"the wrapper chose clusters of {chosen} CTAs by batch")


def bq_equal(name, got, want) -> float:
    """The IVF-BQ kernel's (distances, ids, rows reranked per query)
    against its plain version's: all three must be equal. Returns the
    measured max |dd| over the filled slots."""
    import torch

    torch.cuda.synchronize()
    for what, g, w in zip(("distances", "ids", "rows reranked"), got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            fail(f"{name}: {bad} {what} differ from the plain version")
    fin = torch.isfinite(want[0])
    err = (got[0][fin] - want[0][fin]).abs()
    return float(err.max()) if err.numel() else 0.0


def kernels_select(torch, seed: int) -> None:
    """The select_k kernel against its plain version: integer values (many
    exact ties), rows short of finite values, NaN, all-equal rows, a row
    finite only in its last chunk; float32, bfloat16 and float16; narrow
    rows (a warp a row) and wide ones (blocks a row, merged by the last)."""
    from raft_tpu_torch.ops.fused_topk import (
        _select_plan,
        select_k_tiles,
        select_k_tiles_plain,
    )

    rng = np.random.default_rng(seed + 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = 0
    for n in (2048, 16_384, 100_003):
        base = rng.integers(-1000, 1000, (40, n)).astype(np.float32)
        splits, chunk = _select_plan(40, n, sms)
        for select_min in (True, False):
            v = base.copy()
            far = np.inf if select_min else -np.inf
            v[3, 7:] = far                        # 7 finite values only
            v[4, ::5] = np.nan
            v[5, :] = -far                        # never enters
            v[6, :] = 5.0                         # all equal
            v[7, :(splits - 1) * chunk] = far     # finite in the last chunk
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                vt = torch.from_numpy(v).to("cuda", dtype)
                for k in (1, 10, 33, 64, 128):
                    got = select_k_tiles(vt, k, select_min)
                    torch.cuda.synchronize()
                    want = select_k_tiles_plain(vt, k, select_min)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        fail(f"select_k n={n} k={k} min={select_min} "
                             f"{dtype}: differs from the plain version")
                    cases += 1
    log(f"[kernels] select_k: {cases} cases equal the plain version")


def beam_equal(name, got, want) -> float:
    """The beam kernel's (distances, ids, counts) against its plain
    version's: all three must be equal. Returns the measured max |dd|
    over the filled slots."""
    import torch

    torch.cuda.synchronize()
    for what, g, w in zip(("distances", "ids", "counts"), got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            fail(f"{name}: {bad} {what} differ from the plain version")
    fin = torch.isfinite(want[0])
    err = (got[0][fin] - want[0][fin]).abs()
    return float(err.max()) if err.numel() else 0.0


def kernels_beam(torch, seed: int) -> None:
    """The CAGRA beam kernel against its plain version on a 30,000 x 128
    clustered index built on the card: every metric, dataset type, k,
    itopk, width, degree and batch size of the contract, covered in
    rotation, with real coarse seeds (-1 holes punched in), ragged
    budgets and the BQ plane at bits 1 and 2."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops.beam_search import beam_search, beam_search_plain
    from raft_tpu_torch.ops.bq_scan import auto_query_bits

    res = Resources(device="cuda", seed=seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 3)
    n, d = 30_000, 128
    centers = torch.randn(300, d, generator=g, device="cuda") * 1.5
    lab = torch.randint(0, 300, (n + 500,), generator=g, device="cuda")
    pts = centers[lab] + torch.randn(n + 500, d, generator=g, device="cuda")
    x, qx = pts[:n].contiguous(), pts[n:].contiguous()
    index = cagra.build(res, cagra.CagraIndexParams(
        graph_degree=64, intermediate_graph_degree=128,
        build_algo=cagra.BuildAlgo.CLUSTER_JOIN), x)
    scale = 127.0 / float(x.abs().max())
    datasets = {torch.float32: (x, qx), torch.bfloat16: (x.to(torch.bfloat16),
                                                         qx),
                torch.int8: (torch.round(x * scale).to(torch.int8),
                             qx * scale)}
    planes = {}
    metrics = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.InnerProduct)
    itopks, ks, qs = (32, 64, 128, 256, 512), (1, 10, 64), (1, 10, 500)
    shapes = ((1, 32), (4, 32), (1, 64), (4, 64))
    cases = i = 0
    walked = scored = fresh = 0
    for dtype, (data, queries) in datasets.items():
        for metric in metrics:
            for _ in range(3):
                L, k = itopks[i % 5], min(ks[(i // 2) % 3], itopks[i % 5])
                w, deg = shapes[i % 4]
                q = qs[(i // 3) % 3]
                bits = (0, 1, 2)[(i // 4) % 3]
                samplings = 2 if i % 5 == 1 else 1
                i += 1
                qt = queries[:q]
                c = w * deg
                n_seeds = -(-max(L, c) * samplings // c) * c
                seeds = cagra._make_seeds(
                    data, index.seed_centers, index.seed_members, qt,
                    n_seeds, metric, "coarse", 0)
                seeds[:, 1::5] = -1                   # holes in the seeds
                max_iters = L // w + 24
                kw = dict(deg=deg)
                if q > 1 and i % 2 == 0:              # ragged, one 0 budget
                    ri = torch.randint(0, max_iters, (q,), generator=g,
                                       device="cuda", dtype=torch.int32)
                    ri[0] = 0
                    kw["row_iters"] = ri
                if bits:
                    key = (dtype, bits)
                    if key not in planes:
                        planes[key] = cagra._build_bq_plane(
                            data.to(torch.float32), bits, seed)
                    rot, crot, recs = planes[key]
                    kw.update(bq_records=recs, bq_qrot=qt @ rot.T,
                              bq_crot=crot, bq_bits=bits,
                              bq_query_bits=auto_query_bits(bits))
                args = (qt, data, index.graph, seeds, k, L, w, max_iters,
                        metric)
                got = beam_search(*args, **kw)
                torch.cuda.synchronize()
                want = beam_search_plain(*args, **kw)
                beam_equal(f"beam_search {metric.name} {dtype} k={k} L={L} "
                           f"w={w} deg={deg} q={q} bits={bits} "
                           f"samplings={samplings} "
                           f"ragged={'row_iters' in kw}", got, want)
                cases += 1
                walked += int(want[2][:, 0].sum())
                fresh += int(want[2][:, 1].sum())
                scored += int(want[2][:, 2].sum())
    log(f"[kernels] beam_search: {cases} cases equal the plain version bit "
        f"for bit ({walked} iterations, {fresh} candidates, {scored} rows "
        "scored in all, the same counts per query)")
    # every cluster size the kernel takes, forced, exact and BQ traversal
    from raft_tpu_torch.ops import beam_search as bs

    data, queries = datasets[torch.float32]
    metric = DistanceType.L2Expanded
    sizes = set()
    for bits in (0, 1):
        for q in (1, 10, 90):
            qt = queries[:q]
            seeds = cagra._make_seeds(data, index.seed_centers,
                                      index.seed_members, qt, 256, metric,
                                      "coarse", 0)
            kw = dict(row_iters=None, bq_records=None, bq_qrot=None,
                      bq_crot=None, bq_bits=0, bq_query_bits=4,
                      bq_epsilon=3.0, deg=64)
            if bits:
                rot, crot, recs = planes.get((torch.float32, 1)) or \
                    cagra._build_bq_plane(data, 1, seed)
                kw.update(bq_records=recs, bq_qrot=qt @ rot.T, bq_crot=crot,
                          bq_bits=1, bq_query_bits=auto_query_bits(1))
            args = (qt, data, index.graph, seeds, 10, 128, 4, 56, metric)
            checked = bs._check_args(*args[:7], metric, 64, None,
                                     kw["bq_records"], kw["bq_qrot"],
                                     kw["bq_crot"], kw["bq_bits"])
            want = bs.beam_search_plain(*args, **kw)
            for c in bs.CLUSTER_SIZES:
                got = bs._beam_search_cuda(*args, checked, cluster=c, **kw)
                sizes.add(bs.beam_search.last_cluster)
                beam_equal(f"beam_search cluster={c} q={q} bits={bits}", got,
                           want)
                cases += 1
    log(f"[kernels] beam_search: every cluster size {sorted(sizes)} equals "
        f"the plain version bit for bit ({cases} cases in all)")


def _split_tiers(torch, data, hot_lists, cold_lists):
    """A tiered split of a packed (n_lists, m, d) plane on the card: the
    hot lists' blocks stay on the card, the cold lists' go to pinned host
    memory; with the slot maps."""
    from raft_tpu_torch.neighbors.tiered import _slot_maps

    hmap, cmap = _slot_maps(np.asarray(hot_lists), np.asarray(cold_lists),
                            data.shape[0])
    idx = torch.as_tensor(np.asarray(hot_lists), device=data.device)
    cdx = torch.as_tensor(np.asarray(cold_lists), device=data.device)
    return (data[idx].contiguous(), data[cdx].cpu().pin_memory(),
            torch.from_numpy(hmap).to(data.device),
            torch.from_numpy(cmap).to(data.device))


def kernels_tier(torch, seed: int) -> None:
    """The tiered scan kernel against its plain version and against the
    all-device scan kernel on the un-split planes, on a 64-list packed
    index with -1 padding; then a pageable and a device cold plane, which
    the wrapper and the C entry must refuse."""
    from raft_tpu_torch.core.validation import RaftError
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors._packing import pack_padded_lists, padded_extent
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 4)
    n_lists, ns, d = 64, 12_000, 128
    labels = torch.from_numpy(rng.integers(0, n_lists, ns)).to(dev)
    m = padded_extent(torch.bincount(labels, minlength=n_lists))
    ids = torch.arange(ns, dtype=torch.int32, device=dev)
    probes = torch.from_numpy(rng.integers(0, n_lists, (500, 12))).to(
        dev, torch.int32)
    probes[::3, 5:] = n_lists                     # sentinel slots
    probes[1, 1] = probes[1, 0]                   # repeated probe
    filt = torch.from_numpy(rng.integers(0, 2**31, -(-ns // 32))).to(
        dev, torch.int32)
    lists = np.arange(n_lists)
    splits = {"alternate": (lists[::2], lists[1::2]),
              "all-but-one hot": (lists[1:], lists[:1]),
              "all-but-one cold": (lists[7:8], np.delete(lists, 7))}
    kq_all = [(k, q) for k in (1, 10, 128) for q in (1, 10, 500)]
    kq_few = [(1, 500), (10, 10), (128, 1)]
    cases = 0
    for exact in (True, False):
        data = (_int_data(rng, (ns, d)) if exact
                else rng.standard_normal((ns, d)).astype(np.float32))
        data[100] = data[7]
        (packed, indices), _ = pack_padded_lists(
            labels, n_lists, m, [(torch.from_numpy(data).to(dev), 0),
                                 (ids, -1)])
        norms = torch.where(indices >= 0, (packed * packed).sum(dim=2),
                            torch.full_like(indices, float("inf"),
                                            dtype=torch.float32))
        qf = torch.from_numpy(data[:500] + 0.5 if exact
                              else data[:500] * 0.9).to(dev)
        for split, (hot_lists, cold_lists) in splits.items():
            hot, cold, hmap, cmap = _split_tiers(torch, packed, hot_lists,
                                                 cold_lists)
            for metric in (DistanceType.L2Expanded,
                           DistanceType.InnerProduct):
                for fw in (None, filt):
                    for k, q in (kq_all if split == "alternate" else kq_few):
                        args = (qf[:q], hot, cold, hmap, cmap, norms,
                                indices, probes[:q], fw)
                        name = (f"tier_scan {split} {metric.name} k={k} "
                                f"q={q} filter={fw is not None} "
                                f"exact={exact}")
                        got = tiered_list_major_scan(*args, k=k,
                                                     metric=metric,
                                                     engine="cuda")
                        whole = list_major_scan(
                            qf[:q], packed, norms, indices, probes[:q], fw,
                            k=k, metric=metric, engine="cuda")
                        torch.cuda.synchronize()
                        if not (torch.equal(got[0], whole[0])
                                and torch.equal(got[1], whole[1])):
                            fail(f"{name}: differs from the all-device scan "
                                 "kernel on the un-split planes")
                        want = tiered_list_major_scan(*args, k=k,
                                                      metric=metric,
                                                      engine="torch")
                        compare(name, got, want, exact)
                        cases += 1
    staged = kernels_tier_staging(torch, packed, norms, indices, qf, probes,
                                  filt)
    # a cold plane that is not page-locked host memory is refused
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for what, bad in (("pageable", cold.clone()), ("device", cold.to(dev))):
        try:
            tiered_list_major_scan(qf, hot, bad, hmap, cmap, norms, indices,
                                   probes, k=10,
                                   metric=DistanceType.L2Expanded,
                                   engine="cuda")
        except RaftError:
            pass
        else:
            fail(f"tier_scan took a {what} cold plane")
        err = _build.load("tier_scan")(
            z.data_ptr(), hot.data_ptr(), bad.data_ptr(),
            *[z.data_ptr()] * 16, 1, 1, 1, 1, 1, 0, 0, 0, 0,
            *[z.data_ptr()] * 9, stream, stream, None)
        if err == 0:
            fail(f"the tier_scan C entry took a {what} cold plane")
    log(f"[kernels] tier_scan: {cases} cases and {staged} staging cases "
        "equal the all-device scan kernel bit for bit and agree with the "
        "plain version; pageable and device cold planes refused by the "
        "wrapper and the C entry")


def kernels_tier_staging(torch, packed, norms, indices, qf, probes,
                         filt) -> int:
    """The staging edge cases of the tiered scan on integer-valued data:
    rings smaller than the probed cold set (waves of one list and of
    three), a request that probes no cold list, and an index with no
    cold tier. Each must equal the all-device kernel and the plain
    version bit for bit and stage each probed cold list once, its live
    rows rounded up to the 64-row tile."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.ops.ivf_scan import list_major_scan, live_rows
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    n_lists, m, d = packed.shape
    lists = np.arange(n_lists)
    real = live_rows(indices).cpu().numpy()
    tile_rows = np.minimum(-(-real // 64) * 64, m)
    big = int(tile_rows.max()) * d * 4
    cases = {
        "waves of one list": (lists[::2], lists[1::2], 2 * big, probes),
        "waves of three lists": (lists[::2], lists[1::2], 7 * big, probes),
        "no cold list probed": (lists[::2], lists[1::2], 1 << 31,
                                (probes // 2) * 2),   # even lists only
        "no cold tier": (lists, lists[:0], 1 << 31, probes),
    }
    n = 0
    for name, (hot_lists, cold_lists, ws, pr) in cases.items():
        hot, cold, hmap, cmap = _split_tiers(torch, packed, hot_lists,
                                             cold_lists)
        cold_probed = sorted(set(pr.flatten().tolist()) & set(
            cold_lists.tolist()))
        for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
            for q in (10, 500):
                args = (qf[:q], hot, cold, hmap, cmap, norms, indices,
                        pr[:q], None)
                c0 = tracing.counters("tier.")
                got = tiered_list_major_scan(*args, k=10, metric=metric,
                                             engine="cuda",
                                             workspace_bytes=ws)
                c1 = tracing.counters("tier.")
                delta = {key: c1[key] - c0.get(key, 0.0) for key in c1}
                whole = list_major_scan(qf[:q], packed, norms, indices,
                                        pr[:q], None, k=10, metric=metric,
                                        engine="cuda")
                torch.cuda.synchronize()
                label = f"tier_scan {name} {metric.name} q={q}"
                if not (torch.equal(got[0], whole[0])
                        and torch.equal(got[1], whole[1])):
                    fail(f"{label}: differs from the all-device scan kernel")
                compare(label, got, tiered_list_major_scan(
                    *args, k=10, metric=metric, engine="torch"), True)
                probed = sorted(set(pr[:q].flatten().tolist())
                                & set(cold_probed))
                want_bytes = int(tile_rows[probed].sum()) * d * 4
                if (delta.get("tier.cold_lists_staged", 0) != len(probed)
                        or delta.get("tier.cold_bytes_staged", 0)
                        != want_bytes):
                    fail(f"{label}: staged {delta} for {len(probed)} probed "
                         f"cold lists of {want_bytes} bytes")
                waves = delta.get("tier.stage_waves", 0)
                if name.startswith("waves") and q == 500 and waves < 3:
                    fail(f"{label}: {waves} waves, not several")
                if not probed and waves != 0:
                    fail(f"{label}: {waves} waves without a cold list")
                n += 1
    return n


def kernels_stream(torch, seed: int) -> None:
    """stream_read_sum against its plain version and the float64 sum:
    integer data exactly (every partial sum is an integer below 2^24,
    exact in any order), Gaussian data within 1e-6 sum|x| per column."""
    from raft_tpu_torch.ops.fused_topk import (
        stream_read_sum,
        stream_read_sum_plain,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 5)
    cases = 0
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 1000, 1 << 22):
            for d in (100, 128):
                for exact in (True, False):
                    x = (torch.randint(-3, 4, (n, d), generator=g,
                                       device="cuda").float() if exact
                         else torch.randn(n, d, generator=g, device="cuda"))
                    x = x.to(dtype)
                    got = stream_read_sum(x)
                    want = stream_read_sum_plain(x)
                    ref = x.double().sum(dim=0, keepdim=True)
                    name = f"stream_read_sum {dtype} n={n} d={d}"
                    if exact:
                        if not (torch.equal(got, want)
                                and torch.equal(got.double(), ref)):
                            fail(f"{name}: integer sums differ")
                    else:
                        scale = x.double().abs().sum(dim=0, keepdim=True)
                        for what, v in (("kernel", got), ("plain", want)):
                            e = (v.double() - ref).abs() / scale
                            if bool((e > 1e-6).any()):
                                fail(f"{name}: {what} off the float64 sum "
                                     "by more than 1e-6 sum|x|")
                        worst = max(worst, float(
                            ((got.double() - ref).abs() / scale).max()))
                    if not torch.equal(stream_read_sum(x), got):
                        fail(f"{name}: differs from run to run")
                    cases += 1
    log(f"[kernels] stream_read_sum: {cases} cases; integer data equal to "
        "the plain version and the float64 sum, Gaussian data within "
        f"{worst:.3g} sum|x| of the float64 sum (limit 1e-6); the same "
        "result run to run")


def make_data(torch, seed: int):
    """Clustered float32 data at SIFT-1M's shape, made on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    centers = torch.randn(4096, DIM, generator=g, device="cuda") * 1.5
    lab = torch.randint(0, 4096, (N_ROWS + N_QUERIES,), generator=g,
                        device="cuda")
    pts = centers[lab] + torch.randn(N_ROWS + N_QUERIES, DIM, generator=g,
                                     device="cuda")
    return pts[:N_ROWS].contiguous(), pts[N_ROWS:].contiguous()


def recall(ids, truth) -> float:
    hit = (ids[:, :, None] == truth[:, None, :]).any(dim=2)
    return float(hit.float().mean())


def _counted():
    """Every kernel wrapper's launch counter: name -> wrapper."""
    from raft_tpu_torch.ops.beam_search import beam_search
    from raft_tpu_torch.ops.bq_scan import bq_list_major_scan
    from raft_tpu_torch.ops.fused_topk import (
        fused_knn,
        select_k_tiles,
        stream_read_sum,
    )
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    return {"fused_knn": fused_knn, "list_major_scan": list_major_scan,
            "bq_scan": bq_list_major_scan, "select_k": select_k_tiles,
            "beam_search": beam_search, "tier_scan": tiered_list_major_scan,
            "stream_read_sum": stream_read_sum}


def reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_launches(names, path: str) -> dict:
    """The counts of a path's kernels just after it ran; fails if one of
    them never launched."""
    counts = {name: fn.launches for name, fn in _counted().items()}
    log(f"[main] launches on the {path} path: {counts}")
    for name in names:
        if counts[name] <= 0:
            fail(f"{name} was never launched on the {path} path")
    return {name: counts[name] for name in names}


def bq_scan_run(index, queries, n_probes: int, engine: str):
    """(distances, ids, rows reranked per query) of an IVF-BQ search body
    run with ``engine``."""
    from raft_tpu_torch.neighbors import ivf_bq

    _, arrays, static = ivf_bq.serving_plan(ivf_bq.IvfBqSearchParams(
        n_probes=n_probes, scan_engine=engine), index, K)
    return ivf_bq._search_arrays(queries, *arrays, None, **static)[:3]


def phase_main(torch, seed: int, state: dict) -> None:
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import brute_force, ivf_flat

    res = Resources(device="cuda", seed=seed)
    t0 = time.perf_counter()
    x, queries = make_data(torch, seed)
    torch.cuda.synchronize()
    log(f"[main] data {tuple(x.shape)} queries {tuple(queries.shape)} made "
        f"in {time.perf_counter() - t0:.2f} s (seed {seed})")

    reset_launches()
    bf = brute_force.build(res, x)
    t0 = time.perf_counter()
    parts = [brute_force.search(res, bf, queries[s:s + 500], K)
             for s in range(0, N_QUERIES, 500)]
    gt_d = torch.cat([p[0] for p in parts])
    gt_i = torch.cat([p[1] for p in parts])
    torch.cuda.synchronize()
    log(f"[main] brute force ground truth: {N_QUERIES // 500} requests of "
        f"500 in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    index = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS),
                           x)
    torch.cuda.synchronize()
    sizes = index.list_sizes.to(torch.float32)
    log(f"[main] ivf_flat.build n_lists={N_LISTS}: "
        f"{time.perf_counter() - t0:.2f} s, max_list_size "
        f"{index.max_list_size}, size {index.size}, list sizes min "
        f"{int(sizes.min())} median {int(sizes.median())} max "
        f"{int(sizes.max())}")
    if index.size != N_ROWS:
        fail(f"ivf_flat.build indexed {index.size} rows")

    for n_probes in (32, 128):
        sp = ivf_flat.IvfFlatSearchParams(n_probes=n_probes)
        for batch, n_q in ((10, 1000), (500, N_QUERIES)):
            outs, times = [], []
            for s in range(0, n_q, batch):
                t1 = time.perf_counter()
                outs.append(ivf_flat.search(res, sp, index,
                                            queries[s:s + batch], K))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            ids = torch.cat([o[1] for o in outs])
            r = recall(ids, gt_i[:n_q])
            log(f"[main] ivf_flat.search n_probes={n_probes} batch={batch}: "
                f"recall@10 {r:.4f} over {n_q} queries, median "
                f"{np.median(times[1:]):.3f} ms per batch")
            state[f"recall_p{n_probes}_b{batch}"] = r
            state[f"ms_p{n_probes}_b{batch}"] = float(np.median(times[1:]))

    # probing every list is exact search: ids equal brute force's, except
    # where two distances tie within float32 rounding
    sp_all = ivf_flat.IvfFlatSearchParams(n_probes=N_LISTS)
    outs = [ivf_flat.search(res, sp_all, index, queries[s:s + 500], K)
            for s in range(0, N_QUERIES, 500)]
    all_d = torch.cat([o[0] for o in outs])
    all_i = torch.cat([o[1] for o in outs])
    diff = all_i != gt_i
    tol = 1e-5 * ((queries * queries).sum(dim=1, keepdim=True)
                  + float(bf.norms.max()))
    if bool(((all_d - gt_d).abs() > tol).any()):
        fail("n_probes=1024 distances differ from brute force")
    log(f"[main] n_probes={N_LISTS}: {int(diff.sum())} of {diff.numel()} "
        "ids differ from brute force, all at distances tied within "
        "1e-5 (|q|^2 + max |x|^2)")
    if float(diff.float().mean()) > 1e-3:
        fail("n_probes=1024 ids differ from brute force beyond ties")

    sp = ivf_flat.IvfFlatSearchParams(n_probes=128)
    before = ivf_flat.search(res, sp, index, queries[:500], K)
    buf = io.BytesIO()
    ivf_flat.save(index, buf)
    buf.seek(0)
    loaded = ivf_flat.load(res, buf)
    after = ivf_flat.search(res, sp, loaded, queries[:500], K)
    if not (torch.equal(before[0], after[0])
            and torch.equal(before[1], after[1])):
        fail("save -> load -> search is not bit-identical")
    log(f"[main] save -> load ({buf.getbuffer().nbytes} bytes) -> search: "
        "bit-identical")

    state["launches"] = read_launches(("fused_knn", "list_major_scan"),
                                      "IVF-Flat")
    state.update(res=res, x=x, queries=queries, index=index, bf=bf,
                 gt_d=gt_d, gt_i=gt_i, seed=seed)
    builds_reproducible_ivf(torch, state)
    main_tiered(torch, state)
    main_bq(torch, state)


def builds_reproducible_ivf(torch, state: dict) -> None:
    """Two same-seed builds are equal (torch.equal): balanced k-means over
    all 1M rows (n_lists 1024, the IVF-Flat path's parameters) and a
    second IVF-Flat build, against the path's index."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.neighbors import ivf_flat

    x, index = state["x"], state["index"]
    kp = kmeans_balanced.KMeansBalancedParams()
    t0 = time.perf_counter()
    fits = [kmeans_balanced.fit(Resources(device="cuda", seed=0), kp, x,
                                N_LISTS) for _ in range(2)]
    torch.cuda.synchronize()
    fit_s = (time.perf_counter() - t0) / 2
    if not torch.equal(fits[0], fits[1]):
        fail("two same-seed balanced k-means fits differ")
    again = ivf_flat.build(Resources(device="cuda", seed=state["seed"]),
                           ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS), x)
    for name in ("centers", "data", "data_norms", "indices", "list_sizes"):
        if not torch.equal(getattr(again, name), getattr(index, name)):
            fail(f"two same-seed IVF-Flat builds differ in {name}")
    log(f"[main] reproducible builds: two balanced k-means fits of "
        f"{tuple(x.shape)} into {N_LISTS} ({fit_s:.3f} s each) and two "
        "IVF-Flat builds are equal (torch.equal: centers, lists, norms, "
        "ids, sizes)")


def builds_reproducible_cagra(torch, state: dict) -> None:
    """Two same-seed CAGRA builds on the first CAGRA_REPRO_ROWS rows (a cut
    that keeps the run inside its time limit; the full 1M build ran once
    above) give equal graphs and planes."""
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra

    x = state["x"][:CAGRA_REPRO_ROWS]
    t0 = time.perf_counter()
    a, b = (cagra.build(Resources(device="cuda", seed=state["seed"]),
                        cagra_params(cagra), x) for _ in range(2))
    torch.cuda.synchronize()
    for name in ("graph", "seed_centers", "seed_members", "bq_records"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            fail(f"two same-seed CAGRA builds of {CAGRA_REPRO_ROWS} rows "
                 f"differ in {name}")
    log(f"[main] reproducible builds: two CAGRA builds of "
        f"{CAGRA_REPRO_ROWS} rows (a cut of the 1M; "
        f"{(time.perf_counter() - t0) / 2:.2f} s each) give equal graphs, "
        "seed and BQ planes (torch.equal)")


def _probed_rows(torch, t, probes):
    """Rows of the probed-list union of one request, split by tier: (hot
    rows, cold rows, cold lists), from the tier fetch plan of the union."""
    from raft_tpu_torch.ops.ivf_scan import unique_lists
    from raft_tpu_torch.ops.tier_scan import tier_fetch_plan

    uniq = unique_lists(probes, t.n_lists)
    _, cold_fetch, _ = tier_fetch_plan(uniq, t.hot_slot_map,
                                       t.cold_slot_map, t.n_lists)
    live = uniq < t.n_lists
    sizes = t.list_sizes.to(torch.int64)[uniq.clamp(max=t.n_lists - 1)
                                         .to(torch.int64)]
    cold = live & (cold_fetch >= 0)
    hot = live & (cold_fetch < 0)
    return int(sizes[hot].sum()), int(sizes[cold].sum()), int(cold.sum())


def main_tiered(torch, state: dict) -> None:
    """The tiered path on the IVF-Flat path's index: half the lists' blocks
    in pinned host memory; searches bit-identical to the all-device index,
    one placement epoch, and the dual roofline."""
    from raft_tpu_torch.core import memwatch, tracing
    from raft_tpu_torch.neighbors import ivf_flat, tiered
    from raft_tpu_torch.ops.fused_topk import stream_read_sum
    from raft_tpu_torch.serving.placement import plan_epoch

    res, index, queries, gt_i = (state["res"], state["index"],
                                 state["queries"], state["gt_i"])
    # the all-device answers each tiered request must equal, first (their
    # scan launches are not the tiered path's)
    requests = [(p, b, n_q) for p in (32, 128)
                for b, n_q in ((10, 1000), (500, N_QUERIES))]
    want = {(p, b): [ivf_flat.search(res, ivf_flat.IvfFlatSearchParams(
        n_probes=p), index, queries[s:s + b], K) for s in range(0, n_q, b)]
        for p, b, n_q in requests}
    torch.cuda.synchronize()

    reset_launches()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    t = tiered.build_tiered(index, hot_fraction=0.5)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grew = torch.cuda.memory_allocated() - alloc0
    model = memwatch.index_memory_model(t)
    mirrors = t.hot_lists.nbytes + t.cold_lists.nbytes
    log(f"[main] tiered.build_tiered hot_fraction=0.5: {build_s:.3f} s, "
        f"{t.n_hot} hot lists ({t.hot_bytes} bytes on the card), "
        f"{t.n_cold} cold ({t.cold_bytes} bytes), block {t.block_bytes} "
        f"bytes; cold plane pinned: {t.cold_data.is_pinned()}, memory_tier "
        f"{memwatch.memory_tier(t.cold_data)}; modeled host-resident "
        f"{model['host_resident_bytes']} bytes (cold plane + {mirrors} "
        f"bytes of host list mirrors); device memory grew {grew} bytes")
    if not (t.host_resident and t.cold_data.is_pinned()
            and memwatch.memory_tier(t.cold_data) == "host"):
        fail("the cold tier is not in pinned host memory")
    if model["host_resident_bytes"] != t.cold_bytes + mirrors:
        fail("the memory model does not count the cold tier as host bytes")
    if not 0 <= grew - t.hot_bytes < (1 << 20):
        fail(f"device memory grew {grew} bytes over a {t.hot_bytes}-byte "
             "hot tier")

    def run_requests(tag: str, key: str, n_first=None) -> None:
        for p, b, n_q in requests:
            n_q = min(n_q, n_first or n_q)
            sp = tiered.TieredSearchParams(n_probes=p)
            outs, times, hot_b, cold_b, staged = [], [], [], [], []
            for j, s in enumerate(range(0, n_q, b)):
                c0 = tracing.counters("tier.")
                t1 = time.perf_counter()
                out = tiered.search(res, sp, t, queries[s:s + b], K)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                c1 = tracing.counters("tier.")
                staged.append({name: c1[name] - c0.get(name, 0.0)
                               for name in c1})
                ref = want[p, b][j]
                if not (torch.equal(out[0], ref[0])
                        and torch.equal(out[1], ref[1])):
                    fail(f"tiered search n_probes={p} batch={b} request {j} "
                         f"{tag} differs from the all-device search")
                outs.append(out)
            for j, s in enumerate(range(0, n_q, b)):
                probes = ivf_flat.coarse_probes(
                    queries[s:s + b], t.centers, t.center_norms, t.metric,
                    p, "exact")
                hot_rows, cold_rows, n_cold = _probed_rows(torch, t, probes)
                hot_b.append(hot_rows * DIM * 4)
                cold_b.append(cold_rows * DIM * 4)
                # each probed cold list staged once, its real rows rounded
                # up to the scan's 64-row tile: never fewer bytes
                got = staged[j]
                if (got.get("tier.cold_lists_staged", 0) != n_cold
                        or got.get("tier.cold_bytes_staged", 0)
                        < cold_rows * DIM * 4):
                    fail(f"tiered search n_probes={p} batch={b} request {j} "
                         f"{tag}: staged {got} for {n_cold} probed cold "
                         f"lists of {cold_rows * DIM * 4} bytes")
            st_b = [x.get("tier.cold_bytes_staged", 0) for x in staged]
            waves = [x.get("tier.stage_waves", 0) for x in staged]
            r = recall(torch.cat([o[1] for o in outs]), gt_i[:n_q])
            ms = float(np.median(times[1:]))
            state[f"tier_recall_p{p}_b{b}{key}"] = r
            state[f"tier_ms_p{p}_b{b}{key}"] = ms
            state[f"tier_hot_bytes_p{p}_b{b}{key}"] = float(np.mean(hot_b))
            state[f"tier_cold_bytes_p{p}_b{b}{key}"] = float(np.mean(cold_b))
            state[f"tier_staged_bytes_p{p}_b{b}{key}"] = float(np.mean(st_b))
            log(f"[main] tiered.search n_probes={p} batch={b} {tag}: "
                f"recall@10 {r:.4f} over {n_q} queries, median {ms:.3f} ms "
                f"per batch (all-device {state[f'ms_p{p}_b{b}']:.3f} ms), "
                f"cold bytes probed per request mean "
                f"{np.mean(cold_b):.0f} (min {min(cold_b)}, max "
                f"{max(cold_b)}), staged over the host link (counted, "
                f"tier.cold_bytes_staged) mean {np.mean(st_b):.0f} (min "
                f"{min(st_b):.0f}, max {max(st_b):.0f}) in {min(waves):.0f}"
                f"-{max(waves):.0f} waves; each probed cold list staged "
                "once; ids and distances equal the all-device search")

    run_requests("before the epoch", "")

    # one placement epoch: batch-500 traffic at the centers of two cold
    # lists. The traffic probes one list a query, so the window holds the
    # two targets alone and the plan must promote exactly them.
    dev = t.centers.device
    targets = [int(t.cold_lists[0]), int(t.cold_lists[t.n_cold // 2])]
    window = torch.zeros(t.n_lists, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    for lid in targets:
        traffic = (t.centers[lid][None, :].expand(500, -1)
                   + 0.01 * torch.randn(500, DIM, generator=g, device=dev))
        fn, arrays, static = tiered.serving_plan(
            tiered.TieredSearchParams(n_probes=1), t, K)
        *_, window = fn(traffic, *arrays, None, window, **static)
    plan = plan_epoch(window.cpu().numpy(), t.hot_lists, t.cold_lists,
                      max_swaps=4)
    b0 = tracing.get_counter("tier.swap_bytes")
    t0 = time.perf_counter()
    moved = tiered.apply_plan(t, plan.promotions, plan.demotions, width=4)
    epoch_ms = (time.perf_counter() - t0) * 1e3
    swap_bytes = tracing.get_counter("tier.swap_bytes") - b0
    n_swaps = len(plan.promotions)
    log(f"[main] placement epoch: window {int(window.sum())} probes on "
        f"lists {targets}, hot share {plan.hot_window_fraction:.3f}; plan "
        f"promotes {list(plan.promotions)}, demotes "
        f"{list(plan.demotions)}; apply_plan moved {moved} bytes in "
        f"{epoch_ms:.2f} ms (tier.swap_bytes +{swap_bytes:.0f}), "
        f"generation {t.generation}")
    if sorted(plan.promotions) != sorted(targets):
        fail(f"the epoch promoted {plan.promotions}, not {targets}")
    if not all(int(t.hot_slot_map[lid]) >= 0 for lid in targets):
        fail("a targeted list is not hot after the epoch")
    if not swap_bytes == moved == 2 * n_swaps * t.block_bytes:
        fail(f"swap bytes {swap_bytes} != 2 x {n_swaps} x {t.block_bytes}")
    run_requests("after the epoch", "_after", n_first=1000)
    scans = _counted()["list_major_scan"].launches
    if scans != 0:
        fail(f"the all-device scan launched {scans} times on the tiered path")

    # the dual roofline: a streamed read of the hot plane (device memory)
    # and a pinned -> device copy of the cold plane (host link)
    hot_flat = t.hot_data.reshape(-1, DIM)
    hbm_ms = median_ms(lambda: stream_read_sum(hot_flat), 10)
    dst = torch.empty(t.cold_data.shape, dtype=t.cold_data.dtype,
                      device=dev)
    link_ms = median_ms(lambda: dst.copy_(t.cold_data, non_blocking=True), 5)
    state["hbm_gbps"] = hot_flat.numel() * 4 / hbm_ms / 1e6
    state["link_gbps"] = t.cold_bytes / link_ms / 1e6
    log(f"[main] rooflines: stream_read_sum over the hot plane "
        f"{tuple(hot_flat.shape)} {hbm_ms:.4f} ms = {state['hbm_gbps']:.1f} "
        f"GB/s (device memory); pinned -> device copy of the cold plane "
        f"({t.cold_bytes} bytes) {link_ms:.3f} ms = "
        f"{state['link_gbps']:.2f} GB/s (host link)")
    del dst
    ring_copy(torch, state, t, want[128, 500])
    for p, b, _ in requests:
        ms = state[f"tier_ms_p{p}_b{b}"]
        hot_gbps = state[f"tier_hot_bytes_p{p}_b{b}"] / ms / 1e6
        cold_gbps = state[f"tier_cold_bytes_p{p}_b{b}"] / ms / 1e6
        log(f"[main] tiered n_probes={p} batch={b}: per request, hot rows "
            f"at {hot_gbps:.2f} GB/s ({100 * hot_gbps / state['hbm_gbps']:.3f}"
            f"% of the device memory roofline), cold rows at "
            f"{cold_gbps:.2f} GB/s ({100 * cold_gbps / state['link_gbps']:.1f}"
            "% of the host link roofline)")
    state["launches"].update(read_launches(("tier_scan", "stream_read_sum"),
                                           "tiered"))
    state.update(tiered=t, tier_build_s=build_s, tier_epoch_ms=epoch_ms,
                 tier_grew=grew)



def ring_copy(torch, state: dict, t, want) -> None:
    """The tiered scan's staged copies at the batch-500, n_probes=128
    request, read from the device's own timeline: torch.profiler over
    three such requests (each still equal to the all-device search); the
    bytes staged (``tier.cold_bytes_staged``) over the summed device time
    of their host -> device copies is the ring copy's achieved rate,
    against the pinned -> device roofline."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.neighbors import tiered

    sp = tiered.TieredSearchParams(n_probes=128)
    c0 = tracing.counters("tier.")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [tiered.search(state["res"], sp, t,
                              state["queries"][s:s + 500], K)
                for s in range(0, 1500, 500)]
        torch.cuda.synchronize()
    c1 = tracing.counters("tier.")
    for j, out in enumerate(outs):
        if not (torch.equal(out[0], want[j][0])
                and torch.equal(out[1], want[j][1])):
            fail(f"profiled tiered request {j} differs from the all-device "
                 "search")
    nbytes, lists = (c1.get(name, 0.0) - c0.get(name, 0.0)
                     for name in ("tier.cold_bytes_staged",
                                  "tier.cold_lists_staged"))
    copies = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key.startswith("Memcpy HtoD")]
    count = sum(e.count for e in copies)
    us = sum(e.self_device_time_total for e in copies)
    kinds = ", ".join(f"{e.key} x{e.count}" for e in copies)
    if not us:
        state["ring_gbps"] = None
        log("[main] the ring copy's rate: not measured (the profiler shows "
            "no host -> device copy on the device)")
        return
    state["ring_gbps"] = nbytes / us / 1e3
    log(f"[main] the ring copy of three batch-500, n_probes=128 tiered "
        f"requests (torch.profiler, device time of the copies): "
        f"{nbytes:.0f} bytes staged in {lists:.0f} lists, {count} host -> "
        f"device copies ({kinds}) busy {us / 1e3:.3f} ms = "
        f"{state['ring_gbps']:.2f} GB/s "
        f"({100 * state['ring_gbps'] / state['link_gbps']:.1f}% of the "
        f"pinned -> device roofline {state['link_gbps']:.2f} GB/s)")


def main_bq(torch, state: dict) -> None:
    """The IVF-BQ path at SIFT-1M's shape, on the IVF-Flat path's data and
    ground truth, then matrix.select_k over a (64, n) distance slab."""
    from raft_tpu_torch.matrix.select_k import select_k
    from raft_tpu_torch.neighbors import ivf_bq

    res, x, queries = state["res"], state["x"], state["queries"]
    gt_d, gt_i, bf = state["gt_d"], state["gt_i"], state["bf"]
    reset_launches()
    t0 = time.perf_counter()
    index = ivf_bq.build(res, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS), x)
    torch.cuda.synchronize()
    sizes = index.list_sizes.to(torch.float32)
    log(f"[main] ivf_bq.build n_lists={N_LISTS} bits={index.bits}: "
        f"{time.perf_counter() - t0:.2f} s, max_list_size "
        f"{index.max_list_size}, size {index.size}, list sizes min "
        f"{int(sizes.min())} median {int(sizes.median())} max "
        f"{int(sizes.max())}")
    if index.size != N_ROWS or index.data is None:
        fail(f"ivf_bq.build indexed {index.size} rows")

    list_sizes = index.list_sizes.to(torch.int64)
    for n_probes in (32, 128):
        sp = ivf_bq.IvfBqSearchParams(n_probes=n_probes)
        # rows probed over the first 1,000 queries
        probed = 0
        for s0 in range(0, 1000, 500):
            probes = ivf_bq.coarse_probes(index, queries[s0:s0 + 500],
                                          n_probes)[0]
            probed += int(list_sizes[probes.to(torch.int64)].sum())
        for batch, n_q in ((10, 1000), (500, N_QUERIES)):
            outs, times = [], []
            for s0 in range(0, n_q, batch):
                t1 = time.perf_counter()
                outs.append(ivf_bq.search(res, sp, index,
                                          queries[s0:s0 + batch], K))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            # every request against the plain scan, after the timing: the
            # search's ids and distances, and the rows each query reranked
            # (the kernel's count, from the same request's scan again)
            surv = 0
            for j, s0 in enumerate(range(0, n_q, batch)):
                qb = queries[s0:s0 + batch]
                name = (f"ivf_bq.search n_probes={n_probes} batch={batch} "
                        f"request {j}")
                want = bq_scan_run(index, qb, n_probes, "torch")
                got = bq_scan_run(index, qb, n_probes, "cuda")
                bq_equal(name, got, want)
                if not (torch.equal(outs[j][0], got[0])
                        and torch.equal(outs[j][1], got[1])):
                    fail(f"{name}: the scan run again differs from the "
                         "search")
                if s0 < 1000:
                    surv += int(got[2].sum())
            share = surv / probed
            state[f"bq_survivors_p{n_probes}"] = share
            ids = torch.cat([o[1] for o in outs])
            r = recall(ids, gt_i[:n_q])
            ms = float(np.median(times[1:]))
            log(f"[main] ivf_bq.search n_probes={n_probes} batch={batch}: "
                f"recall@10 {r:.4f} over {n_q} queries, median {ms:.3f} ms "
                f"per batch, rows reranked {surv} of {probed} probed "
                f"({100 * share:.3f}%) over the first 1000 queries; every "
                "request equals the plain scan on distances, ids and rows "
                "reranked")
            state[f"bq_recall_p{n_probes}_b{batch}"] = r
            state[f"bq_ms_p{n_probes}_b{batch}"] = ms
    if state["bq_recall_p128_b500"] < 0.95:
        fail("ivf_bq recall@10 at n_probes=128, batch 500 is below 0.95")

    # every list probed: the prune is probabilistic, so not exact search
    sp_all = ivf_bq.IvfBqSearchParams(n_probes=N_LISTS)
    ids = torch.cat([ivf_bq.search(res, sp_all, index, queries[s0:s0 + 500],
                                   K)[1] for s0 in range(0, 1000, 500)])
    log(f"[main] ivf_bq n_probes={N_LISTS}: recall@10 "
        f"{recall(ids, gt_i[:1000]):.4f} over 1000 queries")

    sp = ivf_bq.IvfBqSearchParams(n_probes=128)
    before = ivf_bq.search(res, sp, index, queries[:500], K)
    buf = io.BytesIO()
    ivf_bq.save(index, buf)
    buf.seek(0)
    after = ivf_bq.search(res, sp, ivf_bq.load(res, buf), queries[:500], K)
    if not (torch.equal(before[0], after[0])
            and torch.equal(before[1], after[1])):
        fail("ivf_bq save -> load -> search is not bit-identical")
    log(f"[main] ivf_bq save -> load ({buf.getbuffer().nbytes} bytes) -> "
        "search: bit-identical")

    # select_k over squared distances from a plain matmul
    q64 = queries[:64]
    slab = ((q64 * q64).sum(dim=1, keepdim=True) + bf.norms[None, :]
            - 2.0 * (q64 @ x.T))
    vals, ids = select_k(res, slab, K)
    tol = 1e-5 * ((q64 * q64).sum(dim=1, keepdim=True)
                  + float(bf.norms.max()))
    if bool(((vals - gt_d[:64]).abs() > tol).any()):
        fail("select_k values differ from brute force's distances")
    diff = ids != gt_i[:64]
    log(f"[main] select_k (64, {N_ROWS}) k={K}: {int(diff.sum())} of "
        f"{diff.numel()} ids differ from brute force, all at distances "
        "tied within 1e-5 (|q|^2 + max |x|^2)")
    if float(diff.float().mean()) > 1e-3:
        fail("select_k ids differ from brute force beyond ties")
    state["launches"].update(read_launches(("bq_scan", "select_k"),
                                           "IVF-BQ"))
    # the kernel against its plain version at the path's shape, after the
    # path's counts were read
    state["select_k_err"] = select_equal(torch, f"select_k (64, {N_ROWS}) "
                                         f"k={K}", slab, K)
    state["select_slab"] = slab
    state["bq_index"] = index
    main_cagra(torch, state)


def cagra_walk_args(state, queries, itopk: int, bq: bool):
    """The beam walk ``cagra.search`` runs for one request tile at
    search_width 4: the (args, kwargs) of ``beam_search``."""
    from raft_tpu_torch.neighbors import cagra

    sp = cagra.CagraSearchParams(itopk_size=itopk, search_width=4,
                                 bq_traversal="on" if bq else "off")
    return cagra.beam_search_args(sp, state["cagra_index"], queries, K)


def main_cagra(torch, state: dict) -> None:
    """The CAGRA path at SIFT-1M's shape, on the same data and ground
    truth: the blobs-1M-128 config's first raft_cagra entry."""
    from raft_tpu_torch.neighbors import cagra

    from raft_tpu_torch.ops.fused_topk import select_k_tiles

    res, x, queries, gt_i = (state["res"], state["x"], state["queries"],
                             state["gt_i"])
    reset_launches()
    t0 = time.perf_counter()
    index = cagra.build(res, cagra_params(cagra), x)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # cluster-join selects a cluster's rows through matrix.select_k, whose
    # AUTO takes TOPK at a cluster's width, as the reference's lax.top_k
    tiles = select_k_tiles.launches
    log(f"[main] cagra.build launched select_k_tiles {tiles} times")
    if tiles != 0:
        fail(f"cagra.build launched the wide-row select_k kernel {tiles} "
             "times (cluster-join must select through TOPK)")
    empty = float((index.graph < 0).float().mean())
    # device bytes the index holds: dataset, graph, seed and BQ planes
    nbytes = sum(t.numel() * t.element_size() for t in (
        index.dataset, index.graph, index.seed_centers, index.seed_members,
        index.bq_rotation, index.bq_center_rot, index.bq_records))
    log(f"[main] cagra.build graph_degree=32 intermediate=64 cluster_join "
        f"bq_bits=1: {build_s:.2f} s, graph {tuple(index.graph.shape)}, "
        f"-1 entries {100 * empty:.4f}%, seed plane "
        f"{tuple(index.seed_members.shape)}, index {nbytes} bytes")
    state.update(cagra_index=index, cagra_build_s=build_s)
    if index.size != N_ROWS or index.graph_degree != 32:
        fail(f"cagra.build: size {index.size}, degree {index.graph_degree}")

    for itopk, bq in ((64, "off"), (128, "off"), (64, "on")):
        sp = cagra.CagraSearchParams(itopk_size=itopk, search_width=4,
                                     bq_traversal=bq)
        for batch, n_q in ((10, 1000), (500, N_QUERIES)):
            outs, times = [], []
            for s0 in range(0, n_q, batch):
                t1 = time.perf_counter()
                outs.append(cagra.search(res, sp, index,
                                         queries[s0:s0 + batch], K))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            ids = torch.cat([o[1] for o in outs])
            r = recall(ids, gt_i[:n_q])
            # queries that found none of their 10: a walk that never
            # reached the true neighbourhood, whatever its buffer
            hits = (ids[:, :, None] == gt_i[:n_q, None, :]).any(dim=2)
            lost = int((hits.sum(dim=1) == 0).sum())
            ms = float(np.median(times[1:]))
            tag = f"itopk{itopk}_bq{bq}_b{batch}"
            state[f"cagra_recall_{tag}"] = r
            state[f"cagra_ms_{tag}"] = ms
            log(f"[main] cagra.search itopk={itopk} search_width=4 "
                f"bq_traversal={bq} batch={batch}: recall@10 {r:.4f} over "
                f"{n_q} queries ({lost} found none of their 10), median "
                f"{ms:.3f} ms per batch")
    # what the walk read, over the first 1,000 queries
    from raft_tpu_torch.ops.beam_search import beam_search

    for bq in (False, True):
        counts = []
        for s0 in (0, 500):
            args, kw = cagra_walk_args(state, queries[s0:s0 + 500], 64, bq)
            counts.append(beam_search(*args, **kw)[2])
        counts = torch.cat(counts)
        tot = counts.to(torch.int64).sum(dim=0).tolist()
        share = tot[2] / max(tot[1], 1)
        state[f"cagra_scored_share_bq{bq}"] = share
        log(f"[main] cagra itopk=64 bq_traversal={'on' if bq else 'off'}: "
            f"{tot[0] / 1000:.2f} live iterations, {tot[1] / 1000:.1f} "
            f"candidates and {tot[2] / 1000:.1f} rows scored exactly per "
            f"query ({100 * share:.3f}% of candidates)")
    if state["cagra_recall_itopk128_bqoff_b500"] < 0.90:
        fail("cagra recall@10 at itopk 128, batch 500 is below 0.90")
    for batch in (10, 500):
        on = state[f"cagra_recall_itopk64_bqon_b{batch}"]
        off = state[f"cagra_recall_itopk64_bqoff_b{batch}"]
        if on < off - 0.02:
            fail(f"cagra BQ-on recall {on:.4f} is more than 0.02 below "
                 f"BQ-off {off:.4f} at batch {batch}")

    sp = cagra.CagraSearchParams(itopk_size=64, search_width=4)
    before = cagra.search(res, sp, index, queries[:500], K)
    buf = io.BytesIO()
    cagra.save(index, buf)
    buf.seek(0)
    after = cagra.search(res, sp, cagra.load(res, buf), queries[:500], K)
    if not (torch.equal(before[0], after[0])
            and torch.equal(before[1], after[1])):
        fail("cagra save -> load -> search is not bit-identical")
    log(f"[main] cagra save -> load ({buf.getbuffer().nbytes} bytes) -> "
        "search: bit-identical")
    state["launches"].update(read_launches(("beam_search",), "CAGRA"))
    builds_reproducible_cagra(torch, state)


def select_equal(torch, name: str, v, k: int) -> float:
    """select_k_tiles against select_k_tiles_plain on ``v``: values and
    ids must be equal; returns the measured max |dv| over the values."""
    from raft_tpu_torch.ops.fused_topk import (
        select_k_tiles,
        select_k_tiles_plain,
    )

    got = select_k_tiles(v, k)
    want = select_k_tiles_plain(v, k)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"{name}: select_k differs from the plain version")
    err = float((got[0] - want[0]).abs().max())
    log(f"[kernels] {name}: select_k equals the plain version")
    return err


SERVE_LADDER = (8, 16, 32, 64, 128, 256, 512)
SERVE_REQUESTS = 200


def _serve_configs(state: dict) -> list:
    """(label, index, params, direct search) of each captured serve path,
    on the main phase's full-size indexes."""
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_bq, ivf_flat

    res = state["res"]
    fl32 = ivf_flat.IvfFlatSearchParams(n_probes=32)
    fl128 = ivf_flat.IvfFlatSearchParams(n_probes=128)
    bq128 = ivf_bq.IvfBqSearchParams(n_probes=128)
    cg64 = cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                   bq_traversal="off")
    index, bq_index, cg_index, bf = (state["index"], state["bq_index"],
                                     state["cagra_index"], state["bf"])
    return [
        ("ivf_flat n_probes=32", index, fl32,
         lambda q: ivf_flat.search(res, fl32, index, q, K)),
        ("ivf_flat n_probes=128", index, fl128,
         lambda q: ivf_flat.search(res, fl128, index, q, K)),
        ("ivf_bq n_probes=128", bq_index, bq128,
         lambda q: ivf_bq.search(res, bq128, bq_index, q, K)),
        ("cagra itopk=64", cg_index, cg64,
         lambda q: cagra.search(res, cg64, cg_index, q, K)),
        ("brute_force", bf, None,
         lambda q: brute_force.search(res, bf, q, K)),
    ]


def _served_equal(torch, label, got, want) -> None:
    torch.cuda.synchronize()
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
        bad = int((got[1] != want[1]).sum())
        fail(f"serve {label}: differs from the direct search ({bad} ids)")


def _request_sizes(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [(int(m), int(rng.integers(0, N_QUERIES - m + 1)))
            for m in rng.integers(1, 501, n)]


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()
            if fn.launches}


def phase_serve(torch, state: dict) -> None:
    """The serving path at full size: a SearchExecutor per index (plans
    captured as CUDA graphs, the ladder 8..512 warmed), 200 requests of
    mixed batch sizes each held bit for bit against the direct search,
    no capture after warmup, and the kernel launches of the requests
    alone (the direct searches run before the counts are zeroed) equal
    to the replays' recorded launches; CAGRA's graph pool at bucket 4096;
    the tiered index the same way with its eager plans; eager and
    captured request times with their device-busy shares; a
    DynamicBatcher over the IVF-Flat executor fed from four threads,
    every result held against its direct search."""
    import collections

    from raft_tpu_torch import SearchExecutor
    from raft_tpu_torch.neighbors import tiered

    res, queries = state["res"], state["queries"]
    configs = _serve_configs(state)
    sizes = _request_sizes(state["seed"] + 8, SERVE_REQUESTS)
    served = collections.Counter()
    executors = {}
    for label, index, params, direct in configs:
        ex = SearchExecutor(res)
        t0 = time.perf_counter()
        ex.warmup(index, buckets=SERVE_LADDER, k=K, params=params)
        warm_s = time.perf_counter() - t0
        built = ex.stats.compile_count
        costs = list(ex.executable_costs().values())
        if built != len(SERVE_LADDER) or not all(c["captured"]
                                                 for c in costs):
            fail(f"serve {label}: warmup captured {built} plans")
        want = [direct(queries[at:at + m]) for m, at in sizes]
        per_replay = {e.bucket: e.launches for e in ex._cache.values()}
        expected = collections.Counter()
        for m, _ in sizes:
            expected.update(per_replay[ex.bucket_for(m)])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = [ex.search(index, queries[at:at + m], K, params=params)
               for m, at in sizes]
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        counts = _launch_counts()
        if counts != dict(expected) or not counts:
            fail(f"serve {label}: {len(sizes)} requests launched {counts}, "
                 f"their replays record {dict(expected)}")
        served.update(counts)
        for g, w in zip(got, want):
            _served_equal(torch, label, g, w)
        if ex.stats.compile_count != built:
            fail(f"serve {label}: {ex.stats.compile_count - built} captures "
                 "after warmup")
        executors[label] = ex
        log(f"[serve] {label}: warmup captured {built} plans in "
            f"{warm_s:.2f} s (capture {sum(c['capture_seconds'] for c in costs):.2f} s, "
            f"graph pools {sum(c['pool_bytes'] for c in costs)} bytes "
            f"{[c['pool_bytes'] for c in costs]}, "
            f"{costs[-1]['launches']} kernel launches a replay at bucket "
            f"512); {len(sizes)} requests of 1-500 rows served in "
            f"{served_s:.3f} s, each bit-identical to the direct search; "
            f"kernel launches of the requests alone {counts}, as their "
            "replays record; no capture after warmup")

    # the default ladder reaches 4096: CAGRA's pool there, the walk
    # tiled by query_tile inside the graph
    cg_label, cg_index, cg_params, cg_direct = [
        c for c in configs if c[0].startswith("cagra")][0]
    big = SearchExecutor(res)
    big.warmup(cg_index, buckets=(4096,), k=K, params=cg_params)
    (cost,) = big.executable_costs().values()
    _served_equal(torch, "cagra bucket 4096",
                  big.search(cg_index, queries[:4096], K, params=cg_params),
                  cg_direct(queries[:4096]))
    state["cagra_pool_4096"] = cost["pool_bytes"]
    log(f"[serve] {cg_label} bucket 4096 (query_tile "
        f"{cg_params.query_tile}): graph pool {cost['pool_bytes']} bytes; a "
        "4096-row request bit-identical to cagra.search")
    del big
    torch.cuda.empty_cache()

    # tiered: the same executor, eager plans (the staging plan is read on
    # the host), one placement generation a dispatch
    t_sp = tiered.TieredSearchParams(n_probes=32)
    t_ex = SearchExecutor(res)
    t_ex.warmup(state["tiered"], buckets=SERVE_LADDER, k=K, params=t_sp)
    built = t_ex.stats.compile_count
    if any(c["captured"] for c in t_ex.executable_costs().values()):
        fail("serve tiered: a tiered plan was captured")
    want = [tiered.search(res, t_sp, state["tiered"], queries[at:at + m], K)
            for m, at in sizes[:50]]
    torch.cuda.synchronize()
    reset_launches()
    got = [t_ex.search(state["tiered"], queries[at:at + m], K, params=t_sp)
           for m, at in sizes[:50]]
    torch.cuda.synchronize()
    counts = _launch_counts()
    if set(counts) != {"tier_scan"}:
        fail(f"serve tiered: 50 requests launched {counts}")
    served.update(counts)
    for g, w in zip(got, want):
        _served_equal(torch, "tiered", g, w)
    if t_ex.stats.compile_count != built:
        fail("serve tiered: plans built after warmup")
    log("[serve] tiered n_probes=32: 50 requests of 1-500 rows through "
        f"eager plans bit-identical to tiered.search, launching {counts}; "
        "no plan built after warmup")

    served.update(serve_batcher(torch, state,
                                executors["ivf_flat n_probes=32"]))
    log(f"[serve] launches of the served requests (replays, tiered eager "
        f"calls, batcher replays): {dict(served)}")
    for name in ("fused_knn", "list_major_scan", "bq_scan", "beam_search",
                 "tier_scan"):
        if not served[name]:
            fail(f"{name} was never launched on the serving path")
        state["launches"][name] = state["launches"].get(name, 0) + \
            served[name]
    serve_times(torch, state, configs, executors)


BATCHER_SECONDS = 2.0


def serve_batcher(torch, state: dict, ex) -> dict:
    """A DynamicBatcher over the captured IVF-Flat executor under an
    open-loop load from four threads: requests of 1-40 rows at random
    offsets, offered for BATCHER_SECONDS at the rate at which the same
    executor serves such requests one at a time, each ending in a
    synchronize (measured here first, on 200 requests of the same mix).
    Every result equals its direct search; no capture under load; the
    kernel launches of the batcher's span equal its replays' record.
    Prints the offered and served rates, the end-to-end latency
    quantiles of the raw samples (and the log2 histogram's estimates)
    and the batch occupancy. Returns the span's launch counts."""
    import threading

    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serving import (
        BatcherConfig,
        DynamicBatcher,
        MonotonicClock,
        metrics,
    )
    from raft_tpu_torch.serving.harness import burst_schedule, drive_open_loop

    res, queries, index = state["res"], state["queries"], state["index"]
    sp = ivf_flat.IvfFlatSearchParams(n_probes=32)

    def draw(rng):
        m = int(rng.integers(1, 41))
        return m, int(rng.integers(0, N_QUERIES - m + 1))

    rng = np.random.default_rng(state["seed"] + 99)
    mix = [draw(rng) for _ in range(200)]
    for m, at in mix[:20]:
        ex.search(index, queries[at:at + m], K, params=sp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m, at in mix:
        ex.search(index, queries[at:at + m], K, params=sp)
        torch.cuda.synchronize()
    rate = len(mix) / (time.perf_counter() - t0)
    n_thread = int(BATCHER_SECONDS * rate / 4)
    period = 4.0 / rate

    metrics.reset()
    built = ex.stats.compile_count
    calls0 = tracing.get_counter("serving.execute.calls")
    per_replay = {e.launches.get("list_major_scan")
                  for e in ex._cache.values()}
    e2e: list = []
    observe = metrics.observe_stage

    def tap(name, seconds):
        if name == metrics.E2E:
            e2e.append(seconds)
        observe(name, seconds)

    metrics.observe_stage = tap
    b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.002,
                                         full_batch_rows=256))
    clock = MonotonicClock()
    out: dict = {}
    submitted: list = []
    start = clock.now() + 0.01

    def feed(t: int) -> None:
        rng = np.random.default_rng(state["seed"] + 100 + t)

        def submit(ordinal, now):
            m, at = draw(rng)
            out[(t, ordinal)] = (at, m)
            submitted.append(now)
            return b.submit(index, queries[at:at + m], K, params=sp)

        handles = drive_open_loop(submit, burst_schedule(
            n_thread, 1, period, start_s=start + t * period / 4), clock)
        for o, h in enumerate(handles):
            out[(t, o)] = out[(t, o)] + (h,)

    reset_launches()
    threads = [threading.Thread(target=feed, args=(t,)) for t in range(4)]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        results = {key: v[2].result(timeout=60) for key, v in out.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        b.close()
    finally:
        metrics.observe_stage = observe
    calls = tracing.get_counter("serving.execute.calls") - calls0
    if len(per_replay) != 1 or counts != {
            "list_major_scan": int(calls) * per_replay.pop()}:
        fail(f"serve batcher: {int(calls)} dispatches launched {counts}")
    for key, (at, m, _) in out.items():
        _served_equal(torch, "batcher", results[key], ivf_flat.search(
            res, sp, index, queries[at:at + m], K))
    if ex.stats.compile_count != built:
        fail("serve batcher: plans captured under load")
    if len(e2e) != len(out):
        fail(f"serve batcher: {len(e2e)} latencies for {len(out)} requests")
    hist = metrics.snapshot()["histograms"][metrics.E2E]
    occ = metrics.occupancy()
    offered = (len(submitted) - 1) / (max(submitted) - min(submitted))
    p50, p99 = (float(np.percentile(e2e, p)) * 1e3 for p in (50, 99))
    state["batcher"] = dict(
        serial_rps=rate, offered_rps=offered, served_rps=len(out) / wall,
        requests=len(out), p50_ms=p50, p99_ms=p99,
        hist_p50_ms=hist["p50"] * 1e3, hist_p99_ms=hist["p99"] * 1e3,
        occupancy=occ)
    log(f"[serve] batcher: one request at a time the captured executor "
        f"serves {rate:.1f} requests/s of 1-40 rows; that rate offered "
        f"from 4 threads for {BATCHER_SECONDS} s: {len(out)} requests "
        f"submitted at {offered:.1f}/s, all answered in {wall:.3f} s "
        f"({len(out) / wall:.1f}/s), each equal to its direct search; "
        f"e2e latency p50 {p50:.3f} ms p99 {p99:.3f} ms (raw samples; "
        f"the log2 histogram estimates {hist['p50'] * 1e3:.3f} / "
        f"{hist['p99'] * 1e3:.3f}); {occ['batches']} batches, "
        f"{occ['requests_per_batch']:.2f} requests and "
        f"{occ['rows_per_batch']:.1f} rows a batch; launches {counts} "
        f"= {int(calls)} replays; no capture under load")
    return counts


def serve_times(torch, state: dict, configs, executors) -> None:
    """Median request ms (host clock, each request ending in a
    synchronize) of the direct search, an eager executor and the captured
    executor at batch 10 and 500; the direct request's device-busy share
    and device ops (torch.profiler, five requests); and the captured
    request's graph time (CUDA events around the bucket's graph replay
    alone, median of 20) over its wall time. torch.profiler records only
    part of a replayed graph's kernels, so its reading of a captured
    request is printed but not used."""
    from raft_tpu_torch import SearchExecutor

    res, queries = state["res"], state["queries"]
    profiled(torch, lambda: torch.ones(1, device="cuda").sum())
    rows = []
    for label, index, params, direct in configs:
        eager = SearchExecutor(res, capture=False)
        cap = executors[label]
        for batch in (10, 500):
            q = queries[:batch]
            modes = {"direct": lambda: direct(q),
                     "eager": lambda: eager.search(index, q, K,
                                                   params=params),
                     "captured": lambda: cap.search(index, q, K,
                                                    params=params)}
            row = {"request": f"{label} batch={batch}"}
            for mode, fn in modes.items():
                fn()
                torch.cuda.synchronize()
                times = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                row[f"{mode}_ms"] = float(np.median(times))
                if mode != "eager":
                    wall_us, events = profiled(torch, fn)
                    if not events:
                        wall_us, events = profiled(torch, fn)
                    busy, _, _, ops = device_split(events)
                    row[f"{mode}_busy"] = busy / wall_us
                    row[f"{mode}_ops"] = ops
            (entry,) = [e for e in cap._cache.values()
                        if e.bucket == cap.bucket_for(batch)]
            row["graph_ms"] = median_ms(entry.graph.replay, 20)
            rows.append(row)
            log(f"[serve] {row['request']}: direct {row['direct_ms']:.3f} "
                f"ms (device busy {100 * row['direct_busy']:.1f}%, "
                f"{row['direct_ops']} device ops), eager executor "
                f"{row['eager_ms']:.3f} ms, captured {row['captured_ms']:.3f}"
                f" ms (graph replay {row['graph_ms']:.3f} ms on the device: "
                f"{100 * row['graph_ms'] / row['captured_ms']:.1f}% of the "
                f"request; the profiler saw {row['captured_ops']} device ops "
                f"and {100 * row['captured_busy']:.1f}% busy)")
    state["serve_times"] = rows


def profiled(torch, fn, reps: int = 5):
    """(wall us per request, device events) of ``reps`` requests under
    torch.profiler, each ending in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    # device-side kernels and copies only: the aten ops and the tracing
    # ranges (raft_tpu.*, which the profiler also shows on the device's
    # timeline) would count their time twice
    return wall_us, [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0
                     and not e.key.startswith("raft_tpu.")]


def device_split(events, reps: int = 5):
    """(kernel busy us, copy us, copies, device ops) per request of
    :func:`profiled`'s events. Copies (the tiered scan's staging runs on
    a side stream, beside the kernels) are kept apart from the busy
    time."""
    copies = [e for e in events if e.key.startswith("Memcpy")]
    busy = sum(e.self_device_time_total for e in events
               if e not in copies) / reps
    copy = sum(e.self_device_time_total for e in copies) / reps
    return (busy, copy, sum(e.count for e in copies) // reps,
            sum(e.count for e in events) // reps)


def phase_profile(torch, state: dict) -> None:
    """Where one request's time goes: torch.profiler over five requests
    of each kind; device busy time per request against its wall time,
    and the device time by kernel."""
    from raft_tpu_torch.neighbors import (
        brute_force,
        cagra,
        ivf_bq,
        ivf_flat,
        tiered,
    )

    res, index, queries, bf = (state["res"], state["index"],
                               state["queries"], state["bf"])
    tier_sp = tiered.TieredSearchParams(n_probes=128)
    bq_index = state["bq_index"]
    bq_sp = ivf_bq.IvfBqSearchParams(n_probes=128)
    cg_index = state["cagra_index"]
    cg_sp = cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                    bq_traversal="off")
    from raft_tpu_torch.ops.fused_topk import select_k_tiles

    # select_k's device time by kernel (the memset of its bound words and
    # the one selection kernel) at the main path's call and, after the
    # times phase, at 64 x 2^20; ahead of the tiered requests, after whose
    # sessions the profiler recorded no device event (PR 7's runs)
    requests = {
        "brute_force batch=500": lambda: brute_force.search(
            res, bf, queries[:500], K),
        f"select_k (64, {N_ROWS}) k={K}": lambda: select_k_tiles(
            state["select_slab"], K),
    }
    if "select_wide" in state:
        requests["select_k 64 x 2^20 k=64"] = lambda: select_k_tiles(
            state["select_wide"], 64)
    requests.update({
        "cagra itopk=64 batch=10": lambda: cagra.search(
            res, cg_sp, cg_index, queries[:10], K),
        "cagra itopk=64 batch=500": lambda: cagra.search(
            res, cg_sp, cg_index, queries[:500], K),
        "ivf_bq n_probes=128 batch=10": lambda: ivf_bq.search(
            res, bq_sp, bq_index, queries[:10], K),
        "ivf_bq n_probes=128 batch=500": lambda: ivf_bq.search(
            res, bq_sp, bq_index, queries[:500], K),
        "ivf_flat n_probes=32 batch=10": lambda: ivf_flat.search(
            res, ivf_flat.IvfFlatSearchParams(n_probes=32), index,
            queries[:10], K),
        "ivf_flat n_probes=128 batch=500": lambda: ivf_flat.search(
            res, ivf_flat.IvfFlatSearchParams(n_probes=128), index,
            queries[:500], K),
        "tiered n_probes=128 batch=10": lambda: tiered.search(
            res, tier_sp, state["tiered"], queries[:10], K),
        "tiered n_probes=128 batch=500": lambda: tiered.search(
            res, tier_sp, state["tiered"], queries[:500], K),
    })

    # a session that records no device event happens (the first of a
    # process, and now and then later): one session first to start the
    # profiler, and a request whose session records none is profiled again
    profiled(torch, lambda: torch.ones(1, device="cuda").sum())
    for label, fn in requests.items():
        fn()
        torch.cuda.synchronize()
        wall_us, events = profiled(torch, fn)
        if not events:
            log(f"[profile] {label}: no device event recorded; again")
            wall_us, events = profiled(torch, fn)
        busy_us, copy_us, n_copies, n_ops = device_split(events)
        log(f"[profile] {label}: wall {wall_us:.1f} us per request, device "
            f"busy (kernels) {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}"
            f"%), copies {copy_us:.1f} us ({n_copies} a request), "
            f"{n_ops} device ops per request")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:6]:
            log(f"[profile]   {e.self_device_time_total / 5:10.1f} us  "
                f"x{e.count // 5:<3d} {e.key[:90]}")


def phase_times(torch, state: dict) -> list:
    from raft_tpu_torch.neighbors._batching import coarse_select
    from raft_tpu_torch.ops.fused_topk import fused_knn, fused_knn_plain
    from raft_tpu_torch.ops.ivf_scan import list_major_scan

    x, queries, index, bf = (state["x"], state["queries"], state["index"],
                             state["bf"])
    records = []
    saved = {name: fn.launches for name, fn in _counted().items()}

    # fused_knn at the brute-force request shape: q=500, n=1M, d=128, k=10
    q = queries[:500]
    got = fused_knn(q, x, K, dataset_norms=bf.norms)
    want = fused_knn_plain(q, x, K, dataset_norms=bf.norms)
    err = compare("fused_knn main shape", got, want, exact_ids=False)
    ms = median_ms(lambda: fused_knn(q, x, K, dataset_norms=bf.norms), 20)
    plain_ms = median_ms(
        lambda: fused_knn_plain(q, x, K, dataset_norms=bf.norms), 3, 1)
    xn_row = bf.norms[None, :]
    lib_ms = median_ms(lambda: torch.topk(
        torch.addmm(xn_row, q, x.T, beta=1.0, alpha=-2.0), K, dim=1,
        largest=False), 10)
    n, d = x.shape
    nbytes = 4 * (500 * d + n * d + n) + 8 * 500 * K
    flops = 2.0 * 500 * n * d
    # the route's bound: 3xTF32, three TF32 products a multiply-add; the
    # CUDA-core figure of PRs 1-6 beside it
    bound_f32_ms = flops / PEAK_OPS_PER_S["f32"] * 1e3
    # the bf16 route on the same rows rounded to bf16 (their own norms)
    xb = x.to(torch.bfloat16)
    xbn = (xb.float() * xb.float()).sum(dim=1)
    compare("fused_knn main shape bf16",
            fused_knn(q, xb, K, dataset_norms=xbn),
            fused_knn_plain(q, xb, K, dataset_norms=xbn), exact_ids=False)
    ms_b = median_ms(lambda: fused_knn(q, xb, K, dataset_norms=xbn), 20)
    t_b = max((2 * (500 * d + n * d) + 4 * n + 8 * 500 * K)
              / PEAK_BYTES_PER_S, flops / PEAK_OPS_PER_S["bf16"]) * 1e3
    del xb, xbn
    log(f"[times] fused_knn at q=500 n=1M d=128 k=10: float32 {ms:.4f} ms "
        f"(bound {3 * flops / PEAK_OPS_PER_S['tf32'] * 1e3:.4f} ms by TF32 "
        f"operations, {bound_f32_ms:.4f} ms on the CUDA cores), bfloat16 "
        f"{ms_b:.4f} ms (bound {t_b:.4f} ms); the earlier CUDA-core design "
        f"took {EARLIER_KNN_MS} ms (NVIDIA H100 80GB HBM3, 700 W)")
    records.append(_record(
        "fused_knn", "raft_tpu_torch/csrc/fused_knn.cu",
        "raft_tpu/ops/fused_topk.py:66", state["launches"]["fused_knn"],
        err, ms, plain_ms, nbytes, {"tf32": 3.0 * flops}, lib_ms,
        bound_f32_ms=bound_f32_ms, bf16_ms=ms_b, bf16_bound_ms=t_b))

    # the IVF scan at the main path's batch-500, n_probes=128 request
    qf = queries[:500]
    ip = qf @ index.centers.T
    probes = coarse_select(-(index.center_norms[None, :] - 2.0 * ip), 128,
                           "exact")
    args = (qf, index.data, index.data_norms, index.indices, probes, None)
    kw = dict(k=K, metric=index.metric)
    got = list_major_scan(*args, engine="cuda", **kw)
    want = list_major_scan(*args, engine="torch", **kw)
    err = compare("list_major_scan main shape", got, want, exact_ids=False)
    ms = median_ms(lambda: list_major_scan(*args, engine="cuda", **kw), 20)
    plain_ms = median_ms(
        lambda: list_major_scan(*args, engine="torch", **kw), 3, 1)
    # data-dependent work: rows of the probed lists, once per probe
    sizes = index.list_sizes.to(torch.int64)
    uniq = torch.unique(probes.to(torch.int64))
    probed_rows = int(sizes[probes.to(torch.int64)].sum())
    union_rows = int(sizes[uniq].sum())
    nbytes = (union_rows * (d * index.data.element_size() + 8)
              + 4 * 500 * d + 4 * probes.numel() + 8 * 500 * K)
    flops = 2.0 * probed_rows * d
    records.append(_record(
        "list_major_scan", "raft_tpu_torch/csrc/ivf_scan.cu",
        "raft_tpu/ops/ivf_scan.py:367", state["launches"]["list_major_scan"],
        err, ms, plain_ms, nbytes, {"f32": flops}, None))
    log(f"[times] scan work at q=500 n_probes=128: {probed_rows} probed "
        f"rows, {union_rows} rows in the union of {uniq.numel()} lists")
    # batch 10: the time of the longest row chunk, no longer of the
    # longest list (the kernel's design target)
    q10 = queries[:10]
    p10 = coarse_select(-(index.center_norms[None, :]
                          - 2.0 * (q10 @ index.centers.T)), 128, "exact")
    args10 = (q10, index.data, index.data_norms, index.indices, p10, None)
    compare("list_major_scan batch 10",
            list_major_scan(*args10, engine="cuda", **kw),
            list_major_scan(*args10, engine="torch", **kw), exact_ids=False)
    ms10 = median_ms(lambda: list_major_scan(*args10, engine="cuda", **kw),
                     20)
    log(f"[times] list_major_scan at n_probes=128: batch 500 {ms:.4f} ms, "
        f"batch 10 {ms10:.4f} ms (CUDA events around the wrapper, its glue "
        f"included); the earlier one-block-a-list design took "
        f"{EARLIER_SCAN_MS} ms at batch 500 (NVIDIA H100 80GB HBM3, 700 W)")
    state["scan_ms_b10"] = ms10
    records.append(times_bq(torch, state))
    records.append(times_select(torch, state))
    records.append(times_beam(torch, state))
    records.append(times_tier(torch, state))
    records.append(times_stream(torch, state))
    for name, fn in _counted().items():
        fn.launches = saved[name]
    return records


def times_bq(torch, state: dict) -> dict:
    """The IVF-BQ scan at the main path's batch-500, n_probes=128 request."""
    from raft_tpu_torch.neighbors import ivf_bq
    from raft_tpu_torch.ops.bq_scan import (
        CLUSTER_SIZES,
        _bq_scan_cuda,
        _bq_scan_torch,
        bq_list_major_scan,
    )
    from raft_tpu_torch.ops.ivf_scan import unique_lists

    index, queries = state["bq_index"], state["queries"]
    qf = queries[:500]
    probes = ivf_bq.coarse_probes(index, qf, 128)[0]
    args = (qf, qf @ index.rotation.T, index.centers @ index.rotation.T,
            index.codes, index.rnorm, index.cfac, index.errw, index.indices,
            index.data, index.data_norms, probes, None)
    qbits = 4
    kw = dict(k=K, metric=index.metric, epsilon=3.0, query_bits=qbits)
    got = bq_list_major_scan(*args, engine="cuda", **kw)
    rows_read = torch.zeros(index.indices.shape, dtype=torch.bool,
                            device="cuda")
    want = _bq_scan_torch(*args, rows_read=rows_read, **kw)
    err = bq_equal("bq_scan main shape", got, want)
    ms = median_ms(lambda: bq_list_major_scan(*args, engine="cuda", **kw),
                   20)
    # every cluster size at batch 10 and 500 (the wrapper picks one), each
    # held against the plain version before it is timed
    for q in (10, 500):
        sub = [a[:q] if i in (0, 1, 10) else a for i, a in enumerate(args)]
        want_q = want if q == 500 else _bq_scan_torch(*sub, **kw)
        bq_list_major_scan(*sub, engine="cuda", **kw)
        chosen = bq_list_major_scan.last_cluster
        for c in CLUSTER_SIZES:
            got_c = _bq_scan_cuda(*sub, cluster=c, **kw)
            if bq_list_major_scan.last_cluster != c:
                fail(f"bq_scan q={q}: cluster {c} asked, "
                     f"{bq_list_major_scan.last_cluster} launched")
            err = max(err, bq_equal(f"bq_scan q={q} n_probes=128 cluster={c}",
                                    got_c, want_q))
        by_size = {c: median_ms(lambda c=c: _bq_scan_cuda(
            *sub, cluster=c, **kw), 10) for c in CLUSTER_SIZES}
        state[f"bq_ms_by_cluster_b{q}"] = by_size
        log(f"[times] bq_scan q={q} n_probes=128 by cluster size: "
            + ", ".join(f"{c}: {v:.4f} ms" for c, v in by_size.items())
            + f"; the wrapper chooses {chosen}; every size equals the plain "
            "version on distances, ids and rows reranked (the earlier one-"
            f"block-a-query kernel: {EARLIER_BQ_MS[q]} ms, NVIDIA H100 80GB "
            "HBM3, 700 W)")
    plain_ms = median_ms(
        lambda: bq_list_major_scan(*args, engine="torch", **kw), 3, 1)
    # data-dependent work. Bytes: the union's code and correction rows
    # once, the raw row (and norm) of every row some query reranked once,
    # the queries, the union's rotated centers, the probes and the output.
    # Operations: per (query, probed row) pair, a XOR and a popcount per
    # code word and query bit-plane (plus the adds that sum them), and the
    # estimate's float assembly (6 per level, 16 for est, margin and
    # prune); 2d float32 per reranked pair; a popcount per union code word
    sizes = index.list_sizes.to(torch.int64)
    union = unique_lists(probes, index.n_lists).to(torch.int64)
    union = union[union < index.n_lists]
    union_rows = int(sizes[union].sum())
    probed_rows = int(sizes[probes.to(torch.int64)].sum())
    survivors = int(want[2].sum())
    read_rows = int(rows_read.sum())
    d, de, bits = index.dim, index.dim_ext, index.bits
    words = bits * de // 32
    nbytes = (union_rows * (4 * words + 4 * (bits + 2) + 4)
              + read_rows * (4 * d + 4)
              + 4 * 500 * (d + de) + 4 * de * union.numel()
              + 4 * probes.numel() + 8 * 500 * K)
    ops = {"f32": 2.0 * survivors * d + (6 * bits + 16) * probed_rows,
           "popc": float(probed_rows * words * qbits + union_rows * words),
           "int32": (2.0 * probed_rows * words * qbits
                     + 3.0 * probed_rows * bits * qbits)}
    log(f"[times] bq_scan work at q=500 n_probes=128: {probed_rows} probed "
        f"rows, {union_rows} rows in the union of {union.numel()} lists, "
        f"{survivors} (query, row) pairs reranked "
        f"({100 * survivors / probed_rows:.3f}%) over {read_rows} distinct "
        f"rows; distances, ids and rows reranked per query equal the plain "
        f"version's")
    return _record("bq_scan", "raft_tpu_torch/csrc/bq_scan.cu",
                   "raft_tpu/ops/bq_scan.py:506", state["launches"]["bq_scan"],
                   err, ms, plain_ms, nbytes, ops, None)


def times_select(torch, state: dict) -> dict:
    """select_k at the JAX package's full bench size: 64 x 2^20, k = 64;
    its error is the larger of this comparison's and the main path's."""
    from raft_tpu_torch.ops.fused_topk import (
        select_k_tiles,
        select_k_tiles_plain,
    )

    b, n, k = 64, 1 << 20, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    v = torch.randn(b, n, generator=g, device="cuda")
    err = max(select_equal(torch, "select_k 64 x 2^20 k=64", v, k),
              state["select_k_err"])
    ms = median_ms(lambda: select_k_tiles(v, k), 20)
    plain_ms = median_ms(lambda: select_k_tiles_plain(v, k), 5)
    lib_ms = median_ms(lambda: torch.topk(v, k, dim=1, largest=False), 20)
    # the shape of the CAGRA build's launches (cluster-join: one per
    # cluster and pass, a cluster's (m, m) squared distances with an
    # infinite diagonal, k = 64; m ~ 1M / 489 clusters of ~2,048 rows)
    x = state["x"][:2048]
    nr = (x * x).sum(dim=1)
    slab = torch.clamp(nr[:, None] + nr[None, :] - 2.0 * (x @ x.T), min=0.0)
    slab.fill_diagonal_(float("inf"))
    select_equal(torch, "select_k 2048 x 2048 k=64", slab, k)
    c_ms = median_ms(lambda: select_k_tiles(slab, k), 20)
    c_plain = median_ms(lambda: select_k_tiles_plain(slab, k), 5)
    c_lib = median_ms(lambda: torch.topk(slab, k, dim=1, largest=False), 20)
    # what cluster-join now runs at that shape: matrix.select_k (AUTO: TOPK)
    from raft_tpu_torch.matrix.select_k import select_k

    c_auto = median_ms(lambda: select_k(state["res"], slab, k), 20)
    log(f"[times] matrix.select_k AUTO (TOPK) at the CAGRA build's shape: "
        f"{c_auto:.4f} ms")
    c_bound = (4 * slab.numel() + 8 * 2048 * k) / PEAK_BYTES_PER_S * 1e3
    log(f"[times] select_k at the CAGRA build's shape (2048 x 2048, k=64): "
        f"{c_ms:.4f} ms (plain {c_plain:.3f} ms, torch.topk {c_lib:.4f} ms), "
        f"bound {c_bound:.4f} ms by bytes")
    # the main path's call: the IVF-BQ path's (64, 1,000,000) slab, k = 10
    main = state["select_slab"]
    m_ms = median_ms(lambda: select_k_tiles(main, K), 20)
    m_lib = median_ms(lambda: torch.topk(main, K, dim=1, largest=False), 20)
    m_bound = (4 * main.numel() + 8 * 64 * K) / PEAK_BYTES_PER_S * 1e3
    log(f"[times] select_k at 64 x 2^20, k=64: {ms:.4f} ms; 2048 x 2048, "
        f"k=64: {c_ms:.4f} ms (torch.topk {c_lib:.4f} ms); the main path's "
        f"(64, {N_ROWS}), k={K}: {m_ms:.4f} ms (torch.topk {m_lib:.4f} ms, "
        f"bound {m_bound:.4f} ms by bytes); the earlier insertion design "
        f"took {EARLIER_SELECT_MS['64x2^20']} and "
        f"{EARLIER_SELECT_MS['2048x2048']} ms at the first two (NVIDIA H100 "
        "80GB HBM3, 700 W)")
    state["select_wide"] = v
    return _record("select_k", "raft_tpu_torch/csrc/select_k.cu",
                   "raft_tpu/ops/fused_topk.py:290",
                   state["launches"]["select_k"], err, ms, plain_ms,
                   4 * b * n + 8 * b * k, {"f32": float(b * n)}, lib_ms,
                   ms_2048x2048=c_ms, library_ms_2048x2048=c_lib,
                   ms_main_k10=m_ms, library_ms_main_k10=m_lib,
                   bound_ms_main_k10=m_bound)


def times_beam(torch, state: dict) -> dict:
    """The beam kernel at the main path's batch-500, itopk-64 request
    (BQ traversal off), on that request's seeds, walked in one launch
    (the request's query_tile of 256 walks it in two)."""
    from raft_tpu_torch.ops.beam_search import beam_search, beam_search_plain

    index, queries = state["cagra_index"], state["queries"]
    q = queries[:500]
    args, kw = cagra_walk_args(state, q, 64, False)
    got = beam_search(*args, **kw)
    cluster500 = beam_search.last_cluster
    rows_read = torch.zeros((index.size, 2), dtype=torch.bool, device="cuda")
    want = beam_search_plain(*args, rows_read=rows_read, **kw)
    err = beam_equal("beam_search main shape", got, want)
    ms = median_ms(lambda: beam_search(*args, **kw), 20)
    # batch 10: a cluster of CTAs a query
    args10, kw10 = cagra_walk_args(state, queries[:10], 64, False)
    beam_equal("beam_search batch 10", beam_search(*args10, **kw10),
               beam_search_plain(*args10, **kw10))
    cluster10 = beam_search.last_cluster
    ms10 = median_ms(lambda: beam_search(*args10, **kw10), 20)
    log(f"[times] beam_search at itopk 64: batch 500 {ms:.4f} ms on a "
        f"cluster of {cluster500} CTA(s) a query, batch 10 {ms10:.4f} ms on "
        f"a cluster of {cluster10} ({10 * cluster10} CTAs); the earlier "
        f"one-block-a-query design took {EARLIER_BEAM_MS} ms at batch 500 "
        "(NVIDIA H100 80GB HBM3, 700 W)")
    state.update(beam_ms_b10=ms10, beam_cluster_b10=cluster10,
                 beam_cluster_b500=cluster500)
    plain_ms = median_ms(lambda: beam_search_plain(*args, **kw), 3, 1)
    # data-dependent work. Bytes: each distinct row scored once, each
    # distinct parent's adjacency row once, the queries, seeds and output.
    # Operations: 2d float32 per scored (query, row) pair and 2d per
    # distinct scored row for its norm
    d, deg, seeds = index.dim, index.graph_degree, args[3]
    pairs = int(want[2][:, 2].to(torch.int64).sum())
    rows = int(rows_read[:, 0].sum())
    parents = int(rows_read[:, 1].sum())
    nbytes = (rows * d * index.dataset.element_size() + parents * deg * 4
              + 4 * q.numel() + 4 * seeds.numel() + 8 * 500 * K)
    flops = 2.0 * d * (pairs + rows)
    log(f"[times] beam_search work at q=500 itopk=64: {pairs} (query, row) "
        f"pairs scored over {rows} distinct rows, {parents} distinct "
        f"parents, {int(want[2][:, 0].sum())} live iterations; distances, "
        "ids and counts equal the plain version's")
    return _record("beam_search", "raft_tpu_torch/csrc/beam_search.cu",
                   "raft_tpu/ops/beam_search.py:90",
                   state["launches"]["beam_search"], err, ms, plain_ms,
                   nbytes, {"f32": flops}, None)


def times_tier(torch, state: dict) -> dict:
    """The tiered scan at the main path's batch-500, n_probes=128 request,
    after the placement epoch; its hot and cold GB/s against the two
    rooflines, and the all-device scan's ms on the same request."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    t, index, queries = state["tiered"], state["index"], state["queries"]
    qf = queries[:500]
    probes = ivf_flat.coarse_probes(qf, t.centers, t.center_norms, t.metric,
                                    128, "exact")
    hot, cold, hmap, cmap = t.tier_arrays()
    args = (qf, hot, cold, hmap, cmap, t.data_norms, t.indices, probes, None)
    kw = dict(k=K, metric=t.metric)
    got = tiered_list_major_scan(*args, engine="cuda", **kw)
    whole_args = (qf, index.data, index.data_norms, index.indices, probes,
                  None)
    whole = list_major_scan(*whole_args, engine="cuda", **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])):
        fail("tier_scan main shape: differs from the all-device scan")
    want = tiered_list_major_scan(*args, engine="torch", **kw)
    err = compare("tier_scan main shape", got, want, exact_ids=False)
    ms = median_ms(lambda: tiered_list_major_scan(*args, engine="cuda",
                                                  **kw), 20)
    whole_ms = median_ms(lambda: list_major_scan(*whole_args, engine="cuda",
                                                 **kw), 20)
    plain_ms = median_ms(lambda: tiered_list_major_scan(
        *args, engine="torch", **kw), 3, 1)
    # data-dependent work: the union's rows read once per tier (real rows:
    # tiles of padding are skipped), the norm and id planes of the union
    # on the card, the queries, probes and output; 2d float32 operations
    # per (query, probed row) pair
    hot_rows, cold_rows, n_cold = _probed_rows(torch, t, probes)
    probed_rows = int(t.list_sizes.to(torch.int64)[probes.to(torch.int64)]
                      .sum())
    d = t.dim
    hot_bytes = hot_rows * d * 4
    cold_bytes = cold_rows * d * 4
    nbytes = (hot_bytes + (hot_rows + cold_rows) * 8 + 4 * 500 * d
              + 4 * probes.numel() + 8 * 500 * K)
    flops = 2.0 * probed_rows * d
    log(f"[times] tier_scan work at q=500 n_probes=128: {probed_rows} probed "
        f"rows; the union holds {hot_rows} hot rows ({hot_bytes} bytes on "
        f"the card) and {cold_rows} cold rows of {n_cold} cold lists "
        f"({cold_bytes} bytes over the host link); the all-device scan "
        f"takes {whole_ms:.4f} ms on this request; the tier scan reads the "
        f"hot rows at {hot_bytes / ms / 1e6:.1f} GB/s (device memory "
        f"roofline {state['hbm_gbps']:.1f} GB/s) and the cold rows at "
        f"{cold_bytes / ms / 1e6:.2f} GB/s (host link roofline "
        f"{state['link_gbps']:.2f} GB/s, the ring copies on the device "
        + ("not measured" if state["ring_gbps"] is None
           else f"{state['ring_gbps']:.2f} GB/s")
        + "); ids and distances equal the all-device scan's")
    state["tier_whole_ms"] = whole_ms
    log(f"[times] tier_scan: {ms:.4f} ms against the earlier in-place "
        f"kernel's {EARLIER_TIER_MS} ms on this request (NVIDIA H100 80GB "
        "HBM3, 700 W), "
        f"the all-device scan {whole_ms:.4f} ms and the cold bytes' link "
        f"time {cold_bytes / HOST_LINK_BYTES_PER_S * 1e3:.4f} ms")
    return _record("tier_scan", "raft_tpu_torch/csrc/tier_scan.cu",
                   "raft_tpu/ops/tier_scan.py:328",
                   state["launches"]["tier_scan"], err, ms, plain_ms, nbytes,
                   {"f32": flops}, None, link_bytes=cold_bytes)


def times_stream(torch, state: dict) -> dict:
    """stream_read_sum over the hot plane, (n_hot * m, 128) float32."""
    from raft_tpu_torch.ops.fused_topk import (
        stream_read_sum,
        stream_read_sum_plain,
    )

    x = state["tiered"].hot_data.reshape(-1, DIM)
    got = stream_read_sum(x)
    want = stream_read_sum_plain(x)
    ref = x.double().sum(dim=0, keepdim=True)
    scale = x.double().abs().sum(dim=0, keepdim=True)
    if bool(((got.double() - ref).abs() > 1e-6 * scale).any()):
        fail("stream_read_sum main shape: off the float64 sum by more than "
             "1e-6 sum|x|")
    err = float((got - want).abs().max())
    ms = median_ms(lambda: stream_read_sum(x), 20)
    plain_ms = median_ms(lambda: stream_read_sum_plain(x), 20)
    lib_ms = median_ms(lambda: torch.sum(x, dim=0), 20)
    n, d = x.shape
    return _record("stream_read_sum", "raft_tpu_torch/csrc/stream_read.cu",
                   "raft_tpu/ops/fused_topk.py:398",
                   state["launches"]["stream_read_sum"], err, ms, plain_ms,
                   4 * n * d + 4 * d, {"f32": float(n * d)}, lib_ms)


def _record(name, source, replaces, launches, err, ms, plain_ms, nbytes,
            ops: dict, lib_ms, link_bytes: int = 0, **extra):
    """One kernel's record; ``ops`` counts operations by type (keys of
    PEAK_OPS_PER_S), each type's time over its peak bounds the call;
    ``nbytes`` move over device memory and ``link_bytes`` over the host
    link, each at its own rate (the two run at once, so the larger time
    bounds the call). ``extra`` keys (other shapes, routes) are added as
    they are."""
    t_bytes = max(nbytes / PEAK_BYTES_PER_S,
                  link_bytes / HOST_LINK_BYTES_PER_S) * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[kind] * 1e3 for kind, n in ops.items())
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, **extra}
    log(f"[times] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}), bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({nbytes} bytes"
        + (f" + {link_bytes} host-link bytes" if link_bytes else "") + ", "
        + ", ".join(f"{n:.4g} {kind}" for kind, n in ops.items()) + " ops)")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="env,build,kernels,main,serve,times")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: raft_tpu_torch not importable: {e}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    state: dict = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    phase_env(torch)
    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        timed("kernels", phase_kernels, torch, args.seed)
    records = []
    if "main" in phases:
        timed("main", phase_main, torch, args.seed, state)
        if "serve" in phases:
            timed("serve", phase_serve, torch, state)
        if "times" in phases:
            records = timed("times", phase_times, torch, state)
        if "profile" in phases:
            timed("profile", phase_profile, torch, state)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
