#!/usr/bin/env python3
"""Split the list-major IVF-PQ LUT scan kernel's time by building patched
copies of ``csrc/ivf_pq_scan.cu`` with one phase cut out:

    python3 scripts/torch_pq_variants.py [--variants base,no_score,...]
        [--data uniform,skewed]

Each variant copies ``raft_tpu_torch/csrc`` into ``raft_tpu_torch/_build/
variants/<name>`` (ignored by git) and replaces the phase's source text;
the copies are compiled at once (one ``nvcc`` each), then each variant
runs in a process of its own (two builds of one source loaded into one
process interpose each other's symbols). Two requests, both k = 10, float32
LUT, pq_dim 64, 8-bit codes, 500 queries x 128 probes:

- ``uniform``: 1,024 lists of 2,400 live rows, random probes;
- ``skewed``: the pq phase of ``chip_smoke.py``'s index (the sift config's
  ``raft_ivf_pq`` entry built on its 1M clustered rows, ``--seed`` 0) and
  its first 500 queries' coarse probes: lists of median ~490 rows, the
  large ones most probed;
- ``small``: that index at batch 10 and 32 probes.

Prints the card's name and power limit, then one JSON line per variant and
request with the median of 10 CUDA-event timings around the wrapper
(``ms``; ``all_ms`` sorted), the device time of the item and merge kernels (torch.profiler,
a call) and the median CUDA-event time of the wrapper's item plan alone
(``plan_ms``: the library's plan kernel and its glue). A
variant is not a correct kernel; only ``base`` and the plan variants are,
and ``base``'s time is the kernel's.

- ``base``: the kernel as committed;
- ``no_score``: no lookups (each row's distance from its row number);
- ``no_lut``: no table build (the tables hold whatever was there);
- ``no_select``: no queue insertions (the partial lists stay empty);
- ``lut_only``: no lookups and no queue insertions (table builds,
  code-free tiles, merge);
- ``g1``: one pair an item in place of the plan's group (a correct
  kernel: the one-pair-a-table shape of the earlier design);
- ``ca``, ``stage8``, ``ca8``: the staging copies cached in L1 as well
  (``cp.async.ca``), eight subspaces a stage, or both.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE = """        float v;
        if constexpr (kCodes == kCodesW64)
          v = score_row_w64<T, false>(tab, src, a.lg_book, lg_gp, g);
        else if constexpr (kCodes == kCodesW64Packed)
          v = score_row_w64<T, true>(tab, src, a.lg_book, lg_gp, g);
        else
          v = score_row_any<T>(tab, src, a, lg_gp, g);"""
BUILD = ("    build_tables<T>(tab, cbs, a, qs, qn, m_scale, lid, cnt, lg_gp, "
         "false);")
SELECT = """        queue_op(a.S, area, qcnt, qthr, 1, a.k, d, in ? It[r] : kEmptyId,
                 in && d < CUDART_INF_F);"""
GROUPS = "  for (int group = kMaxG; group >= 1; group /= 2) {"
CP16 = "      cp_async16(cbs + il * JL + o, src, true);"
CP16N = "        cp_async16(cbn + il * J + o, src, true);"
STAGE_CAP = "    if (stage > pq_dim) stage = pq_dim;"


def _ca(dst):
    return ("{ const unsigned sa = (unsigned)__cvta_generic_to_shared(" + dst
            + "); asm volatile(\"cp.async.ca.shared.global [%0], [%1], 16;"
            "\\n\" :: \"r\"(sa), \"l\"(src) : \"memory\"); }")

VARIANTS = {
    "base": [],
    "no_score": [(SCORE, "        float v = (float)(row & 7) + 0.f * (float)(size_t)src;")],
    "no_lut": [(BUILD, "")],
    "no_select": [(SELECT, "        (void)d;")],
    "lut_only": [(SCORE, "        float v = (float)(row & 7) + 0.f * (float)(size_t)src;"),
                 (SELECT, "        (void)d;")],
    "g1": [(GROUPS, "  for (int group = 1; group >= 1; group /= 2) {")],
    "ca": [(CP16, "      " + _ca("cbs + il * JL + o")),
           (CP16N, "        " + _ca("cbn + il * J + o"))],
    "stage8": [(STAGE_CAP, "    if (stage > 8) stage = 8;")],
    "ca8": [(CP16, "      " + _ca("cbs + il * JL + o")),
            (CP16N, "        " + _ca("cbn + il * J + o")),
            (STAGE_CAP, "    if (stage > 8) stage = 8;")],
}


def _variant_dirs(name: str):
    base = os.path.join(ROOT, "raft_tpu_torch", "_build", "variants", name)
    return os.path.join(base, "csrc"), os.path.join(base, "build")


def _patch(name: str, csrc: str) -> None:
    src, _ = _variant_dirs(name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    path = os.path.join(src, "ivf_pq_scan.cu")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: source text not found: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def build(names) -> list:
    """Patch and compile every variant's library at once; returns the
    variants that built."""
    sys.path.insert(0, ROOT)
    from raft_tpu_torch.ops import _build

    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    procs = []
    for name in names:
        _patch(name, csrc)
        _build.CSRC, _build.BUILD_DIR = _variant_dirs(name)
        out = _build._library_path("ivf_pq_scan")
        if not os.path.exists(out):
            procs.append((name, out, _build._start("ivf_pq_scan", out)))
    built = [n for n in names if n not in {p[0] for p in procs}]
    for name, out, proc in procs:
        try:
            _build._finish("ivf_pq_scan", out, proc)
            built.append(name)
        except RuntimeError as e:
            print(f"variant {name} does not build: {e}", flush=True)
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    return [n for n in names if n in built]


def _uniform(torch, ops):
    g = torch.Generator(device="cuda").manual_seed(0)
    n_lists, m, pq_dim, L, book, q, p = 1024, 2400, 64, 2, 256, 500, 128
    codes = torch.randint(0, book, (n_lists, m, pq_dim), generator=g,
                          device="cuda", dtype=torch.int32).to(torch.uint8)
    ids = torch.arange(n_lists * m, device="cuda",
                       dtype=torch.int32).reshape(n_lists, m)
    cb = torch.randn(pq_dim, book, L, generator=g, device="cuda")
    probes = torch.stack([torch.randperm(n_lists, generator=g,
                                         device="cuda")[:p]
                          for _ in range(q)]).to(torch.int32)
    qres = torch.randn(q, p, pq_dim * L, generator=g, device="cuda")
    return (qres, None, cb, ops.codebook_norms(cb), codes, ids, probes,
            None), False


def _skewed(torch, ops, batch: int = 500, n_probes: int = 128):
    import chip_smoke
    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.ivf_bq import _coarse

    x, queries = chip_smoke.make_data(torch, 0)
    index = ivf_pq.build(Resources(device="cuda", seed=0),
                         ivf_pq.IvfPqIndexParams(**chip_smoke.PQ_BUILD), x)
    del x
    qf = queries[:batch]
    probes, _, _ = _coarse(index.centers, index.metric, qf, n_probes,
                           "exact")
    lists = probes.to(torch.int64)
    qres = (qf[:, None, :] - index.centers[lists]) @ index.rotation.T
    return (qres, None, index.codebooks, ops.codebook_norms(index.codebooks),
            index.codes, index.indices, probes, None), index.packed


def run(name: str, data: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    _build.CSRC, _build.BUILD_DIR = _variant_dirs(name)
    if data == "uniform":
        args, packed = _uniform(torch, ops)
    else:
        args, packed = _skewed(torch, ops, *((10, 32) if data == "small"
                                             else (500, 128)))
    kw = dict(k=10, ip_metric=False, per_cluster=False,
              lut_dtype=torch.float32, packed=packed, engine="cuda")
    for _ in range(3):
        ops.ivf_pq_scan(*args, **kw)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ops.ivf_pq_scan(*args, **kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.ivf_pq_scan(*args, **kw)
        torch.cuda.synchronize()
    dev_us = {}
    for e in prof.key_averages():
        for key in ("pq_items_kernel", "merge_partials"):
            if key in e.key:
                dev_us[key] = dev_us.get(key, 0.0) + (
                    e.self_device_time_total / 3)
    rows, group = next(v for key, v in ops._PLANS.items() if key != "items")
    plan_ms = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ops._pq_items_cuda(args[6], args[5], 10, rows, group)
        b.record()
        b.synchronize()
        plan_ms.append(a.elapsed_time(b))
    plan_ms.sort()
    print(json.dumps({"variant": name, "data": data,
                      "ms": times[len(times) // 2], "all_ms": times,
                      "device_us": dev_us, "plan_ms": plan_ms[5],
                      "rows_group": [rows, group]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--data", default="uniform,skewed")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        name, data = args.one.split(":")
        run(name, data)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    names = build(args.variants.split(","))
    rc = 0
    for data in args.data.split(","):
        for name in names:
            rc |= subprocess.run([sys.executable, __file__, "--one",
                                  f"{name}:{data}"]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
