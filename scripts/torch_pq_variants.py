#!/usr/bin/env python3
"""Split the IVF-PQ LUT scan kernel's time by building patched copies of
``csrc/ivf_pq_scan.cu`` with one phase cut out:

    python3 scripts/torch_pq_variants.py [--variants base,no_score,...]

Each variant copies ``raft_tpu_torch/csrc`` into ``raft_tpu_torch/_build/
variants/<name>`` (ignored by git), replaces the phase's source text, and
runs in a process of its own (two builds of one source loaded into one
process interpose each other's symbols). The request is synthetic and
(128, 500)-like: 1,024 lists of 2,400 live rows, pq_dim 64, 8-bit codes,
500 queries x 128 random probes, k = 10, float32 LUT. Prints the card's
name and power limit, then one JSON line per variant with the median of
10 CUDA-event timings around the wrapper. A variant is not a correct
kernel; only ``base`` is, and its time is the kernel's.

- ``base``: the kernel as committed;
- ``no_score``: each row's distance from its id instead of the LUT sum;
- ``no_lut``: no LUT build (the table holds whatever was there);
- ``no_stage``: no copy of the code rows into the shared tile;
- ``lut_only``: no row loop at all (LUT build, queues, merge);
- ``t256``, ``t1024``: blocks of 256 or 1,024 threads in place of 512
  (correct kernels, other block sizes).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "base": [],
    "no_score": [("        score_groups<false>(lut, tb + tid * sb, a, 0, "
                  "a.groups, st, total);", ""),
                 ("        d = total;", "        d = (float)(id & 7);")],
    "no_lut": [("s < a.pq_dim; s += step) {", "s < 0; s += step) {")],
    "no_stage": [("    if (quads) {", "    if (false) {"),
                 ("    } else if (words) {", "    } else if (false) {"),
                 ("    } else {\n      const unsigned char* g",
                  "    } else if (false) {\n      const unsigned char* g")],
    "lut_only": [("  for (int r0 = 0; r0 < n_rows; r0 += a.row_tile) {",
                  "  for (int r0 = 0; r0 < 0; r0 += a.row_tile) {")],
    "t256": [("return s <= 4 ? 512 : 256;", "return s <= 4 ? 256 : 256;")],
    "t1024": [("return s <= 4 ? 512 : 256;", "return s <= 4 ? 1024 : 256;")],
}


def run(name: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    base = os.path.join(ROOT, "raft_tpu_torch", "_build", "variants", name)
    src = os.path.join(base, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    path = os.path.join(src, "ivf_pq_scan.cu")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: source text not found: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    _build.CSRC, _build.BUILD_DIR = src, os.path.join(base, "build")

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
    args = (qres, None, cb, ops.codebook_norms(cb), codes, ids, probes, None)
    kw = dict(k=10, ip_metric=False, per_cluster=False,
              lut_dtype=torch.float32, packed=False, engine="cuda")
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
    print(json.dumps({"variant": name, "ms": times[len(times) // 2]}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run(args.one)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for name in args.variants.split(","):
        rc |= subprocess.run([sys.executable, __file__, "--one", name]
                             ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
