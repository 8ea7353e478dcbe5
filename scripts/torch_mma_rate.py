#!/usr/bin/env python3
"""Issue rates of the instructions fused_knn.cu is built from, on the card:

    python3 scripts/torch_mma_rate.py

Builds a small CUDA library with nvcc (sm_90a) into a temporary directory
and times, with CUDA events, kernels whose warps issue long runs of
independent ``mma.sync`` m16n8k8 TF32 and m16n8k16 bf16 products (eight
accumulators a warp) and of ``cvt.rna.tf32.f32``, at 8 and 16 warps an
SM. Prints each rate against the card's clock (operations per clock per
SM, from the SXM part's 1.98 GHz boost clock) and the card's name and
power limit as one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

SRC = r"""
#include <cuda_runtime.h>
extern "C" __global__ void mma_tf32(float* out, int iters) {
  float c[8][4] = {};
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + threadIdx.x * 1e-3f + i);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void mma_bf16(float* out, int iters) {
  float c[8][4] = {};
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f003f00u + threadIdx.x + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void cvt_rna(float* out, int iters) {
  unsigned x[8];
  for (int j = 0; j < 8; ++j) x[j] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + j);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned r;
      asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(x[j] ^ it)));
      x[j] = r;
    }
  unsigned s = 0;
  for (int j = 0; j < 8; ++j) s ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = __uint_as_float(s);
}
extern "C" int launch(int which, float* out, int blocks, int threads, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) mma_tf32<<<blocks, threads, 0, s>>>(out, iters);
  else if (which == 1) mma_bf16<<<blocks, threads, 0, s>>>(out, iters);
  else cvt_rna<<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "rate.cu"), os.path.join(tmp, "rate.so")
        with open(src, "w") as f:
            f.write(SRC)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
                        src], check=True)
        so = ctypes.CDLL(lib)
        so.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        out = torch.empty(sms * 1024, device="cuda")
        res = {"card": card}
        iters = 4096
        for which, name in ((0, "mma_tf32_m16n8k8"), (1, "mma_bf16_m16n8k16"),
                            (2, "cvt_rna_tf32")):
            for warps in (8, 16):
                args = (which, out.data_ptr(), sms, warps * 32, iters,
                        torch.cuda.current_stream().cuda_stream)
                so.launch(*args)
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                so.launch(*args)
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
                ops = warps * iters * 8       # instructions a block (an SM)
                res[f"{name} warps={warps}"] = {
                    "ms": ms, "per_clock_per_sm":
                    ops / (ms * 1e-3 * 1.98e9)}
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
