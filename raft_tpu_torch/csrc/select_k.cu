// Exact k-selection over wide rows: the Hopper port of the JAX package's
// `_select_kernel` (raft_tpu/ops/fused_topk.py, `select_k_tiles`), the
// streamed wide-row route of `matrix.select_k`.
//
// The TPU kernel streams column tiles of all rows through one running
// (b, k) state in VMEM. Here the columns of each row are split across
// warps instead: each warp scans one column chunk of one row, 32 lanes on
// 32 neighbouring columns, several loads in flight, and keeps that
// chunk's top-k in shared memory by the warp insertion of
// topk_common.cuh; the shared merge kernel then reduces the (b, splits, k)
// partial lists per row. Values are compared in float32 in min-space
// (select-max negated), ties go to the smaller column, and only finite
// values enter: a row with fewer than k finite values ends in (+inf, -1)
// slots, the JAX kernel's documented caveat.
//
// Bound on the H100: one read of the (b, n) input at HBM rate; the
// insertion work is a ballot per 32 columns once a list is warm.
#include <cuda_fp16.h>

#include "topk_common.cuh"

namespace raft_tpu_torch {

constexpr int kSelWarps = 8;   // warps (row chunks) per block
constexpr int kSelUnroll = 8;  // loads in flight per lane

__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(kSelWarps * 32) select_partial_kernel(
    const T* __restrict__ v, int b, int n, int k, int select_max,
    int splits, int chunk, float* __restrict__ pd, int* __restrict__ pi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ld = reinterpret_cast<float*>(smem_raw) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem_raw) +
                                   kSelWarps * k) + warp * k;
  const int unit = blockIdx.x * kSelWarps + warp;
  for (int j = lane; j < k; j += 32) {
    ld[j] = CUDART_INF_F;
    li[j] = kEmptyId;
  }
  if (unit >= b * splits) return;  // whole warp leaves together
  const int row = unit / splits, split = unit % splits;
  const int c0 = split * chunk, c1 = min(n, c0 + chunk);
  const T* rv = v + (size_t)row * n;
  for (int base = c0; base < c1; base += 32 * kSelUnroll) {
    float x[kSelUnroll];
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      const int c = base + u * 32 + lane;
      x[u] = c < c1 ? to_f32(rv[c]) : CUDART_INF_F;
    }
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      const float val = select_max ? -x[u] : x[u];
      warp_insert(ld, li, k, val, base + u * 32 + lane,
                  fabsf(val) < CUDART_INF_F);  // finite only
    }
  }
  __syncwarp();
  float* od = pd + (size_t)unit * k;
  int* oi = pi + (size_t)unit * k;
  for (int j = lane; j < k; j += 32) {
    od[j] = ld[j];
    oi[j] = li[j];
  }
}

template <typename T>
cudaError_t launch_select(const T* v, int b, int n, int k, int select_max,
                          int splits, int chunk, float* pd, int* pi,
                          float* outd, int* outi, cudaStream_t stream) {
  const size_t smem = (size_t)kSelWarps * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      select_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (b * splits + kSelWarps - 1) / kSelWarps;
  select_partial_kernel<T><<<blocks, kSelWarps * 32, smem, stream>>>(
      v, b, n, k, select_max, splits, chunk, pd, pi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(pd, pi, b, splits * k, k,
                      select_max ? kEpilogNegate : kEpilogNone, outd, outi,
                      stream);
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. v (b, n) row-major in float32 (dtype 0),
// bfloat16 (1) or float16 (2); columns split into `splits` chunks of
// `chunk`; pd/pi (b, splits, k) scratch; outd (b, k) float32 values in
// the caller's direction, outi (b, k) int32 columns (-1 where no finite
// value was left). Returns cudaError_t.
extern "C" int raft_select_k(const void* v, int dtype, int b, int n, int k,
                             int select_max, int splits, int chunk, void* pd,
                             void* pi, void* outd, void* outi,
                             void* stream) {
  if (k < 1 || k > 128 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* fd = (float*)pd;
  int* id = (int*)pi;
  if (dtype == 1)
    return (int)launch_select<__nv_bfloat16>((const __nv_bfloat16*)v, b, n,
                                             k, select_max, splits, chunk,
                                             fd, id, (float*)outd,
                                             (int*)outi, s);
  if (dtype == 2)
    return (int)launch_select<__half>((const __half*)v, b, n, k, select_max,
                                      splits, chunk, fd, id, (float*)outd,
                                      (int*)outi, s);
  return (int)launch_select<float>((const float*)v, b, n, k, select_max,
                                   splits, chunk, fd, id, (float*)outd,
                                   (int*)outi, s);
}
