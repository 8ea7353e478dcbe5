// Building blocks shared by the port's hand-written search kernels
// (fused_knn.cu, ivf_scan.cu): a 64 x 64 float32 dot-product tile on the
// CUDA cores, a warp-cooperative insertion into a sorted top-k list in
// shared memory, and the kernel that merges per-block partial top-k
// lists into the final (q, k) result.
//
// Order everywhere is lexicographic on (distance, id): the smallest
// distance first, and on equal distances the smallest id first. That is
// the order of the JAX package's `_extract_topk` (k rounds of min /
// smallest id / mask), so a merge of partial lists in any grouping gives
// the same (distance, id) list as one pass over all candidates.
// Only finite distances enter a list; an unfilled slot is (+inf, -1) on
// output, as `_extract_topk` writes -1 for a non-finite slot.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace raft_tpu_torch {

constexpr int kQT = 64;         // query rows per block tile
constexpr int kDT = 64;         // dataset rows per block tile
constexpr int kDK = 32;         // depth of one shared-memory stage
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kStride = 65;     // padded row stride of the smem tiles
constexpr int kMergeWarps = 8;  // queries merged per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmptyId = 0x7fffffff;

enum Epilog { kEpilogNone = 0, kEpilogSqrt = 1, kEpilogNegate = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool lex_less(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// acc[i][j] = sum_t Q[qidx[ty*4+i]][t] * X[tx+16j][t] over the full depth
// d, in float32 with one fused multiply-add per term, in order of t.
// qidx[r] < 0 marks an empty query row; X rows >= nx read as zeros.
// The query rows at and past nq are all empty: a thread whose four rows
// all lie there skips its products. All 256 threads of the block must call it
// (it synchronizes).
template <typename XT>
__device__ __forceinline__ void dot_tile(float acc[4][4],
                                         const float* __restrict__ Q,
                                         const int* qidx, int nq,
                                         const XT* __restrict__ X, int nx,
                                         int d, float* Qs, float* Xs) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kDK) {
    // a warp loads one row's 32 consecutive values: coalesced reads, and
    // the transposed smem writes hit 32 distinct banks (stride 65)
#pragma unroll
    for (int r = 0; r < (kQT * kDK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kDK, col = e % kDK, dd = d0 + col;
      const int qi = qidx[row];
      Qs[col * kStride + row] =
          (qi >= 0 && dd < d) ? Q[(size_t)qi * d + dd] : 0.f;
      Xs[col * kStride + row] =
          (row < nx && dd < d) ? to_f32(X[(size_t)row * d + dd]) : 0.f;
    }
    __syncthreads();
    if (ty * 4 < nq) {
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[kk * kStride + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Xs[kk * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    }
    __syncthreads();
  }
}

// Insert each lane's candidate (cd, ci), where `valid`, into the sorted
// list (ld, li) of length k <= 128 in shared memory. The whole warp calls
// it; candidates that beat the list's current k-th entry are inserted
// one at a time: each lane holds up to four slots, a ballot finds the
// insertion point, and the tail shifts right by one.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int k,
                                            float cd, int ci, bool valid) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  unsigned want =
      __ballot_sync(kFull, valid && lex_less(cd, ci, ld[k - 1], li[k - 1]));
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float d = __shfl_sync(kFull, cd, src);
    const int id = __shfl_sync(kFull, ci, src);
    // the list moved since the ballot: re-test (same value in all lanes)
    if (!lex_less(d, id, ld[k - 1], li[k - 1])) continue;
    int pos = 0;
    float pd[4];
    int pi[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = lane + 32 * s;
      const bool in = j < k;
      const bool less = in && lex_less(ld[j], li[j], d, id);
      pos += __popc(__ballot_sync(kFull, less));
      pd[s] = (in && j > 0) ? ld[j - 1] : 0.f;
      pi[s] = (in && j > 0) ? li[j - 1] : 0;
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = lane + 32 * s;
      if (j < k && j > pos) {
        ld[j] = pd[s];
        li[j] = pi[s];
      } else if (j == pos) {
        ld[j] = d;
        li[j] = id;
      }
    }
    __syncwarp();
  }
}

// A sorted list of k <= 32 entries held one a lane in registers (md, mi),
// its k-th entry (kd, ki) in every lane: insert each lane's candidate
// (cd, ci), where `valid` and it beats the k-th entry, one at a time (a
// ballot finds the place, one shuffle moves the tail). The same list
// results as warp_insert's: the k smallest (distance, id) pairs of the
// list and the candidates. Returns whether the list changed (uniform).
__device__ __forceinline__ bool warp_insert_regs(float& md, int& mi,
                                                 float& kd, int& ki, int k,
                                                 float cd, int ci,
                                                 bool valid) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < k;
  unsigned want = __ballot_sync(kFull, valid && lex_less(cd, ci, kd, ki));
  const bool any = want != 0;
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float d = __shfl_sync(kFull, cd, src);
    const int id = __shfl_sync(kFull, ci, src);
    if (!lex_less(d, id, kd, ki)) continue;  // the list moved: re-test
    const int pos =
        __popc(__ballot_sync(kFull, in && lex_less(md, mi, d, id)));
    const float ud = __shfl_up_sync(kFull, md, 1);
    const int ui = __shfl_up_sync(kFull, mi, 1);
    if (in && lane > pos) {
      md = ud;
      mi = ui;
    } else if (lane == pos) {
      md = d;
      mi = id;
    }
    kd = __shfl_sync(kFull, md, k - 1);
    ki = __shfl_sync(kFull, mi, k - 1);
  }
  return any;
}

// warp_insert for k <= 32, through warp_insert_regs.
__device__ __forceinline__ void warp_insert_small(float* ld, int* li, int k,
                                                  float cd, int ci,
                                                  bool valid) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const bool in = lane < k;
  float md = in ? ld[lane] : CUDART_INF_F;
  int mi = in ? li[lane] : kEmptyId;
  float kd = __shfl_sync(kFull, md, k - 1);
  int ki = __shfl_sync(kFull, mi, k - 1);
  if (warp_insert_regs(md, mi, kd, ki, k, cd, ci, valid) && in) {
    ld[lane] = md;
    li[lane] = mi;
  }
  __syncwarp();
}

__device__ __forceinline__ void init_lists(float* ld, int* li, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    ld[t] = CUDART_INF_F;
    li[t] = kEmptyId;
  }
}

// Merge `parts` partial lists of k entries per query, laid out
// (q, parts * k), into (q, k): one warp per query. Applies the metric's
// final step (sqrt, or the sign of inner products) and writes id -1 for
// every slot no finite candidate filled.
__global__ void merge_partials_kernel(const float* __restrict__ pd,
                                      const int* __restrict__ pi, int q,
                                      int m, int k, int epilog,
                                      float* __restrict__ outd,
                                      int* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ld = reinterpret_cast<float*>(smem_raw) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem_raw) +
                                   kMergeWarps * k) + warp * k;
  const int row = blockIdx.x * kMergeWarps + warp;
  for (int j = lane; j < k; j += 32) {
    ld[j] = CUDART_INF_F;
    li[j] = kEmptyId;
  }
  if (row >= q) return;  // whole warp leaves together
  const float* rd = pd + (size_t)row * m;
  const int* ri = pi + (size_t)row * m;
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < m;
    const float v = in ? rd[c] : CUDART_INF_F;
    const int id = in ? ri[c] : kEmptyId;
    warp_insert(ld, li, k, v, id, in && v < CUDART_INF_F);
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    float v = ld[j];
    const bool filled = v < CUDART_INF_F;
    if (epilog == kEpilogSqrt) v = sqrtf(v);
    if (epilog == kEpilogNegate) v = -v;
    outd[(size_t)row * k + j] = v;
    outi[(size_t)row * k + j] = filled ? li[j] : -1;
  }
}

inline cudaError_t launch_merge(const float* pd, const int* pi, int q, int m,
                                int k, int epilog, float* outd, int* outi,
                                cudaStream_t stream) {
  const size_t smem = (size_t)kMergeWarps * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      merge_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (q + kMergeWarps - 1) / kMergeWarps;
  merge_partials_kernel<<<blocks, kMergeWarps * 32, smem, stream>>>(
      pd, pi, q, m, k, epilog, outd, outi);
  return cudaGetLastError();
}

// The ragged merge of the IVF scans: query `row` owns the partial lists
// row_off[row * off_stride] .. row_off[(row + 1) * off_stride] of k
// entries each (hundreds at n_probes 128). One block a query: each warp
// takes every kMergeWarps-th run of 32 entries into a list of its own,
// then warp 0 takes the other warps' lists into its own. The top-k of a
// union does not depend on how it is split, so the result is the one
// list a single warp would merge. Epilog and -1 ids as above.
__device__ __forceinline__ void merge_insert(float* ld, int* li, int k,
                                             float v, int id, bool valid) {
  if (k <= 32)
    warp_insert_small(ld, li, k, v, id, valid);
  else
    warp_insert(ld, li, k, v, id, valid);
}

__global__ void merge_ragged_kernel(const float* __restrict__ pd,
                                    const int* __restrict__ pi, int k,
                                    int epilog, const int* __restrict__ row_off,
                                    int off_stride, float* __restrict__ outd,
                                    int* __restrict__ outi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* lists_d = reinterpret_cast<float*>(smem_raw);
  int* lists_i = reinterpret_cast<int*>(lists_d + kMergeWarps * k);
  float* ld = lists_d + warp * k;
  int* li = lists_i + warp * k;
  const int row = blockIdx.x;
  for (int j = lane; j < k; j += 32) {
    ld[j] = CUDART_INF_F;
    li[j] = kEmptyId;
  }
  const size_t base = (size_t)row_off[(size_t)row * off_stride] * k;
  const int len = (row_off[(size_t)(row + 1) * off_stride] -
                   row_off[(size_t)row * off_stride]) * k;
  const float* rd = pd + base;
  const int* ri = pi + base;
  for (int c0 = warp * 32; c0 < len; c0 += kMergeWarps * 32) {
    const int c = c0 + lane;
    const bool in = c < len;
    const float v = in ? rd[c] : CUDART_INF_F;
    const int id = in ? ri[c] : kEmptyId;
    merge_insert(ld, li, k, v, id, in && v < CUDART_INF_F);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kMergeWarps; ++w)
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int c = c0 + lane;
      const bool in = c < k;
      const float v = in ? lists_d[w * k + c] : CUDART_INF_F;
      const int id = in ? lists_i[w * k + c] : kEmptyId;
      merge_insert(ld, li, k, v, id, in && v < CUDART_INF_F);
    }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    float v = ld[j];
    const bool filled = v < CUDART_INF_F;
    if (epilog == kEpilogSqrt) v = sqrtf(v);
    if (epilog == kEpilogNegate) v = -v;
    outd[(size_t)row * k + j] = v;
    outi[(size_t)row * k + j] = filled ? li[j] : -1;
  }
}

inline cudaError_t launch_merge_ragged(const float* pd, const int* pi, int q,
                                       int k, int epilog, const int* row_off,
                                       int off_stride, float* outd, int* outi,
                                       cudaStream_t stream) {
  const size_t smem = (size_t)kMergeWarps * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      merge_ragged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (q == 0) return cudaSuccess;
  merge_ragged_kernel<<<q, kMergeWarps * 32, smem, stream>>>(
      pd, pi, k, epilog, row_off, off_stride, outd, outi);
  return cudaGetLastError();
}

}  // namespace raft_tpu_torch
