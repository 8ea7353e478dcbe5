// Building blocks shared by the port's hand-written search kernels
// (fused_knn.cu, select_k.cu, ivf_scan.cu, bq_scan.cu, tier_scan.cu):
// cp.async helpers, a warp-cooperative insertion into a sorted top-k list
// (shared memory or registers), the filtered warp queue (a sorted list
// and a candidate buffer merged by bitonic networks in registers), and
// the kernels that merge per-block partial top-k lists into the final
// (q, k) result.
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

constexpr int kQT = 64;         // query rows per block tile (IVF scans)
constexpr int kThreads = 256;   // threads a block (IVF scans)
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait_group with a count known at run time (a ring whose depth the host
// chose), 0 <= n <= 7
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
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

// ---------------------------------------------------------------------------
// The filtered warp queue (the reference's `warp_sort_filtered`,
// matrix/detail/select_warpsort.cuh). A warp keeps a sorted list of
// KP = 32 * S entries and a buffer of KP candidates in shared memory, and
// a threshold key in a register. A candidate enters the buffer only when
// its key is not above the threshold, so past the first entries most
// candidates cost one compare and one vote. A full buffer is merged into
// the list at once: both go to registers (S a lane, entry e in slot e / 32
// of lane e % 32), the buffer is sorted by a bitonic network, the list
// keeps the smaller of list[e] and buffer[KP - 1 - e] (the KP smallest of
// the two, in a bitonic sequence), and a bitonic merge sorts that. The
// first KP candidates are thus put in order at once, not one at a time.
// After a merge the threshold is the key of the list's k-th entry, once
// the list holds k: a candidate past it already has k better entries. Any other list's k-th entry is as good a bound (the caller may
// lower the threshold to it): the filter drops only candidates with k
// better entries somewhere, so the k best always reach some list.
// ---------------------------------------------------------------------------

typedef unsigned long long u64;
constexpr u64 kNoBound = ~0ull;  // the threshold of a list short of k

// Order-preserving key of a finite min-space value and its id: keys
// compare as (value, id) does under lex_less (-0 is taken as +0, as a
// float compare does).
__device__ __forceinline__ u64 lex_key(float v, int id) {
  unsigned u = __float_as_uint(v + 0.f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (unsigned)id;
}

// The value part of a key: a float that no candidate below the key
// exceeds (+inf for kNoBound), for a quick compare before the exact one.
__device__ __forceinline__ float key_value(u64 key) {
  unsigned u = (unsigned)(key >> 32);
  if (u >= 0xff800000u) return CUDART_INF_F;
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// a word shared between blocks (a bound other blocks lower), read
// through L2
__device__ __forceinline__ u64 load_l2(const u64* p) {
  u64 v;
  asm volatile("ld.global.cg.u64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}

// One compare-exchange pass of a bitonic network over KP = 32 * S
// entries: entry e pairs with e ^ stride, ascending where (e & size) == 0.
// Pairs in one slot exchange through shuffles, pairs across slots in
// registers. size and stride are compile-time after unrolling.
template <int S>
__device__ __forceinline__ void bitonic_pass(float (&d)[S], int (&id)[S],
                                             int size, int stride) {
  const int lane = threadIdx.x & 31;
  if (stride >= 32) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int t = s ^ (stride >> 5);
      if (t > s) {
        const bool asc = ((s * 32) & size) == 0;
        if (asc == lex_less(d[t], id[t], d[s], id[s])) {
          const float x = d[s];
          const int xi = id[s];
          d[s] = d[t];
          id[s] = id[t];
          d[t] = x;
          id[t] = xi;
        }
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float od = __shfl_xor_sync(kFull, d[s], stride);
      const int oi = __shfl_xor_sync(kFull, id[s], stride);
      const bool asc = ((s * 32 + lane) & size) == 0;
      const bool keep_min = ((lane & stride) == 0) == asc;
      if (keep_min == lex_less(od, oi, d[s], id[s])) {
        d[s] = od;
        id[s] = oi;
      }
    }
  }
}

// log2 of KP = 32 * S
template <int S>
__host__ __device__ constexpr int log2_kp() {
  return S == 1 ? 5 : S == 2 ? 6 : S == 4 ? 7 : S == 8 ? 8 : 9;
}

template <int S>
__device__ __forceinline__ void bitonic_sort(float (&d)[S], int (&id)[S]) {
#pragma unroll
  for (int ls = 1; ls <= log2_kp<S>(); ++ls)
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt)
      bitonic_pass<S>(d, id, 1 << ls, 1 << lt);
}

// sorts a bitonic sequence ascending
template <int S>
__device__ __forceinline__ void bitonic_merge(float (&d)[S], int (&id)[S]) {
#pragma unroll
  for (int lt = log2_kp<S>() - 1; lt >= 0; --lt)
    bitonic_pass<S>(d, id, 32 * S, 1 << lt);
}

// Merges the buffer's `count` candidates into the sorted list (ld, li)
// and returns the threshold after it: the key of the list's k-th entry
// once the list holds k entries, never above `thr`. The whole warp calls
// it; one call site per kernel (not one per unrolled candidate).
template <int S>
__device__ __noinline__ u64 queue_flush(float* ld, int* li, const float* bd,
                                        const int* bi, int count, int k,
                                        u64 thr) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float d[S], b[S];
  int id[S], bid[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = s * 32 + lane;
    b[s] = e < count ? bd[e] : CUDART_INF_F;
    bid[s] = e < count ? bi[e] : kEmptyId;
    d[s] = ld[e];
    id[s] = li[e];
  }
  bitonic_sort<S>(b, bid);
#pragma unroll
  for (int s = 0; s < S; ++s) {  // entry e meets buffer entry KP - 1 - e
    const float od = __shfl_xor_sync(kFull, b[S - 1 - s], 31);
    const int oi = __shfl_xor_sync(kFull, bid[S - 1 - s], 31);
    if (lex_less(od, oi, d[s], id[s])) {
      d[s] = od;
      id[s] = oi;
    }
  }
  bitonic_merge<S>(d, id);
  float kd = CUDART_INF_F;
  int ki = kEmptyId;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ld[s * 32 + lane] = d[s];
    li[s * 32 + lane] = id[s];
    const float x = __shfl_sync(kFull, d[s], (k - 1) & 31);
    const int xi = __shfl_sync(kFull, id[s], (k - 1) & 31);
    if (s == ((k - 1) >> 5)) {
      kd = x;
      ki = xi;
    }
  }
  __syncwarp();
  if (ki != kEmptyId) {
    const u64 key = lex_key(kd, ki);
    if (key < thr) thr = key;
  }
  return thr;
}

// Offers each lane's candidate (v, id) where `want` (the caller excludes
// non-finite values): it goes to the buffer when its key is at most the
// threshold, after a merge when the buffer would overflow. Inclusive: when
// lists are merged, the entry whose key another list's threshold came
// from is itself a candidate (a new candidate of a scan never has a
// list entry's key). count and thr are the warp's queue state, the same
// in every lane.
template <int S>
__device__ __forceinline__ void queue_push(float* ld, int* li, float* bd,
                                           int* bi, int& count, u64& thr,
                                           int k, float v, int id,
                                           bool want) {
  const u64 key = lex_key(v, id);
  bool pass = want && key <= thr;
  unsigned mask = __ballot_sync(kFull, pass);
  if (!mask) return;
  if (count + __popc(mask) > 32 * S) {
    thr = queue_flush<S>(ld, li, bd, bi, count, k, thr);
    count = 0;
    pass = pass && key <= thr;
    mask = __ballot_sync(kFull, pass);
  }
  if (pass) {
    const int pos =
        count + __popc(mask & ((1u << (threadIdx.x & 31)) - 1u));
    bd[pos] = v;
    bi[pos] = id;
  }
  count += __popc(mask);
}

// An empty list of KP entries (+inf, kEmptyId), written by one warp.
template <int S>
__device__ __forceinline__ void queue_init(float* ld, int* li) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ld[s * 32 + (threadIdx.x & 31)] = CUDART_INF_F;
    li[s * 32 + (threadIdx.x & 31)] = kEmptyId;
  }
  __syncwarp();
}

// Merge `parts` partial lists of k entries per query, laid out
// (q, parts * k), into (q, k): one warp per query, through the filtered
// queue (four loads a lane in flight). With `row_off` the runs are
// ragged: query `row` owns the lists row_off[row * off_stride] ..
// row_off[(row + 1) * off_stride] (m is then unused). Applies the
// metric's final step (sqrt, or the sign of inner products) and writes
// id -1 for every slot no finite candidate filled.
template <int S>
__global__ void __launch_bounds__(kMergeWarps * 32)
    merge_partials_kernel(const float* __restrict__ pd,
                          const int* __restrict__ pi, int q, int m, int k,
                          int epilog, float* __restrict__ outd,
                          int* __restrict__ outi,
                          const int* __restrict__ row_off, int off_stride) {
  constexpr int KP = 32 * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ld = reinterpret_cast<float*>(smem_raw) + warp * 4 * KP;
  int* li = reinterpret_cast<int*>(ld + KP);
  float* bd = ld + 2 * KP;
  int* bi = reinterpret_cast<int*>(ld + 3 * KP);
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= q) return;  // whole warp leaves together; no block barrier
  queue_init<S>(ld, li);
  int count = 0;
  u64 thr = kNoBound;
  size_t base = (size_t)row * m;
  if (row_off) {
    base = (size_t)row_off[(size_t)row * off_stride] * k;
    m = (row_off[(size_t)(row + 1) * off_stride] -
         row_off[(size_t)row * off_stride]) * k;
  }
  const float* rd = pd + base;
  const int* ri = pi + base;
  for (int c0 = 0; c0 < m; c0 += 128) {
    float v[4];
    int id[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * 32 + lane;
      v[u] = c < m ? rd[c] : CUDART_INF_F;
      id[u] = c < m ? ri[c] : kEmptyId;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      queue_push<S>(ld, li, bd, bi, count, thr, k, v[u], id[u],
                    v[u] < CUDART_INF_F);
  }
  if (count) thr = queue_flush<S>(ld, li, bd, bi, count, k, thr);
  for (int j = lane; j < k; j += 32) {
    float v = ld[j];
    const bool filled = v < CUDART_INF_F;
    if (epilog == kEpilogSqrt) v = sqrtf(v);
    if (epilog == kEpilogNegate) v = -v;
    outd[(size_t)row * k + j] = v;
    outi[(size_t)row * k + j] = filled ? li[j] : -1;
  }
}

template <int S>
cudaError_t launch_merge_s(const float* pd, const int* pi, int q, int m,
                           int k, int epilog, float* outd, int* outi,
                           cudaStream_t stream,
                           const int* row_off = nullptr,
                           int off_stride = 0) {
  const size_t smem = (size_t)kMergeWarps * 4 * 32 * S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      merge_partials_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (q == 0) return cudaSuccess;
  const int blocks = (q + kMergeWarps - 1) / kMergeWarps;
  merge_partials_kernel<S><<<blocks, kMergeWarps * 32, smem, stream>>>(
      pd, pi, q, m, k, epilog, outd, outi, row_off, off_stride);
  return cudaGetLastError();
}

inline cudaError_t launch_merge(const float* pd, const int* pi, int q, int m,
                                int k, int epilog, float* outd, int* outi,
                                cudaStream_t stream) {
  if (k <= 32)
    return launch_merge_s<1>(pd, pi, q, m, k, epilog, outd, outi, stream);
  if (k <= 64)
    return launch_merge_s<2>(pd, pi, q, m, k, epilog, outd, outi, stream);
  return launch_merge_s<4>(pd, pi, q, m, k, epilog, outd, outi, stream);
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

__global__ void __launch_bounds__(kMergeWarps * 32)
    merge_ragged_kernel(const float* __restrict__ pd,
                        const int* __restrict__ pi, int k, int epilog,
                        const int* __restrict__ row_off, int off_stride,
                        float* __restrict__ outd, int* __restrict__ outi) {
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
