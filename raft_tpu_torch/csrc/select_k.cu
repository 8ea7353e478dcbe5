// Exact k-selection over wide rows: the Hopper port of the JAX package's
// `_select_kernel` (raft_tpu/ops/fused_topk.py, `select_k_tiles`), the
// streamed wide-row route of `matrix.select_k`.
//
// The TPU kernel streams column tiles of all rows through one running
// (b, k) state in VMEM and skips a tile when no value beats the state's
// k-th (`any_better`). Here a row's columns are split into `splits`
// chunks, one warp each, and every warp filters instead of inserting:
//   - wide loads: each lane copies 16-byte vectors (4 float32 or 8
//     bfloat16 / float16 values) of its warp's chunk into the warp's ring
//     of kSelStages stages in shared memory by cp.async, kSelStages - 1
//     stages (6 KB a warp, ~140 KB an SM) in flight while the current one
//     is compared. A chunk's unaligned head and ragged tail (fewer than 8
//     values each; rows start unaligned when n is odd) are read as
//     scalars;
//   - filter first: a stage's values are compared against one float
//     bound and one vote of the warp skips the stage when none passes.
//     Otherwise the filtered warp queue of topk_common.cuh takes them:
//     those at or under the exact (value, column) threshold enter a
//     buffer, and a full buffer is merged into the warp's sorted list by
//     bitonic networks in registers (the first candidates of a list are
//     put in order at once). The threshold is the lower of the warp's own k-th
//     entry and the row's shared bound: the smallest k-th key of any of
//     the row's lists, kept as the complement of an order-preserving
//     64-bit (value, column) key in one word a row in device memory
//     (atomicMax after each merge, read through L2 a stage ahead), so
//     that the row's warps and blocks prune against each other;
//   - the merge fills the card: a block's 8 warps scan one row, and its
//     warp 0 takes the other warps' lists through the same queue; a row
//     split over several blocks writes one partial list a block, and the
//     block that arrives last (an atomic count a row) merges them. One
//     launch in all, after a memset of the bound and count words. Narrow
//     rows (splits == 1) take one warp a row and no merge.
// Values are compared in float32 in min-space (select-max negated), ties
// go to the smaller column, and only finite values enter: a row with
// fewer than k finite values ends in (+inf, -1) slots, the JAX kernel's
// documented caveat.
//
// Bound on the H100: one read of the (b, n) input at HBM rate.
#include <cuda_fp16.h>

#include "topk_common.cuh"

namespace raft_tpu_torch {

constexpr int kSelWarps = 8;    // warps a block
constexpr int kSelStages = 4;   // ring stages a warp
constexpr int kSelVecs = 4;     // 16-byte vectors a lane a stage
constexpr int kSelStageVecs = 32 * kSelVecs;

__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// the 16 / sizeof(T) values of a 16-byte vector, in memory order
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack_words(const uint4& r, float (&x)[8],
                                             __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack_words(const uint4& r, float (&x)[8],
                                             __half) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  unpack_words(r, x, T());
}

struct SelectArgs {
  const void* v;
  int b, n, k, select_max, splits, chunk;
  float* pd;        // (b, splits / kSelWarps, k) block lists (splits > 8)
  int* pi;
  u64* bound;       // (b,) complement of the row's smallest k-th key
  int* arrivals;    // (b,) blocks of the row done
  float* outd;
  int* outi;
};

template <int S>
constexpr size_t select_smem() {
  return (size_t)kSelWarps * kSelStages * kSelStageVecs * 16 +
         (size_t)kSelWarps * 4 * 32 * S * sizeof(float);
}

template <typename T, int S>
__global__ void __launch_bounds__(kSelWarps * 32)
    select_k_kernel(SelectArgs a) {
  constexpr int KP = 32 * S;
  constexpr int VPE = 16 / sizeof(T);  // values a vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) +
                warp * kSelStages * kSelStageVecs;
  float* lists = reinterpret_cast<float*>(
      smem_raw + (size_t)kSelWarps * kSelStages * kSelStageVecs * 16);
  float* ld = lists + warp * 4 * KP;
  int* li = reinterpret_cast<int*>(ld + KP);
  float* bd = ld + 2 * KP;
  int* bi = reinterpret_cast<int*>(ld + 3 * KP);
  queue_init<S>(ld, li);

  const long long unit = (long long)blockIdx.x * kSelWarps + warp;
  const bool live = unit < (long long)a.b * a.splits;
  const int row = live ? (int)(unit / a.splits) : 0;
  const int split = live ? (int)(unit % a.splits) : 0;
  const float sign = a.select_max ? -1.f : 1.f;
  u64* bound = a.splits > 1 ? a.bound + row : nullptr;
  int count = 0;
  u64 thr = kNoBound, published = kNoBound;

  if (live) {
    const T* rowp = reinterpret_cast<const T*>(a.v) + (size_t)row * a.n;
    const int c0 = min(a.n, split * a.chunk);
    const int c1 = min(a.n, c0 + a.chunk);
    const int mis =
        (int)((reinterpret_cast<uintptr_t>(rowp + c0) & 15) / sizeof(T));
    const int head = min(c1 - c0, mis ? VPE - mis : 0);
    const int a0 = c0 + head;
    const int nvec = (c1 - a0) / VPE;
    const int a1 = a0 + nvec * VPE;
    const int tail = c1 - a1;
    {  // the unaligned head and the ragged tail, a value a lane
      const bool in = lane < head + tail;
      const int c = lane < head ? c0 + lane : a1 + (lane - head);
      const float x = in ? sign * to_f32(rowp[c]) : 0.f;
      queue_push<S>(ld, li, bd, bi, count, thr, a.k, x, c,
                    in && fabsf(x) < CUDART_INF_F);
    }
    const uint4* src = reinterpret_cast<const uint4*>(rowp + a0);
    const int nst = (nvec + kSelStageVecs - 1) / kSelStageVecs;
    auto issue = [&](int s) {
      if (s < nst) {
        uint4* dst = ring + (s % kSelStages) * kSelStageVecs;
#pragma unroll
        for (int u = 0; u < kSelVecs; ++u) {
          const int vi = s * kSelStageVecs + u * 32 + lane;
          if (vi < nvec) cp_async16(dst + u * 32 + lane, src + vi, true);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < kSelStages - 1; ++s) issue(s);
    u64 pending = bound ? load_l2(bound) : 0;  // read a stage ahead
    for (int s = 0; s < nst; ++s) {
      issue(s + kSelStages - 1);
      cp_async_wait<kSelStages - 1>();  // this lane's copies of stage s
      if (bound) {
        const u64 g = ~pending;
        if (g < thr) thr = g;
        if (g < published) published = g;
        pending = load_l2(bound);
      }
      const float tf = key_value(thr);
      const uint4* slot = ring + (s % kSelStages) * kSelStageVecs;
      float x[kSelVecs][VPE];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kSelVecs; ++u) {
        const int vi = s * kSelStageVecs + u * 32 + lane;
        if (vi < nvec) {
          if constexpr (VPE == 4)
            unpack(slot[u * 32 + lane], x[u]);
          else
            unpack<T>(slot[u * 32 + lane], x[u]);
#pragma unroll
          for (int e = 0; e < VPE; ++e) {
            x[u][e] *= sign;
            any |= x[u][e] <= tf;
          }
        } else {
#pragma unroll
          for (int e = 0; e < VPE; ++e) x[u][e] = CUDART_NAN_F;
        }
      }
      if (__any_sync(kFull, any)) {
#pragma unroll
        for (int u = 0; u < kSelVecs; ++u)
#pragma unroll
          for (int e = 0; e < VPE; ++e) {
            // only the values some lane passes on the quick compare
            if (!__any_sync(kFull, x[u][e] <= tf)) continue;
            queue_push<S>(ld, li, bd, bi, count, thr, a.k, x[u][e],
                          a0 + (s * kSelStageVecs + u * 32 + lane) * VPE + e,
                          fabsf(x[u][e]) < CUDART_INF_F);
          }
        if (bound && thr < published) {
          if (lane == 0) atomicMax(bound, ~thr);
          published = thr;
        }
      }
    }
    if (count) thr = queue_flush<S>(ld, li, bd, bi, count, a.k, thr);
    count = 0;
  }

  auto write_out = [&]() {
    for (int j = lane; j < a.k; j += 32) {
      const float d = ld[j];
      const int id = li[j];
      a.outd[(size_t)row * a.k + j] = sign * d;
      a.outi[(size_t)row * a.k + j] = id != kEmptyId ? id : -1;
    }
  };
  // takes k entries of a list into warp 0's queue; `cg` reads through L2
  // (another block's list)
  auto take = [&](const float* wd, const int* wi, bool cg) {
    for (int e0 = 0; e0 < a.k; e0 += 32) {
      const int e = e0 + lane;
      const bool in = e < a.k;
      const float x = in ? (cg ? __ldcg(wd + e) : wd[e]) : CUDART_INF_F;
      const int id = in ? (cg ? __ldcg(wi + e) : wi[e]) : kEmptyId;
      queue_push<S>(ld, li, bd, bi, count, thr, a.k, x, id,
                    x < CUDART_INF_F);
    }
  };

  if (a.splits == 1) {  // a warp a row
    if (live) write_out();
    return;
  }
  // splits is a multiple of kSelWarps: the block's warps share one row
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kSelWarps; ++w) {
    const float* wd = lists + w * 4 * KP;
    take(wd, reinterpret_cast<const int*>(wd + KP), false);
  }
  if (count) thr = queue_flush<S>(ld, li, bd, bi, count, a.k, thr);
  count = 0;
  const int G = a.splits / kSelWarps, g = split / kSelWarps;
  if (G == 1) {
    write_out();
    return;
  }
  if (thr < published && lane == 0) atomicMax(bound, ~thr);
  float* pd = a.pd + ((size_t)row * G + g) * a.k;
  int* pi = a.pi + ((size_t)row * G + g) * a.k;
  for (int j = lane; j < a.k; j += 32) {
    pd[j] = ld[j];
    pi[j] = li[j];
  }
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(a.arrivals + row, 1) == G - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();  // the other blocks' lists, fenced before their count
  const u64 fin = ~load_l2(bound);
  if (fin < thr) thr = fin;
  for (int h = 0; h < G; ++h) {
    if (h == g) continue;
    const size_t o = ((size_t)row * G + h) * a.k;
    take(a.pd + o, a.pi + o, true);
  }
  if (count) thr = queue_flush<S>(ld, li, bd, bi, count, a.k, thr);
  write_out();
}

template <typename T, int S>
cudaError_t launch_select(const SelectArgs& a, cudaStream_t stream) {
  const size_t smem = select_smem<S>();
  static bool attr_set = false;  // once a process (one device)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_k_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long units = (long long)a.b * a.splits;
  const int blocks = (int)((units + kSelWarps - 1) / kSelWarps);
  select_k_kernel<T, S><<<blocks, kSelWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_select_t(const SelectArgs& a, cudaStream_t stream) {
  if (a.k <= 32) return launch_select<T, 1>(a, stream);
  if (a.k <= 64) return launch_select<T, 2>(a, stream);
  return launch_select<T, 4>(a, stream);
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. v (b, n) row-major in float32 (dtype 0),
// bfloat16 (1) or float16 (2); columns split into `splits` chunks of
// `chunk` (1, or a multiple of 8: a block's warps then share a row);
// pd/pi (b, splits / 8, k) block lists when splits > 8; scratch 12 bytes
// a row (8-byte aligned: the bound words, then the arrival counts), set
// to 0 here; outd (b, k) float32 values in the caller's direction, outi
// (b, k) int32 columns (-1 where no finite value was left). Returns
// cudaError_t.
extern "C" int raft_select_k(const void* v, int dtype, int b, int n, int k,
                             int select_max, int splits, int chunk, void* pd,
                             void* pi, void* scratch, void* outd, void* outi,
                             void* stream) {
  if (k < 1 || k > 128 || b < 1 || splits < 1 ||
      (splits > 1 && splits % kSelWarps) || (long long)splits * chunk < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  SelectArgs a{v, b, n, k, select_max, splits, chunk, (float*)pd, (int*)pi,
               (u64*)scratch, (int*)((u64*)scratch + b), (float*)outd,
               (int*)outi};
  if (splits > 1) {
    const cudaError_t err =
        cudaMemsetAsync(scratch, 0, (size_t)b * (sizeof(u64) + sizeof(int)),
                        s);
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 1) return (int)launch_select_t<__nv_bfloat16>(a, s);
  if (dtype == 2) return (int)launch_select_t<__half>(a, s);
  return (int)launch_select_t<float>(a, s);
}
