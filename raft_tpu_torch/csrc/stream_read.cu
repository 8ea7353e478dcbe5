// Streamed column sum: the Hopper port of the JAX package's
// `_stream_kernel` (raft_tpu/ops/fused_topk.py, `stream_read_sum`), the
// probe that every bandwidth-bound kernel's roofline is read against.
// x (n, d) float32 or bfloat16 in, its column sums (1, d) float32 out:
// each element is read once and added once, so the kernel is bound by
// the bytes of x over device memory (3.35 TB/s on the H100 SXM); one add
// per element is far below any compute bound.
//
// The TPU kernel walks row blocks in order and carries the sum in
// scratch across its sequential grid. Here the rows are cut into one
// contiguous range per block (a few blocks per SM), in two passes:
//   1. stream_sum_partial: threads take 16-byte loads on neighbouring
//      column groups of a row (4 float32 or 8 bfloat16 columns a thread,
//      so a warp reads a 512-byte row of 128 float32 columns), rows
//      striding across the block's threads, four loads in flight a
//      thread; each thread sums its column group in registers, then the
//      block adds its threads' sums in a fixed order and writes one
//      partial row: (blocks, d).
//   2. stream_sum_final: the partial rows are added in a fixed order,
//      eight warps a column chunk, then the warps' sums in order.
// Every sum is taken in an order fixed by (n, d, blocks), so the result
// is the same from run to run. A row whose byte width is not a multiple
// of 16 (bfloat16 with d = 100), or a base not 16-byte aligned, takes the
// masked path: one element a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // loads in flight per thread
constexpr int kFinalCols = 32;    // columns per block of the final pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V elements of T at p: one 16-byte load (V * sizeof(T) == 16) or, on
// the masked path (V == 1), one element.
template <typename T, int V>
struct Chunk {
  float v[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 1) {
      v[0] = to_f32(p[0]);
    } else {
      static_assert(V * sizeof(T) == 16, "a vector load is 16 bytes");
      const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) stream_sum_partial(
    const T* __restrict__ x, long long n, int d, long long rows_per_block,
    float* __restrict__ partial) {
  __shared__ float red[kThreads * V];
  const int t = threadIdx.x;
  const int groups = d / V;  // V divides d on the vector path
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (int g0 = 0; g0 < groups; g0 += kThreads) {
    const int gc = min(groups - g0, kThreads);  // column groups this round
    const int R = kThreads / gc;                // rows in flight
    const int rl = t / gc, g = g0 + t % gc;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    if (rl < R) {
      const T* col = x + (size_t)g * V;
      long long r = r0 + rl;
      for (; r + (kUnroll - 1) * R < r1; r += kUnroll * R) {
        Chunk<T, V> c[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          c[u].load(col + (size_t)(r + u * R) * d);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += c[u].v[i];
      }
      for (; r < r1; r += R) {
        Chunk<T, V> c;
        c.load(col + (size_t)r * d);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += c.v[i];
      }
    }
    __syncthreads();  // the previous round's readers are done with red
    if (rl < R) {
#pragma unroll
      for (int i = 0; i < V; ++i) red[(rl * gc + t % gc) * V + i] = acc[i];
    }
    __syncthreads();
    // element e = (group in round, lane of the group): rows-in-flight in
    // order 0..R-1
    for (int e = t; e < gc * V; e += kThreads) {
      float s = 0.f;
      for (int q = 0; q < R; ++q) s += red[q * gc * V + e];
      partial[(size_t)blockIdx.x * d + (size_t)g0 * V + e] = s;
    }
  }
}

// out[c] = sum over b of partial[b][c]: warp w adds rows w, w + 8, ... in
// order, then warp sums are added in order 0..7.
__global__ void __launch_bounds__(kThreads) stream_sum_final(
    const float* __restrict__ partial, int blocks, int d,
    float* __restrict__ out) {
  __shared__ float red[kThreads / 32][kFinalCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kFinalCols + lane;
  float s = 0.f;
  if (c < d)
    for (int b = warp; b < blocks; b += kThreads / 32)
      s += partial[(size_t)b * d + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += red[w][lane];
    out[c] = total;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, long long n, int d, long long rows,
                   int blocks, float* partial, float* out,
                   cudaStream_t stream) {
  stream_sum_partial<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), n, d, rows, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stream_sum_final<<<(d + kFinalCols - 1) / kFinalCols, kThreads, 0,
                     stream>>>(partial, blocks, d, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. x (n, d) contiguous, bf16 != 0 for bfloat16;
// vec != 0 takes the 16-byte path (the caller checks that d * itemsize is
// a multiple of 16 and x is 16-byte aligned); blocks row ranges of `rows`
// rows each (blocks * rows >= n); partial (blocks, d) float32 scratch;
// out (1, d) float32. Returns cudaError_t.
extern "C" int raft_stream_read_sum(const void* x, int bf16, int vec,
                                    long long n, int d, long long rows,
                                    int blocks, void* partial, void* out,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (bf16)
    return (int)(vec ? launch<__nv_bfloat16, 8>(x, n, d, rows, blocks, p, o, s)
                     : launch<__nv_bfloat16, 1>(x, n, d, rows, blocks, p, o,
                                                s));
  return (int)(vec ? launch<float, 4>(x, n, d, rows, blocks, p, o, s)
                   : launch<float, 1>(x, n, d, rows, blocks, p, o, s));
}
