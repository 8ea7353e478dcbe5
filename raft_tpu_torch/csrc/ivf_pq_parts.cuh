// The per-pair instance of the IVF-PQ LUT scan, for tables too large for
// the list-major kernel's block (ivf_pq_scan.cu): a table past shared
// memory beside one pair's queues, e.g. gist-960's pq_dim 240 at 8 bits
// in fp32 (240 KB), or mnist-784's 196 at k > 64. One block for each
// (query, probe slot) builds that pair's table in 2^b parts (b >= 1):
// part c holds the subspaces s = c' + 2^b * i (c' the bit reversal of c),
// which are exactly the groups c * G/2^b .. (c + 1) * G/2^b - 1 of the
// summation order, so each row's binary-counter stack carries from part
// to part in registers and the sum keeps its order; the table is rebuilt
// for each tile of rows (fp8 takes its scale from a sweep of the whole
// table first). Each warp keeps a filtered top-k queue, warp 0 merges the
// others' lists and writes the block's partial list of k, and
// merge_partials_kernel (topk_common.cuh) merges each query's p partial
// lists in (distance, smallest id) order. It equals the plain version
// bit for bit, as the list-major kernel does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include "topk_common.cuh"

namespace raft_tpu_torch {
namespace pq_parts {

// threads a block: 512 for k <= 128 (queues of S <= 4), 256 past it,
// where the queues are wide; both divide by every codebook size
__host__ __device__ constexpr int pq_threads(int s) { return s <= 4 ? 512 : 256; }
constexpr int kTreeLevels = 12;  // groups of eight up to 2^11: W <= 16384

enum LutType { kLutF32 = 0, kLutBf16 = 1, kLutE4m3 = 2, kLutE5m2 = 3 };

struct PqArgs {
  const float* qres;           // L2 (q, p, dim_ext); IP (q, dim_ext)
  const float* base;           // IP (q, p) q.c of each slot's list
  const float* codebooks;      // (pq_dim or n_lists, book, pq_len)
  const float* cb_norms;       // (pq_dim or n_lists, book), L2
  const unsigned char* codes;  // (n_lists, m, row_bytes)
  // a tiered index (ivf_pq_scan.cu): each list's first code row, in its
  // tier's plane (the hot plane or the staging ring), and the launch
  // (list_wave) that scans it; null: `codes`, one launch
  const long long* list_codes;
  const long long* list_wave;
  int wave;                    // the launch: -1 the hot lists, else a wave
  const int* indices;          // (n_lists, m)
  const int* live;             // (n_lists,) rows up to the last live id
  const int* probes;           // (q, p)
  const int* filter;           // words, or null
  long long filter_stride;     // words a query (0: one shared bitset)
  int p, n_lists, m, row_bytes, pq_dim, pq_len, book, k;
  int ip_metric, per_cluster, packed, lut_type;
  // the tree, the table's parts and the tile: G groups of eight, 2^levels
  // = G; 2^pass_bits parts of lut_slots subspaces; row_tile rows
  int groups, levels, pass_bits, lut_slots, row_tile, stride_words;
  float inv_fmax;  // 1 / fmax in float: the fp8 scale is max|lut| * inv_fmax
  float* pd;
  int* pi;
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

inline int pq_slots(int k) {
  int s = 1;
  while (32 * s < k) s *= 2;
  return s;
}

// Shared memory of one block: a table of `slots` subspaces, the rotated
// residual and its subspace norms, a reduction row, a `rows`-row code tile
// (an odd word stride) and a queue a warp.
inline size_t pq_smem_bytes(int slots, int pq_dim, int pq_len, int book,
                            int row_bytes, int k, int rows) {
  const int stride = ((row_bytes + 3) / 4) | 1;
  const int s = pq_slots(k);
  const size_t floats = (size_t)align4(slots * book) +
                        align4(pq_dim * pq_len) + align4(pq_dim) + 32 +
                        align4(rows * stride);
  return 4 * floats + (size_t)(pq_threads(s) / 32) * 4 * 32 * s * 4;
}

__device__ __forceinline__ float round_lut(float v, int lut_type,
                                           float scale) {
  if (lut_type == kLutBf16) return __bfloat162float(__float2bfloat16_rn(v));
  if (lut_type == kLutE4m3)
    return float(__nv_fp8_e4m3(__fdiv_rn(v, scale)));
  if (lut_type == kLutE5m2)
    return float(__nv_fp8_e5m2(__fdiv_rn(v, scale)));
  return v;
}

__device__ __forceinline__ int code_at(const unsigned char* row, int s,
                                       int packed) {
  if (packed) return (row[s >> 1] >> ((s & 1) << 2)) & 0x0F;
  return row[s];
}

// One table entry: L2 (|q~_s|^2 - 2 q~_s.cb_sj) + |cb_sj|^2, IP q~_s.cb_sj,
// every sum in ascending l, each product and add rounded.
__device__ __forceinline__ float lut_entry(const PqArgs& a, const float* qs,
                                           const float* qn, int lid, int s,
                                           int j) {
  const size_t b = (size_t)(a.per_cluster ? lid : s) * a.book + j;
  const float* cb = a.codebooks + b * a.pq_len;
  const float* x = qs + s * a.pq_len;
  float dot = __fmul_rn(x[0], __ldg(cb));
  for (int l = 1; l < a.pq_len; ++l)
    dot = __fadd_rn(dot, __fmul_rn(x[l], __ldg(cb + l)));
  return a.ip_metric ? dot
                     : __fadd_rn(__fsub_rn(qn[s], __fmul_rn(2.f, dot)),
                                 __ldg(a.cb_norms + b));
}

// Part c of the table: the subspaces s = c + 2^b * i at lut[i * J + j],
// rounded to the LUT type unless `raw`; with b = 0 the whole table (lut
// null: a sweep of the whole table that stores nothing). J (a power of
// two <= 256) divides the block, so a thread keeps its codeword j and
// steps over subspaces. Returns the thread's max |entry|.
template <int kThreads>
__device__ float build_lut(float* lut, const PqArgs& a, const float* qs,
                           const float* qn, int lid, int c, int b, bool raw,
                           float scale) {
  const int tid = threadIdx.x, J = a.book, j = tid & (J - 1);
  const int step = (kThreads / J) << b;
  float mx = 0.f;
#pragma unroll 4
  for (int s = c + ((tid / J) << b); s < a.pq_dim; s += step) {
    const float v = lut_entry(a, qs, qn, lid, s, j);
    if (lut) lut[(s >> b) * J + j] = raw ? v : round_lut(v, a.lut_type, scale);
    mx = fmaxf(mx, fabsf(v));
  }
  return mx;
}

// The fp8 scale max|lut| * (1 / fmax) (at least 1e-30) from each thread's max.
template <int kThreads>
__device__ float block_scale(float mx, float* red, const PqArgs& a) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    red[kWarps] = fmaxf(__fmul_rn(m, a.inv_fmax), 1e-30f);
  }
  __syncthreads();
  return red[kWarps];
}

// Groups [g0, g1) of sum_s lut[s, code_s] for one staged row, in
// tree_sum's halving order: each group of eight subspaces
// s0 + brev3(u) * G (s0 the bit-reversed group index) summed as a tree,
// the groups combined by a binary-counter stack `st`; after the last
// group `total` is the whole sum. kParts: the table holds one part,
// subspace s at slot s >> pass_bits.
template <bool kParts>
__device__ __forceinline__ void score_groups(const float* lut,
                                             const unsigned char* row,
                                             const PqArgs& a, int g0, int g1,
                                             float (&st)[kTreeLevels],
                                             float& total) {
  constexpr int kBrev3[8] = {0, 4, 2, 6, 1, 5, 3, 7};
  for (int g = g0; g < g1; ++g) {
    const int s0 = a.levels ? (int)(__brev((unsigned)g) >> (32 - a.levels))
                            : 0;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = s0 + kBrev3[u] * a.groups;
      const int slot = kParts ? s >> a.pass_bits : s;
      v[u] = s < a.pq_dim ? lut[slot * a.book + code_at(row, s, a.packed)]
                          : 0.f;
    }
    float gs = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]),
                                   __fadd_rn(v[2], v[3])),
                         __fadd_rn(__fadd_rn(v[4], v[5]),
                                   __fadd_rn(v[6], v[7])));
    int t = g;
    bool carry = true;
#pragma unroll
    for (int l = 0; l < kTreeLevels; ++l) {
      if (carry) {
        if (t & 1) {
          gs = __fadd_rn(st[l], gs);
          t >>= 1;
        } else {
          st[l] = gs;
          carry = false;
        }
      }
    }
    total = gs;
  }
}

// kParts: the table is built in parts (a.pass_bits > 0). A kernel of its
// own, so the one-part kernel keeps its registers (two blocks an SM).
template <int S, bool kParts>
__global__ void __launch_bounds__(pq_threads(S))
    pq_scan_kernel(const PqArgs a) {
  constexpr int KP = 32 * S;
  constexpr int kPqThreads = pq_threads(S);
  constexpr int kPqWarps = kPqThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slot = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t pair = (size_t)row * a.p + slot;
  const size_t part = pair * a.k;
  const int lid = a.probes[pair];
  if (lid < 0 || lid >= a.n_lists) {  // sentinel slot: an empty partial
    if (a.list_wave && a.wave != -1) return;  // the hot launch writes it
    for (int j = tid; j < a.k; j += kPqThreads) {
      a.pd[part + j] = CUDART_INF_F;
      a.pi[part + j] = kEmptyId;
    }
    return;
  }
  // a tiered launch scans only its own lists' pairs
  if (a.list_wave && a.list_wave[lid] != a.wave) return;
  const int L = a.pq_len, J = a.book;
  const int dim_ext = a.pq_dim * L;
  float* lut = reinterpret_cast<float*>(smem_raw);
  float* qs = lut + align4(a.lut_slots * J);
  float* qn = qs + align4(dim_ext);
  float* red = qn + align4(a.pq_dim);
  unsigned* tile = reinterpret_cast<unsigned*>(red + 32);
  float* queues =
      reinterpret_cast<float*>(tile + align4(a.row_tile * a.stride_words));

  const float* src = a.ip_metric ? a.qres + (size_t)row * dim_ext
                                 : a.qres + pair * dim_ext;
  for (int i = tid; i < dim_ext; i += kPqThreads) qs[i] = src[i];
  __syncthreads();
  if (!a.ip_metric)
    for (int s = tid; s < a.pq_dim; s += kPqThreads) {
      const float* x = qs + s * L;
      float acc = __fmul_rn(x[0], x[0]);
      for (int l = 1; l < L; ++l) acc = __fadd_rn(acc, __fmul_rn(x[l], x[l]));
      qn[s] = acc;
    }
  __syncthreads();

  // the pair's lookup table: whole, built once; or in parts, rebuilt for
  // each tile of rows (fp8 sweeps the whole table for its scale first)
  const bool fp8 = a.lut_type >= kLutE4m3;
  float scale = 1.f;
  if (!kParts) {
    const float mx =
        build_lut<kPqThreads>(lut, a, qs, qn, lid, 0, 0, fp8, 1.f);
    if (fp8) {
      scale = block_scale<kPqThreads>(mx, red, a);
      for (int e = tid; e < a.pq_dim * J; e += kPqThreads)
        lut[e] = round_lut(lut[e], a.lut_type, scale);
    }
  } else if (fp8) {
    scale = block_scale<kPqThreads>(
        build_lut<kPqThreads>(nullptr, a, qs, qn, lid, 0, 0, true, 1.f),
        red, a);
  }
  const int passes = 1 << a.pass_bits, part_groups = a.groups >> a.pass_bits;

  // stream the list's rows through the tile
  float* ld = queues + warp * 4 * KP;
  int* li = reinterpret_cast<int*>(ld + KP);
  float* bd = ld + 2 * KP;
  int* bi = reinterpret_cast<int*>(ld + 3 * KP);
  queue_init<S>(ld, li);
  int count = 0;
  u64 thr = kNoBound;
  const float base = a.ip_metric ? a.base[pair] : 0.f;
  const int n_rows = a.live[lid];
  const unsigned char* lcodes =
      a.list_codes
          ? reinterpret_cast<const unsigned char*>(a.list_codes[lid])
          : a.codes + (size_t)lid * a.m * a.row_bytes;
  const int* lids = a.indices + (size_t)lid * a.m;
  const int* fw = a.filter ? a.filter + (size_t)row * a.filter_stride
                           : nullptr;
  const int sb = a.stride_words * 4;  // tile row stride in bytes
  unsigned char* tb = reinterpret_cast<unsigned char*>(tile);
  const bool words = (a.row_bytes & 3) == 0;
  const int rw = a.row_bytes >> 2;
  const bool quads = (a.row_bytes & 15) == 0 && kPqThreads % (rw >> 2) == 0 &&
                     ((uintptr_t)lcodes & 15) == 0;
  for (int r0 = 0; r0 < n_rows; r0 += a.row_tile) {
    const int nt = min(a.row_tile, n_rows - r0);
    __syncthreads();  // the LUT is written; the last tile is consumed
    if (quads) {  // 16-byte loads; rw / 4 divides the block
      const uint4* g =
          reinterpret_cast<const uint4*>(lcodes + (size_t)r0 * a.row_bytes);
      const int c = tid % (rw >> 2), step = kPqThreads / (rw >> 2);
      for (int r = tid / (rw >> 2); r < nt; r += step) {
        const uint4 v = __ldg(g + (size_t)r * (rw >> 2) + c);
        unsigned* t = tile + r * a.stride_words + 4 * c;
        t[0] = v.x;
        t[1] = v.y;
        t[2] = v.z;
        t[3] = v.w;
      }
    } else if (words) {
      const unsigned* g =
          reinterpret_cast<const unsigned*>(lcodes + (size_t)r0 * a.row_bytes);
      for (int w = tid; w < nt * rw; w += kPqThreads) {
        const int r = w / rw;
        tile[r * a.stride_words + (w - r * rw)] = g[w];
      }
    } else {
      const unsigned char* g = lcodes + (size_t)r0 * a.row_bytes;
      for (int c = tid; c < nt * a.row_bytes; c += kPqThreads) {
        const int r = c / a.row_bytes;
        tb[r * sb + (c - r * a.row_bytes)] = g[c];
      }
    }
    float total = 0.f;
    if (!kParts) {
      __syncthreads();
      if (tid < nt) {
        float st[kTreeLevels];
        score_groups<false>(lut, tb + tid * sb, a, 0, a.groups, st, total);
      }
    } else {
      float st[kTreeLevels];
      for (int c = 0; c < passes; ++c) {
        if (c) __syncthreads();  // the last part is consumed
        build_lut<kPqThreads>(
            lut, a, qs, qn, lid,
            (int)(__brev((unsigned)c) >> (32 - a.pass_bits)), a.pass_bits,
            false, scale);
        __syncthreads();  // the tile and the part are staged
        if (tid < nt)
          score_groups<true>(lut, tb + tid * sb, a, c * part_groups,
                             (c + 1) * part_groups, st, total);
      }
    }
    if (warp * 32 < nt) {  // warp-uniform: the warp has rows in this tile
      const bool have = tid < nt;
      float d = CUDART_INF_F;
      int id = kEmptyId;
      bool want = false;
      if (have) {
        id = lids[r0 + tid];
        d = total;
        if (fp8)  // IP: one rounding, as XLA contracts it
          d = a.ip_metric ? -__fmaf_rn(d, scale, base) : __fmul_rn(d, scale);
        else if (a.ip_metric)
          d = -__fadd_rn(d, base);
        bool ok = id >= 0;
        if (ok && fw) ok = (fw[id >> 5] >> (id & 31)) & 1;
        want = ok && d < CUDART_INF_F;
      }
      queue_push<S>(ld, li, bd, bi, count, thr, a.k, d, id, want);
    }
  }
  if (count) thr = queue_flush<S>(ld, li, bd, bi, count, a.k, thr);
  __syncthreads();
  if (warp != 0) return;
  count = 0;
  for (int w = 1; w < kPqWarps; ++w) {
    const float* od = queues + w * 4 * KP;
    const int* oi = reinterpret_cast<const int*>(od + KP);
    for (int c0 = 0; c0 < a.k; c0 += 32) {
      const int c = c0 + lane;
      const bool in = c < a.k;
      const float v = in ? od[c] : CUDART_INF_F;
      const int id = in ? oi[c] : kEmptyId;
      queue_push<S>(ld, li, bd, bi, count, thr, a.k, v, id,
                    in && v < CUDART_INF_F);
    }
  }
  if (count) thr = queue_flush<S>(ld, li, bd, bi, count, a.k, thr);
  for (int j = lane; j < a.k; j += 32) {
    a.pd[part + j] = ld[j];
    a.pi[part + j] = li[j];
  }
}

template <int S>
cudaError_t launch_pq_s(const PqArgs& a, int q, size_t smem,
                        cudaStream_t stream) {
  void (*kernel)(const PqArgs) = pq_scan_kernel<S, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.p, q), pq_threads(S), smem, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch_pq(const PqArgs& a, int q, size_t smem,
                      cudaStream_t stream) {
  if (a.k <= 32) return launch_pq_s<1>(a, q, smem, stream);
  if (a.k <= 64) return launch_pq_s<2>(a, q, smem, stream);
  if (a.k <= 128) return launch_pq_s<4>(a, q, smem, stream);
  if (a.k <= 256) return launch_pq_s<8>(a, q, smem, stream);
  return launch_pq_s<16>(a, q, smem, stream);
}

inline cudaError_t launch_pq_merge(const float* pd, const int* pi, int q, int m,
                            int k, int epilog, float* outd, int* outi,
                            cudaStream_t stream) {
  if (k <= 128) return launch_merge(pd, pi, q, m, k, epilog, outd, outi, stream);
  if (k <= 256)
    return launch_merge_s<8>(pd, pi, q, m, k, epilog, outd, outi, stream);
  return launch_merge_s<16>(pd, pi, q, m, k, epilog, outd, outi, stream);
}

}  // namespace pq_parts
}  // namespace raft_tpu_torch


namespace raft_tpu_torch {
namespace pq_parts {

// Shared bytes of the smallest number of parts (2^b, b >= 1) and widest
// row tile that fit `limit`, with the plan in `a`; 0 when none fits.
inline size_t plan(PqArgs& a, int pq_dim, int pq_len, int book,
                   int row_bytes, int k, int limit) {
  int width = 8;
  while (width < pq_dim) width *= 2;
  a.groups = width / 8;
  a.levels = 0;
  while ((1 << a.levels) < a.groups) ++a.levels;
  if (a.levels >= kTreeLevels) return 0;
  a.stride_words = ((row_bytes + 3) / 4) | 1;
  for (a.pass_bits = 1; a.pass_bits <= a.levels; ++a.pass_bits) {
    a.lut_slots = (pq_dim + (1 << a.pass_bits) - 1) >> a.pass_bits;
    for (a.row_tile = pq_threads(pq_slots(k));; a.row_tile /= 2) {
      const size_t smem = pq_smem_bytes(a.lut_slots, pq_dim, pq_len, book,
                                        row_bytes, k, a.row_tile);
      if (smem <= (size_t)limit) return smem;
      if (a.row_tile == 32) break;
    }
  }
  return 0;
}

}  // namespace pq_parts
}  // namespace raft_tpu_torch
