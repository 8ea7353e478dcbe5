// IVF-PQ list scan with shared-memory lookup tables, list-major: the
// port's kernel for the JAX package's list-major PQ engine
// (raft_tpu/neighbors/ivf_pq.py:876, `_search_impl_fn` with scan_engine
// "xla"), which is XLA there: there is no Pallas PQ kernel, so this
// replaces no TPU kernel. Its plain version is `_scan_torch` in
// raft_tpu_torch/ops/ivf_pq_scan.py, which it equals bit for bit.
//
// Bound on the H100: the lookups. A (query, probe slot) pair scores each
// live row of its list as sum_s lut[s, code_s], one shared-memory load a
// subspace: 1.0e10 loads at (n_probes 128, batch 500), 1.2 ms at 32 a
// clock an SM; the codes (64 MB of distinct rows there) are 0.03 ms of
// device memory. The earlier design (one block a pair) lost 14x to four
// costs; this one answers each:
//   1. a table a pair, built from codebook rows read one entry at a time
//      through L2 (12 GB): here the rows a table is built from are staged
//      into shared memory by cp.async, a few subspaces at a time, all
//      copies of a stage in flight at once, and each one serves every
//      pair of the work item;
//   2. every pair restaged its whole list through shared memory (10 GB):
//      here pq_plan_kernel lays out work items on the device, as the
//      IVF-Flat scan's `_scan_items` does (its plain twin is
//      ops/ivf_pq_scan `_pq_items`): (probed list, chunk of `rows` live
//      rows, group of `group` of the (query, probe slot) pairs that probe
//      it). The item's tables stay in shared memory while it streams its
//      chunk in tiles of 512 (row, pair) combinations, so each row is
//      read once an item for all its pairs; a long list spreads over
//      many blocks;
//   3. two shared loads a lookup (the code byte and the entry), with
//      ~3.5-way bank conflicts: here a thread holds its row's codes in
//      registers (pq_dim 64: 64 or 32 bytes, four or two 16-byte loads;
//      other widths read each summation group's eight codes), so a lookup
//      is one shared load, and the item's tables are interleaved (entry
//      (g, s, j) at (s * J + j) * GP + g, GP the item's pairs rounded up
//      to a power of two), the lanes of a warp 32 / GP rows x GP pairs,
//      so the pairs of one row read different banks;
//   4. per-block queues merged at the end, two blocks an SM: here one
//      block of 512 threads fills its SM, the tables are held in the LUT
//      type (bf16 2 bytes, e4m3/e5m2 1 byte an entry), so a group holds
//      as many pairs as the tables' bytes allow (the plan: 2 pairs of
//      64 KB fp32 tables at the sift shape, 16 of 4-bit ones), and every
//      warp keeps a filtered queue (topk_common.cuh) for one pair over
//      the chunk, fed 32 rows a tile, merged into the pair's partial list
//      at the end of the item.
//
// The sum keeps the plain version's order: each entry's sum_l in
// ascending l with __f*_rn; the fp8 scale max|lut| * (1 / fmax) over the
// pair's whole table (a sweep before the build; the float reciprocal, as
// XLA folds the JAX package's division by the constant), each entry
// divided by it with __fdiv_rn; sum_s in tree_sum's halving order:
// groups of eight subspaces s0 + brev3(u) * groups (s0 the bit-reversed
// group index), each summed as ((0+1)+(2+3))+((4+5)+(6+7)), the groups
// combined by a binary-counter stack; min-space (IP negated after adding
// q.c). Ids < 0 and filtered ids match nothing; sentinel probe slots (id
// n_lists) form no pair and get no partial.
//
// Each item writes one partial top-k for each of its pairs and its
// chunk, at slot_off[query * p + slot] + chunk; merge_partials_kernel
// then merges each query's ragged run of partials in (distance, smallest
// id) order, and negates IP back.
//
// A tiered index (neighbors/tiered.TieredIvfPq: the codes plane split into
// a hot plane on the card and a cold plane in pinned host memory) takes
// the design of tier_scan.cu (#6): raft_ivf_pq_scan_tiered copies each
// probed cold list's live rows, rounded up to 64, once per request into a
// device ring (cudaMemcpyAsync on a copy stream, an event a wave; the plan
// is ops/tier_scan.tier_stage_plan), and each block takes its list's code
// rows from a per-list table (the hot slot's row or the ring offset's) in
// place of codes + lid * m * row_bytes; no kernel reads host memory. The
// hot lists launch first, then each wave of cold lists after its copies
// (waves take turns in the ring's halves when it cannot hold them all),
// the per-pair instance the same way, and the one merge after the last.
// Same items, partials and merge: the results equal the all-device
// kernel's by construction. The extra bound is the staged bytes over the
// host link (64 GB/s a direction on PCIe Gen5 x16).
#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include <vector>

#include "ivf_pq_parts.cuh"
#include "topk_common.cuh"

namespace raft_tpu_torch {

constexpr int kPqThreads = 512;  // threads a block, one block an SM
constexpr int kPqWarps = kPqThreads / 32;
constexpr int kMaxG = 16;        // probing pairs a work item
constexpr int kChunk = 2048;     // list rows a work item ...
constexpr int kChunkWide = 4096; // ... at kWidePairs (query, probe) pairs
constexpr int kWidePairs = 4096; // or more: a table a pair, mostly
constexpr int kTreeLevels = 12;  // groups of eight up to 2^11: W <= 16384

enum LutType { kLutF32 = 0, kLutBf16 = 1, kLutE4m3 = 2, kLutE5m2 = 3 };
// how a thread reads its row's codes: by summation group (any width), or
// the whole row into registers at pq_dim 64 (8-bit or 4-bit codes)
enum CodeMode { kCodesAny = 0, kCodesW64 = 1, kCodesW64Packed = 2 };

__host__ __device__ inline int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

inline int tree_width(int pq_dim) {
  int w = 8;
  while (w < pq_dim) w *= 2;
  return w;
}

inline int pq_slots(int k) {
  int s = 1;
  while (32 * s < k) s *= 2;
  return s;
}

inline int lut_entry_bytes(int lut_type) {
  return lut_type == kLutF32 ? 4 : lut_type == kLutBf16 ? 2 : 1;
}

inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared memory of one block, region by region (byte offsets): the item's
// tables (group x pq_dim x book entries), the codebook rows of a build
// stage (`stage` subspaces of book x (pq_len + 1) floats: rows, then
// norms), two tiles' distances ([pair][row], odd stride) and ids, a
// filtered queue a warp and its state, the pairs' residuals and subspace
// norms (odd strides), and per-pair words.
struct PqLayout {
  size_t cb, d, ids, queues, qstate, qs, qn, meta, total;
  int qs_stride, qn_stride, stage;
};

inline PqLayout pq_layout(int pq_dim, int pq_len, int book, int k,
                          int lut_type, int group, int stage) {
  const int dim_ext = pq_dim * pq_len;
  PqLayout l;
  l.qs_stride = dim_ext | 1;
  l.qn_stride = pq_dim | 1;
  l.stage = stage;
  size_t o = align16((size_t)group * pq_dim * book *
                     lut_entry_bytes(lut_type));
  l.cb = o;
  o += align16((size_t)stage * book * (pq_len + 1) * 4);
  l.d = o;
  o += align16((size_t)2 * (kPqThreads + kMaxG) * 4);
  l.ids = o;
  o += align16((size_t)2 * kPqThreads * 4);
  l.queues = o;
  o += align16((size_t)kPqWarps * 16 * 32 * pq_slots(k));
  l.qstate = o;
  o += align16((size_t)kPqWarps * 16);
  l.qs = o;
  o += align16((size_t)group * l.qs_stride * 4);
  l.qn = o;
  o += align16((size_t)group * l.qn_stride * 4);
  l.meta = o;
  o += align16((size_t)(4 * kMaxG + kPqWarps * kMaxG) * 4);
  l.total = o;
  return l;
}

struct PqPlan {
  int rows, group, stage;
  size_t smem;
};

// The work-item shape: chunks of kChunk rows (kChunkWide for a search of
// kWidePairs pairs or more, where the tables a chunk rebuilds cost more
// than the blocks it spreads over), and the most pairs (a power of two up
// to 16) whose tables fit `limit` bytes of shared memory beside the rest,
// with the codebook rows of as many subspaces a build stage as fit too
// (at most pq_dim). False when not one pair fits.
inline bool pq_plan(int pq_dim, int pq_len, int book, int k, int lut_type,
                    long long pairs, size_t limit, PqPlan* out) {
  const int rows = pairs >= kWidePairs ? kChunkWide : kChunk;
  for (int group = kMaxG; group >= 1; group /= 2) {
    const PqLayout l0 = pq_layout(pq_dim, pq_len, book, k, lut_type, group, 0);
    const size_t per = (size_t)book * (pq_len + 1) * 4;
    if (l0.total + per > limit) continue;
    int stage = (int)((limit - l0.total) / per);
    if (stage > pq_dim) stage = pq_dim;
    while (pq_layout(pq_dim, pq_len, book, k, lut_type, group, stage).total >
           limit)
      --stage;
    if (stage < 1) continue;
    *out = PqPlan{rows, group, stage,
                  pq_layout(pq_dim, pq_len, book, k, lut_type, group, stage)
                      .total};
    return true;
  }
  return false;
}

struct PqArgs {
  const float* qres;           // L2 (q, p, dim_ext); IP (q, dim_ext)
  const float* base;           // IP (q, p) q.c of each slot's list
  const float* codebooks;      // (pq_dim or n_lists, book, pq_len)
  const float* cb_norms;       // (pq_dim or n_lists, book), L2
  const unsigned char* codes;  // (n_lists, m, row_bytes)
  // a tiered index: each list's first code row in its tier's plane (the
  // hot plane or the staging ring) and the launch that scans it
  // (list_wave, -1 the hot lists); null: `codes`, one launch
  const long long* list_codes;
  const long long* list_wave;
  int wave;                    // this launch's wave (-1: the hot lists)
  const int* indices;          // (n_lists, m)
  const int* filter;           // words, or null
  long long filter_stride;     // words a query (0: one shared bitset)
  const int* offs;             // (n_lists + 1,) CSR over the list-sorted pairs
  const int* pair_q;           // query row of each pair
  const int* pair_slot;        // probe slot of each pair
  const int* live;             // (n_lists,) rows up to each list's last live id
  const long long* item_off;   // (n_lists + 1,) first item of each list
  const int* slot_off;         // (q * p + 1,) first partial of each pair
  int n_lists, p, m, row_bytes, pq_dim, pq_len, book, k, dim_ext;
  int ip_metric, per_cluster, packed, lut_type;
  int cb_vec4, nrm_vec4, codes_mode;
  int groups, levels, rows, group, lg_book, S;
  PqLayout lay;
  float inv_fmax;  // 1 / fmax in float: the fp8 scale is max|lut| * inv_fmax
  float* pd;
  int* pi;
};

__device__ __forceinline__ int brev_bits(int v, int bits) {
  return bits ? (int)(__brev((unsigned)v) >> (32 - bits)) : 0;
}

__device__ __forceinline__ float lut_get(const float* t, int i) {
  return t[i];
}
__device__ __forceinline__ float lut_get(const __nv_bfloat16* t, int i) {
  return __bfloat162float(t[i]);
}
__device__ __forceinline__ float lut_get(const __nv_fp8_e4m3* t, int i) {
  return float(t[i]);
}
__device__ __forceinline__ float lut_get(const __nv_fp8_e5m2* t, int i) {
  return float(t[i]);
}

// an entry in the LUT type: bf16 rounded, fp8 divided by the pair's scale
template <typename T>
__device__ __forceinline__ T lut_put(float v, float scale);
template <>
__device__ __forceinline__ float lut_put<float>(float v, float) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 lut_put<__nv_bfloat16>(float v,
                                                                float) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __nv_fp8_e4m3 lut_put<__nv_fp8_e4m3>(float v,
                                                               float scale) {
  return __nv_fp8_e4m3(__fdiv_rn(v, scale));
}
template <>
__device__ __forceinline__ __nv_fp8_e5m2 lut_put<__nv_fp8_e5m2>(float v,
                                                               float scale) {
  return __nv_fp8_e5m2(__fdiv_rn(v, scale));
}

// Stages, by cp.async (every copy in flight at once), the codebook rows
// (then their L2 norms) of subspaces [s0, s0 + n), or, per-cluster, the
// list's own rows (n = 1). Waits for the copies; the caller's barrier
// publishes them.
__device__ void stage_rows(float* cbs, const PqArgs& a, int lid, int s0,
                           int n) {
  const int tid = threadIdx.x, J = a.book, JL = J * a.pq_len;
  const int v = a.cb_vec4 ? 4 : 1, pieces = JL / v;
  for (int e = tid; e < n * pieces; e += kPqThreads) {
    const int il = e / pieces, o = (e - il * pieces) * v;
    const float* src =
        a.codebooks + (size_t)(a.per_cluster ? lid : s0 + il) * JL + o;
    if (v == 4)
      cp_async16(cbs + il * JL + o, src, true);
    else
      cp_async4(cbs + il * JL + o, src, true);
  }
  if (!a.ip_metric) {
    float* cbn = cbs + n * JL;
    const int w = a.nrm_vec4 ? 4 : 1, npc = J / w;
    for (int e = tid; e < n * npc; e += kPqThreads) {
      const int il = e / npc, o = (e - il * npc) * w;
      const float* src =
          a.cb_norms + (size_t)(a.per_cluster ? lid : s0 + il) * J + o;
      if (w == 4)
        cp_async16(cbn + il * J + o, src, true);
      else
        cp_async4(cbn + il * J + o, src, true);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Table rows of subspaces [s0, s0 + n) for the item's pairs g < cnt, from
// the staged codebook rows: entry (g, s, j) at (s * J + j) * GP + g in
// the LUT type. An entry is L2 (|q~_s|^2 - 2 q~_s.cb) + |cb|^2 or IP
// q~_s.cb, every sum in ascending l, each product and add rounded. A
// thread keeps one pair (tid % GP) and, for each of its subspaces, up to
// eight codewords j0, j0 + 32, ...: its residual row and subspace norm
// are read once for them, their codebook rows all loaded first. With
// `sweep` nothing is stored: the thread's max |entry| (fp8's scale) is
// returned.
template <typename T>
__device__ float build_rows(T* __restrict__ tab, const PqArgs& a,
                            const float* __restrict__ cbs,
                            const float* __restrict__ qs,
                            const float* __restrict__ qn,
                            const float* __restrict__ scale, int cnt,
                            int lg_gp, int s0, int n, bool sweep) {
  const int tid = threadIdx.x, g = tid & ((1 << lg_gp) - 1);
  const int jl = tid >> lg_gp, J = a.book, L = a.pq_len;
  const int lanes = kPqThreads >> lg_gp;  // threads of one pair
  const int nj = min(min(lanes, J), 32), ni = lanes / nj;
  const int j0 = jl & (nj - 1);
  const float* __restrict__ cbn = cbs + (a.per_cluster ? 1 : n) * J * L;
  float mx = 0.f;
  if (g >= cnt) return mx;
  const float* __restrict__ xg = qs + g * a.lay.qs_stride;
  const float sc = sweep ? 1.f : scale[g];
  for (int il = jl / nj; il < n; il += ni) {
    const int s = s0 + il, ic = a.per_cluster ? 0 : il;
    const float* __restrict__ x = xg + s * L;
    const float q2 = a.ip_metric ? 0.f : qn[g * a.lay.qn_stride + s];
    const float* __restrict__ crow = cbs + ic * J * L;
    const float* __restrict__ nrow = cbn + ic * J;
    T* __restrict__ out = tab + ((s * J) << lg_gp) + g;
    if (L == 2) {
      const float x0 = x[0], x1 = x[1];
      const int nk = J / nj;
      float2 c[8];
      float nv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < nk) {
          c[k] = reinterpret_cast<const float2*>(crow)[j0 + k * nj];
          nv[k] = a.ip_metric ? 0.f : nrow[j0 + k * nj];
        }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < nk) {
          const float dot =
              __fadd_rn(__fmul_rn(x0, c[k].x), __fmul_rn(x1, c[k].y));
          const float v =
              a.ip_metric ? dot
                          : __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)),
                                      nv[k]);
          if (sweep)
            mx = fmaxf(mx, fabsf(v));
          else
            out[(j0 + k * nj) << lg_gp] = lut_put<T>(v, sc);
        }
    } else {
#pragma unroll 4
      for (int j = j0; j < J; j += nj) {
        const float* __restrict__ cb = crow + j * L;
        float dot = __fmul_rn(x[0], cb[0]);
        for (int l = 1; l < L; ++l)
          dot = __fadd_rn(dot, __fmul_rn(x[l], cb[l]));
        const float v = a.ip_metric
                            ? dot
                            : __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)),
                                        nrow[j]);
        if (sweep)
          mx = fmaxf(mx, fabsf(v));
        else
          out[j << lg_gp] = lut_put<T>(v, sc);
      }
    }
  }
  return mx;
}

// The item's whole tables (with `sweep`, only each thread's max |entry|),
// in stages of the planned number of subspaces: stage their codebook
// rows, barrier, build. Per-cluster rows were staged once for the item.
template <typename T>
__device__ float build_tables(T* tab, float* cbs, const PqArgs& a,
                              const float* qs, const float* qn,
                              const float* scale, int lid, int cnt,
                              int lg_gp, bool sweep) {
  const int stage = a.per_cluster ? a.pq_dim : a.lay.stage;
  float mx = 0.f;
  for (int s0 = 0; s0 < a.pq_dim; s0 += stage) {
    const int n = min(stage, a.pq_dim - s0);
    if (!a.per_cluster) {
      if (s0) __syncthreads();  // the last stage is built
      stage_rows(cbs, a, lid, s0, n);
      __syncthreads();
    }
    mx = fmaxf(mx, build_rows<T>(tab, a, cbs, qs, qn, scale, cnt, lg_gp, s0,
                                 n, sweep));
  }
  return mx;
}

// Group gg of a chunk row, staged: the codes of its subspaces
// s = brev(gg) + brev3(u) * groups (u = 0..7, the scoring order) in one
// 8-byte word, nibbles unpacked, 0 past pq_dim.
__device__ __forceinline__ uint2 gather_group(const unsigned char* src,
                                              const PqArgs& a, int gg) {
  constexpr int kBrev3[8] = {0, 4, 2, 6, 1, 5, 3, 7};
  const int s0 = brev_bits(gg, a.levels);
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int s = s0 + kBrev3[u] * a.groups;
    unsigned code = 0;
    if (s < a.pq_dim)
      code = a.packed ? (__ldg(src + (s >> 1)) >> ((s & 1) << 2)) & 0x0Fu
                      : __ldg(src + s);
    w[u >> 2] |= code << ((u & 3) * 8);
  }
  return make_uint2(w[0], w[1]);
}


// One row's sum for pair g, its codes read by summation group (eight
// codes a group, from the row in device memory): each group's tree, the
// groups combined by a binary-counter stack.
template <typename T>
__device__ __forceinline__ float score_row_any(const T* tab,
                                               const unsigned char* src,
                                               const PqArgs& a, int lg_gp,
                                               int g) {
  constexpr int kBrev3[8] = {0, 4, 2, 6, 1, 5, 3, 7};
  float st[kTreeLevels];
  float gs = 0.f;
  for (int gg = 0; gg < a.groups; ++gg) {
    const int s0 = brev_bits(gg, a.levels);
    const uint2 cw = gather_group(src, a, gg);
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = s0 + kBrev3[u] * a.groups;
      const int code = ((u < 4 ? cw.x : cw.y) >> ((u & 3) * 8)) & 0xFF;
      v[u] = s < a.pq_dim
                 ? lut_get(tab, (((s << a.lg_book) + code) << lg_gp) + g)
                 : 0.f;
    }
    gs = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
    const int pops = __ffs(~gg) - 1;  // trailing ones of gg
#pragma unroll
    for (int l = 0; l < kTreeLevels; ++l)
      if (l < pops) gs = __fadd_rn(st[l], gs);
#pragma unroll
    for (int l = 0; l < kTreeLevels; ++l)
      if (l == pops) st[l] = gs;
  }
  return gs;
}

// One row's sum for pair g at pq_dim 64 (eight groups, W = 64), the row's
// codes in registers: 64 bytes, or 32 of two 4-bit codes each.
template <typename T, bool kPacked>
__device__ __forceinline__ float score_row_w64(const T* tab,
                                               const unsigned char* src,
                                               int lg_book, int lg_gp,
                                               int g) {
  constexpr int kBrev3[8] = {0, 4, 2, 6, 1, 5, 3, 7};
  constexpr int kWords = kPacked ? 8 : 16;
  unsigned w[kWords];
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i) {
    const uint4 v = __ldg(s4 + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
  float st[3];
  float gs = 0.f;
#pragma unroll
  for (int gg = 0; gg < 8; ++gg) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = kBrev3[gg] + kBrev3[u] * 8;
      const int code = kPacked ? (w[s >> 3] >> ((s & 7) * 4)) & 0x0F
                               : (w[s >> 2] >> ((s & 3) * 8)) & 0xFF;
      v[u] = lut_get(tab, (((s << lg_book) + code) << lg_gp) + g);
    }
    gs = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
    const int pops = gg == 1 || gg == 5 ? 1 : gg == 3 ? 2 : gg == 7 ? 3 : 0;
#pragma unroll
    for (int l = 0; l < 3; ++l)
      if (l < pops) gs = __fadd_rn(st[l], gs);
#pragma unroll
    for (int l = 0; l < 3; ++l)
      if (l == pops) st[l] = gs;
  }
  return gs;
}

// The warp's filtered queue (one pair's, over the item's chunk): its
// sorted list, buffer and state in shared memory; qcnt / qthr keep the
// buffer count and threshold between calls.
template <int S>
__device__ __noinline__ void queue_rows(float* area, int* qcnt, u64* qthr,
                                        int op, int k, float d, int id,
                                        bool want) {
  constexpr int KP = 32 * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ld = area + warp * 4 * KP;
  int* li = reinterpret_cast<int*>(ld + KP);
  float* bd = ld + 2 * KP;
  int* bi = reinterpret_cast<int*>(ld + 3 * KP);
  int count = 0;
  u64 thr = kNoBound;
  if (op == 0) {  // an empty queue
    queue_init<S>(ld, li);
  } else {
    count = qcnt[warp];
    thr = qthr[warp];
    if (op == 1)  // 32 candidates, one a lane
      queue_push<S>(ld, li, bd, bi, count, thr, k, d, id, want);
    else if (count)  // op 2: the buffer into the list
      thr = queue_flush<S>(ld, li, bd, bi, count, k, thr);
    if (op == 2) count = 0;
  }
  __syncwarp();
  if (lane == 0) {
    qcnt[warp] = count;
    qthr[warp] = thr;
  }
  __syncwarp();
}

// Pair g's partial list: its first warp takes the lists of the pair's
// other warps (g + GP, g + 2 GP, ...) into its own and writes k entries.
template <int S>
__device__ __noinline__ void merge_pair(float* area, int* qcnt, u64* qthr,
                                        int k, int gp, float* od, int* oi) {
  constexpr int KP = 32 * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ld = area + warp * 4 * KP;
  int* li = reinterpret_cast<int*>(ld + KP);
  float* bd = ld + 2 * KP;
  int* bi = reinterpret_cast<int*>(ld + 3 * KP);
  int count = 0;
  u64 thr = qthr[warp];
  for (int w = warp + gp; w < kPqWarps; w += gp) {
    const float* od2 = area + w * 4 * KP;
    const int* oi2 = reinterpret_cast<const int*>(od2 + KP);
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int c = c0 + lane;
      const bool in = c < k;
      const float v = in ? od2[c] : CUDART_INF_F;
      queue_push<S>(ld, li, bd, bi, count, thr, k, v, in ? oi2[c] : kEmptyId,
                    in && v < CUDART_INF_F);
    }
  }
  if (count) thr = queue_flush<S>(ld, li, bd, bi, count, k, thr);
  for (int j = lane; j < k; j += 32) {
    od[j] = ld[j];
    oi[j] = li[j];
  }
  (void)qcnt;
}

__device__ __forceinline__ void queue_op(int S, float* area, int* qcnt,
                                         u64* qthr, int op, int k, float d,
                                         int id, bool want) {
  switch (S) {
    case 1: queue_rows<1>(area, qcnt, qthr, op, k, d, id, want); break;
    case 2: queue_rows<2>(area, qcnt, qthr, op, k, d, id, want); break;
    case 4: queue_rows<4>(area, qcnt, qthr, op, k, d, id, want); break;
    case 8: queue_rows<8>(area, qcnt, qthr, op, k, d, id, want); break;
    default: queue_rows<16>(area, qcnt, qthr, op, k, d, id, want); break;
  }
}

template <typename T>
constexpr bool kFp8 = sizeof(T) == 1;

// kTiered: a tiered index's instance (its list's code rows through
// a.list_codes, its launch's lists only); the all-device instance keeps
// the plain addressing, so the extra pointer costs it no register
template <typename T, int kCodes, bool kTiered>
__global__ void __launch_bounds__(kPqThreads, 1)
    pq_items_kernel(const PqArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  float* cbs = reinterpret_cast<float*>(smem + a.lay.cb);
  float* D = reinterpret_cast<float*>(smem + a.lay.d);
  int* ids_t = reinterpret_cast<int*>(smem + a.lay.ids);
  float* area = reinterpret_cast<float*>(smem + a.lay.queues);
  u64* qthr = reinterpret_cast<u64*>(smem + a.lay.qstate);
  int* qcnt = reinterpret_cast<int*>(qthr + kPqWarps);
  float* qs = reinterpret_cast<float*>(smem + a.lay.qs);
  float* qn = reinterpret_cast<float*>(smem + a.lay.qn);
  float* m_base = reinterpret_cast<float*>(smem + a.lay.meta);
  float* m_scale = m_base + kMaxG;
  int* m_query = reinterpret_cast<int*>(m_scale + kMaxG);
  int* m_out = m_query + kMaxG;
  float* red = reinterpret_cast<float*>(m_out + kMaxG);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr bool fp8 = kFp8<T>;
  const long long last = a.item_off[a.n_lists];
  for (long long it = blockIdx.x; it < last; it += gridDim.x) {
    // the list with item_off[lid] <= it < item_off[lid + 1]
    int lo = 0, hi = a.n_lists - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.item_off[mid] <= it)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int lid = lo, t = (int)(it - a.item_off[lid]);
    // a tiered launch scans only its own lists (block-uniform)
    if constexpr (kTiered) {
      if (a.list_wave[lid] != a.wave) continue;
    }
    const int cnt_all = a.offs[lid + 1] - a.offs[lid];
    const int ngr = (cnt_all + a.group - 1) / a.group;
    const int chunk = t / ngr, grp = t - chunk * ngr;
    const int start = a.offs[lid] + grp * a.group;
    const int cnt = min(a.group, cnt_all - grp * a.group);
    const int r0 = chunk * a.rows;
    const int nrows = min(a.rows, a.live[lid] - r0);
    const int lg_gp = ilog2(cnt), gp = 1 << lg_gp;

    __syncthreads();  // the last item is done with shared memory
    if (tid < cnt) {
      const int e = start + tid, qr = a.pair_q[e];
      const size_t pair = (size_t)qr * a.p + a.pair_slot[e];
      m_query[tid] = qr;
      m_out[tid] = a.slot_off[pair] + chunk;
      m_base[tid] = a.ip_metric ? a.base[pair] : 0.f;
      m_scale[tid] = 1.f;
    }
    for (int e = tid; e < cnt * a.dim_ext; e += kPqThreads) {
      const int g = e / a.dim_ext, d = e - g * a.dim_ext;
      const int ep = start + g, qr = a.pair_q[ep];
      const size_t src =
          (a.ip_metric ? (size_t)qr : (size_t)qr * a.p + a.pair_slot[ep]) *
          a.dim_ext;
      qs[g * a.lay.qs_stride + d] = a.qres[src + d];
    }
    if (a.per_cluster) stage_rows(cbs, a, lid, 0, 1);
    __syncthreads();
    if (!a.ip_metric)
      for (int e = tid; e < cnt * a.pq_dim; e += kPqThreads) {
        const int g = e / a.pq_dim, s = e - g * a.pq_dim;
        const float* x = qs + g * a.lay.qs_stride + s * a.pq_len;
        float acc = __fmul_rn(x[0], x[0]);
        for (int l = 1; l < a.pq_len; ++l)
          acc = __fadd_rn(acc, __fmul_rn(x[l], x[l]));
        qn[g * a.lay.qn_stride + s] = acc;
      }
    __syncthreads();
    if constexpr (fp8) {  // each pair's scale max|lut| * (1 / fmax)
      float mx = build_tables<T>(tab, cbs, a, qs, qn, m_scale, lid, cnt,
                                 lg_gp, true);
      for (int o = 16; o >= gp; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      __syncthreads();  // the sweep's stages are read
      if (lane < gp) red[warp * kMaxG + lane] = mx;
      __syncthreads();
      if (tid < cnt) {
        float m = red[tid];
        for (int w = 1; w < kPqWarps; ++w) m = fmaxf(m, red[w * kMaxG + tid]);
        m_scale[tid] = fmaxf(__fmul_rn(m, a.inv_fmax), 1e-30f);
      }
      __syncthreads();
    }
    // the item's whole tables, then its rows in tiles of 512 (row, pair)
    build_tables<T>(tab, cbs, a, qs, qn, m_scale, lid, cnt, lg_gp, false);
    const int wg = warp & (gp - 1);  // the pair this warp selects for
    if (wg < cnt) queue_op(a.S, area, qcnt, qthr, 0, a.k, 0.f, 0, false);
    __syncthreads();
    const int tile = kPqThreads >> lg_gp, dstride = tile + 1;
    const int g = tid & (gp - 1), rl = tid >> lg_gp;
    const size_t row0 = (size_t)lid * a.m + r0;
    const unsigned char* lcodes = nullptr;
    if constexpr (kTiered)
      lcodes = reinterpret_cast<const unsigned char*>(a.list_codes[lid]) +
               (size_t)r0 * a.row_bytes;
    for (int t0 = 0, buf = 0; t0 < nrows; t0 += tile, buf ^= 1) {
      float* Dt = D + buf * (kPqThreads + kMaxG);
      int* It = ids_t + buf * kPqThreads;
      const int row = t0 + rl;
      if (row < nrows && g < cnt) {
        const unsigned char* src =
            kTiered ? lcodes + (size_t)row * a.row_bytes
                    : a.codes + (row0 + row) * a.row_bytes;
        float v;
        if constexpr (kCodes == kCodesW64)
          v = score_row_w64<T, false>(tab, src, a.lg_book, lg_gp, g);
        else if constexpr (kCodes == kCodesW64Packed)
          v = score_row_w64<T, true>(tab, src, a.lg_book, lg_gp, g);
        else
          v = score_row_any<T>(tab, src, a, lg_gp, g);
        if constexpr (fp8)  // IP: one rounding, as XLA contracts it
          v = a.ip_metric ? -__fmaf_rn(v, m_scale[g], m_base[g])
                          : __fmul_rn(v, m_scale[g]);
        else if (a.ip_metric)
          v = -__fadd_rn(v, m_base[g]);
        const int id = a.indices[row0 + row];
        bool ok = id >= 0;
        if (ok && a.filter) {
          const int* fw = a.filter + (size_t)m_query[g] * a.filter_stride;
          ok = (fw[id >> 5] >> (id & 31)) & 1;
        }
        Dt[g * dstride + rl] = ok ? v : CUDART_INF_F;
        if (g == 0) It[rl] = id;
      }
      __syncthreads();  // the tile's distances are whole
      if (wg < cnt) {  // warp h of pair wg: tile rows h * 32 .. + 31
        const int r = ((warp >> lg_gp) << 5) + lane;
        const bool in = r < tile && t0 + r < nrows;
        const float d = in ? Dt[wg * dstride + r] : CUDART_INF_F;
        queue_op(a.S, area, qcnt, qthr, 1, a.k, d, in ? It[r] : kEmptyId,
                 in && d < CUDART_INF_F);
      }
    }
    if (wg < cnt) queue_op(a.S, area, qcnt, qthr, 2, a.k, 0.f, 0, false);
    __syncthreads();  // every warp's list is whole
    if (warp < cnt) {
      float* od = a.pd + (size_t)m_out[warp] * a.k;
      int* oi = a.pi + (size_t)m_out[warp] * a.k;
      switch (a.S) {
        case 1: merge_pair<1>(area, qcnt, qthr, a.k, gp, od, oi); break;
        case 2: merge_pair<2>(area, qcnt, qthr, a.k, gp, od, oi); break;
        case 4: merge_pair<4>(area, qcnt, qthr, a.k, gp, od, oi); break;
        case 8: merge_pair<8>(area, qcnt, qthr, a.k, gp, od, oi); break;
        default: merge_pair<16>(area, qcnt, qthr, a.k, gp, od, oi); break;
      }
    }
  }
}

// Exclusive prefix of each thread's value over the block (1,024 threads),
// and the block's total; ws holds 32 words.
__device__ long long block_excl_scan(long long v, long long* ws,
                                     long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = ws[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    ws[lane] = w;
  }
  __syncthreads();
  const long long before = warp ? ws[warp - 1] : 0;
  total = ws[31];
  __syncthreads();  // ws is free for the next scan
  return before + x - v;
}

constexpr int kPlanThreads = 1024;

// The work-item plan of the scan (one block, no host sync), the device
// form of ops/ivf_pq_scan `_pq_items`: each list's probing pairs (CSR
// offs over pair_q / pair_slot; a list's pairs in any order, which
// changes no result), its items ceil(live / rows) * ceil(pairs / group)
// (item_off), and the first partial list of each (query, probe slot),
// one a chunk of its list (slot_off). Sentinel slots (ids outside
// [0, n_lists)) form no pair and get no partial. cursor: n_lists words.
__global__ void __launch_bounds__(kPlanThreads)
    pq_plan_kernel(const int* __restrict__ probes, int q, int p, int n_lists,
                   const int* __restrict__ live, int rows, int group,
                   int* offs, int* pair_q, int* pair_slot,
                   long long* item_off, int* slot_off, int* cursor) {
  __shared__ long long ws[32];
  const int tid = threadIdx.x;
  const long long np = (long long)q * p;
  for (int l = tid; l < n_lists; l += kPlanThreads) cursor[l] = 0;
  __syncthreads();
  for (long long e = tid; e < np; e += kPlanThreads) {
    const int l = probes[e];
    if (l >= 0 && l < n_lists) atomicAdd(cursor + l, 1);
  }
  __syncthreads();
  long long carry_p = 0, carry_i = 0;
  for (int b = 0; b < n_lists; b += kPlanThreads) {
    const int l = b + tid;
    const int cnt = l < n_lists ? cursor[l] : 0;
    const long long nch = l < n_lists ? (live[l] + rows - 1) / rows : 0;
    long long tp, ti;
    const long long ep = block_excl_scan(cnt, ws, tp);
    const long long ei = block_excl_scan(
        cnt ? nch * ((cnt + group - 1) / group) : 0, ws, ti);
    if (l < n_lists) {
      offs[l] = (int)(carry_p + ep);
      item_off[l] = carry_i + ei;
    }
    carry_p += tp;
    carry_i += ti;
  }
  if (tid == 0) {
    offs[n_lists] = (int)carry_p;
    item_off[n_lists] = carry_i;
  }
  __syncthreads();
  for (int l = tid; l < n_lists; l += kPlanThreads) cursor[l] = offs[l];
  __syncthreads();
  long long carry_s = 0;
  for (long long b = 0; b < np; b += kPlanThreads) {
    const long long e = b + tid;
    const int l = e < np ? probes[e] : -1;
    const bool pair = l >= 0 && l < n_lists;
    if (pair) {
      const int at = atomicAdd(cursor + l, 1);
      pair_q[at] = (int)(e / p);
      pair_slot[at] = (int)(e % p);
    }
    long long ts;
    const long long es =
        block_excl_scan(pair ? (live[l] + rows - 1) / rows : 0, ws, ts);
    if (e < np) slot_off[e] = (int)(carry_s + es);
    carry_s += ts;
  }
  if (tid == 0) slot_off[np] = (int)carry_s;
}

template <typename T>
cudaError_t launch_items(const PqArgs& a, size_t smem, long long max_items,
                         cudaStream_t stream) {
  void (*kernel)(const PqArgs);
  if (a.list_codes)
    kernel = a.codes_mode == kCodesW64 ? pq_items_kernel<T, kCodesW64, true>
             : a.codes_mode == kCodesW64Packed
                 ? pq_items_kernel<T, kCodesW64Packed, true>
                 : pq_items_kernel<T, kCodesAny, true>;
  else
    kernel = a.codes_mode == kCodesW64 ? pq_items_kernel<T, kCodesW64, false>
             : a.codes_mode == kCodesW64Packed
                 ? pq_items_kernel<T, kCodesW64Packed, false>
                 : pq_items_kernel<T, kCodesAny, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPqThreads, smem);
  if (err != cudaSuccess) return err;
  const long long full = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(max_items < full ? max_items : full);
  if (blocks <= 0) return cudaSuccess;
  kernel<<<blocks, kPqThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_pq_merge(const PqArgs& a, int q, int epilog, float* outd,
                            int* outi, cudaStream_t stream) {
#define RAFT_PQ_MERGE(S_)                                                   \
  return launch_merge_s<S_>(a.pd, a.pi, q, 0, a.k, epilog, outd, outi,     \
                            stream, a.slot_off, a.p)
  switch (a.S) {
    case 1: RAFT_PQ_MERGE(1);
    case 2: RAFT_PQ_MERGE(2);
    case 4: RAFT_PQ_MERGE(4);
    case 8: RAFT_PQ_MERGE(8);
    default: RAFT_PQ_MERGE(16);
  }
#undef RAFT_PQ_MERGE
}

inline cudaError_t smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

inline bool pq_shape_ok(int pq_dim, int pq_len, int book, int k,
                        int lut_type) {
  return pq_dim >= 1 && pq_len >= 1 && book >= 2 && book <= 256 &&
         !(book & (book - 1)) && k >= 1 && k <= 512 && lut_type >= 0 &&
         lut_type <= 3 && ilog2(tree_width(pq_dim) / 8) < kTreeLevels;
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// The work-item shape the scan takes for a table shape and a count of
// (query, probe) pairs on this device:
// out = {rows, group, stage, shared bytes} of the list-major kernel, or
// {0, 0, 0, shared bytes} when its block cannot hold one pair's table
// (the per-pair instance of ivf_pq_parts.cuh then scans, with no item
// plan). The wrapper plans items with rows and group; raft_ivf_pq_scan
// takes only that plan. Returns cudaErrorInvalidValue for a shape no
// block fits.
extern "C" int raft_ivf_pq_plan(int pq_dim, int pq_len, int book, int k,
                                int lut_type, long long pairs, int* out) {
  if (!pq_shape_ok(pq_dim, pq_len, book, k, lut_type))
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  PqPlan plan;
  if (pq_plan(pq_dim, pq_len, book, k, lut_type, pairs, (size_t)limit,
              &plan)) {
    out[0] = plan.rows;
    out[1] = plan.group;
    out[2] = plan.stage;
    out[3] = (int)plan.smem;
    return (int)cudaSuccess;
  }
  pq_parts::PqArgs pa;
  const size_t smem = pq_parts::plan(pa, pq_dim, pq_len, book,
                                     pq_dim /* unpacked row bytes */, k,
                                     limit);
  if (!smem) return (int)cudaErrorInvalidValue;
  out[0] = out[1] = out[2] = 0;
  out[3] = (int)smem;
  return (int)cudaSuccess;
}

// One search's arguments, as the C entries take them.
struct PqCall {
  const void *qres, *base, *codebooks, *cb_norms, *codes, *indices, *probes,
      *filter;
  long long filter_stride;
  const void *offs, *pair_q, *pair_slot, *live, *item_off, *slot_off;
  int q, p, n_lists, m, row_bytes, pq_dim, pq_len, book, k, ip_metric,
      per_cluster, packed, lut_type;
  long long max_items;
  int rows, group;
  void *pd, *pi, *outd, *outi;
};

// A tiered search's staging: list_tab (2 * n_lists,) int64 on the device,
// each list's first code row (its hot slot's row in `codes`, the hot plane,
// or its ring offset's row in `ring`), then the launch that scans it (-1
// the hot lists, w a staged wave, -2 an unprobed cold list); `cold` the
// (n_cold, m, row_bytes) codes in pinned host memory (null without cold
// lists to stage); the waves as tier_scan.cu plans them: wave_end (end of
// each wave in the copies), reuse (wave w + 2 overwrites wave w's half of
// the ring), and per copy the cold slot, rows and ring row offset (host
// arrays); copy_stream a side stream for the copies.
struct PqTier {
  const long long* list_tab;
  const unsigned char* cold;
  unsigned char* ring;
  int n_waves, reuse;
  const int *wave_end, *copy_slot, *copy_rows;
  const long long* copy_off;
  cudaStream_t copy_stream;
};

// Events of one call: created here, destroyed on every return (a pending
// event is released once it completes).
struct PqEvents {
  std::vector<cudaEvent_t> ev;
  ~PqEvents() {
    for (cudaEvent_t e : ev) cudaEventDestroy(e);
  }
  cudaError_t make(int count) {
    for (int i = 0; i < count; ++i) {
      cudaEvent_t e;
      cudaError_t err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
      if (err != cudaSuccess) return err;
      ev.push_back(e);
    }
    return cudaSuccess;
  }
};

#define RAFT_PQ_TRY(x)                       \
  do {                                       \
    cudaError_t e_ = (x);                    \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// The launches of one search: one `launch(wave)` without a tier; with
// one, the hot lists' launch, then the cold lists wave by wave, each after
// its copies (cudaMemcpyAsync, pinned host -> ring, on the copy stream, an
// event a wave), all on the compute stream; the merge follows. No kernel
// reads host memory.
template <typename Launch>
static int run_tiered(const PqCall& c, const PqTier* t, cudaStream_t s,
                      Launch launch) {
  if (!t) return (int)launch(0);
  PqEvents ev;
  RAFT_PQ_TRY(ev.make(1 + 2 * t->n_waves));
  auto copied = [&](int w) { return ev.ev[1 + 2 * w]; };
  auto scanned = [&](int w) { return ev.ev[2 + 2 * w]; };
  const size_t rb = (size_t)c.row_bytes;
  auto issue_copies = [&](int w) -> cudaError_t {
    if (t->reuse && w >= 2) {  // the same half: after wave w - 2's scan
      cudaError_t err = cudaStreamWaitEvent(t->copy_stream, scanned(w - 2), 0);
      if (err != cudaSuccess) return err;
    }
    for (int i = w ? t->wave_end[w - 1] : 0; i < t->wave_end[w]; ++i) {
      if (t->copy_rows[i] <= 0) continue;
      cudaError_t err = cudaMemcpyAsync(
          t->ring + (size_t)t->copy_off[i] * rb,
          t->cold + (size_t)t->copy_slot[i] * c.m * rb,
          (size_t)t->copy_rows[i] * rb, cudaMemcpyHostToDevice,
          t->copy_stream);
      if (err != cudaSuccess) return err;
    }
    return cudaEventRecord(copied(w), t->copy_stream);
  };
  if (t->n_waves > 0) {
    // the ring and the cold plane (which placement writes on the compute
    // stream) may still be in use by work queued before this call
    RAFT_PQ_TRY(cudaEventRecord(ev.ev[0], s));
    RAFT_PQ_TRY(cudaStreamWaitEvent(t->copy_stream, ev.ev[0], 0));
    const int ahead = t->reuse ? 2 : t->n_waves;
    for (int w = 0; w < t->n_waves && w < ahead; ++w)
      RAFT_PQ_TRY(issue_copies(w));
  }
  RAFT_PQ_TRY(launch(-1));  // the hot lists need no copy
  for (int w = 0; w < t->n_waves; ++w) {
    RAFT_PQ_TRY(cudaStreamWaitEvent(s, copied(w), 0));
    RAFT_PQ_TRY(launch(w));
    RAFT_PQ_TRY(cudaEventRecord(scanned(w), s));
    if (t->reuse && w + 2 < t->n_waves) RAFT_PQ_TRY(issue_copies(w + 2));
  }
  return (int)cudaSuccess;
}

// The per-pair instance (ivf_pq_parts.cuh) on (q, p) probes.
static int scan_parts(const PqCall& c, const PqTier* t, int limit,
                      cudaStream_t s) {
  pq_parts::PqArgs a;
  a.qres = (const float*)c.qres;
  a.base = (const float*)c.base;
  a.codebooks = (const float*)c.codebooks;
  a.cb_norms = (const float*)c.cb_norms;
  a.codes = (const unsigned char*)c.codes;
  a.list_codes = t ? t->list_tab : nullptr;
  a.list_wave = t ? t->list_tab + c.n_lists : nullptr;
  a.wave = 0;
  a.indices = (const int*)c.indices;
  a.live = (const int*)c.live;
  a.probes = (const int*)c.probes;
  a.filter = (const int*)c.filter;
  a.filter_stride = c.filter_stride;
  a.p = c.p;
  a.n_lists = c.n_lists;
  a.m = c.m;
  a.row_bytes = c.row_bytes;
  a.pq_dim = c.pq_dim;
  a.pq_len = c.pq_len;
  a.book = c.book;
  a.k = c.k;
  a.ip_metric = c.ip_metric;
  a.per_cluster = c.per_cluster;
  a.packed = c.packed;
  a.lut_type = c.lut_type;
  a.inv_fmax = c.lut_type == kLutE5m2 ? (float)(1.0 / 57344.0)
                                       : (float)(1.0 / 448.0);
  a.pd = (float*)c.pd;
  a.pi = (int*)c.pi;
  const size_t smem = pq_parts::plan(a, c.pq_dim, c.pq_len, c.book,
                                     c.row_bytes, c.k, limit);
  if (!smem || c.q > 65535) return (int)cudaErrorInvalidValue;
  const int err = run_tiered(c, t, s, [&](int wave) {
    a.wave = wave;
    return pq_parts::launch_pq(a, c.q, smem, s);
  });
  if (err != (int)cudaSuccess) return err;
  return (int)pq_parts::launch_pq_merge(
      a.pd, a.pi, c.q, c.p * c.k, c.k,
      c.ip_metric ? kEpilogNegate : kEpilogNone, (float*)c.outd,
      (int*)c.outi, s);
}

static int pq_scan_impl(const PqCall& c, const PqTier* t, cudaStream_t s) {
  if (c.q < 0 || c.p < 1 || c.n_lists < 1 || c.m < 0 ||
      !pq_shape_ok(c.pq_dim, c.pq_len, c.book, c.k, c.lut_type) ||
      c.row_bytes != (c.packed ? (c.pq_dim + 1) / 2 : c.pq_dim) ||
      (c.ip_metric && !c.base) || (!c.ip_metric && !c.cb_norms))
    return (int)cudaErrorInvalidValue;
  if (c.q == 0) return (int)cudaSuccess;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  PqPlan plan;
  const bool items =
      pq_plan(c.pq_dim, c.pq_len, c.book, c.k, c.lut_type,
              (long long)c.q * c.p, (size_t)limit, &plan);
  if (!items && c.group == 0) return scan_parts(c, t, limit, s);
  if (!items || plan.rows != c.rows || plan.group != c.group)
    return (int)cudaErrorInvalidValue;
  PqArgs a;
  a.qres = (const float*)c.qres;
  a.base = (const float*)c.base;
  a.codebooks = (const float*)c.codebooks;
  a.cb_norms = (const float*)c.cb_norms;
  a.codes = (const unsigned char*)c.codes;
  a.list_codes = t ? t->list_tab : nullptr;
  a.list_wave = t ? t->list_tab + c.n_lists : nullptr;
  a.wave = 0;
  a.indices = (const int*)c.indices;
  a.filter = (const int*)c.filter;
  a.filter_stride = c.filter_stride;
  a.offs = (const int*)c.offs;
  a.pair_q = (const int*)c.pair_q;
  a.pair_slot = (const int*)c.pair_slot;
  a.live = (const int*)c.live;
  a.item_off = (const long long*)c.item_off;
  a.slot_off = (const int*)c.slot_off;
  a.n_lists = c.n_lists;
  a.p = c.p;
  a.m = c.m;
  a.row_bytes = c.row_bytes;
  a.pq_dim = c.pq_dim;
  a.pq_len = c.pq_len;
  a.book = c.book;
  a.k = c.k;
  a.dim_ext = c.pq_dim * c.pq_len;
  a.ip_metric = c.ip_metric;
  a.per_cluster = c.per_cluster;
  a.packed = c.packed;
  a.lut_type = c.lut_type;
  a.cb_vec4 =
      (c.book * c.pq_len) % 4 == 0 && ((uintptr_t)c.codebooks & 15) == 0;
  a.nrm_vec4 =
      a.cb_vec4 && c.book % 4 == 0 && ((uintptr_t)c.cb_norms & 15) == 0;
  a.groups = tree_width(c.pq_dim) / 8;
  a.levels = ilog2(a.groups);
  a.rows = c.rows;
  a.group = c.group;
  a.lg_book = ilog2(c.book);
  a.S = pq_slots(c.k);
  a.lay = pq_layout(c.pq_dim, c.pq_len, c.book, c.k, c.lut_type, c.group,
                    plan.stage);
  // 16-byte row loads need 16-byte aligned planes: pq_dim 64 rows are 64
  // or 32 bytes, and ring offsets are whole staging tiles of rows
  const uintptr_t planes =
      (uintptr_t)c.codes | (uintptr_t)(t ? t->ring : nullptr);
  a.codes_mode = c.pq_dim != 64 || (planes & 15) != 0 ? kCodesAny
                 : c.packed                           ? kCodesW64Packed
                                                      : kCodesW64;
  a.inv_fmax = c.lut_type == kLutE5m2 ? (float)(1.0 / 57344.0)
                                       : (float)(1.0 / 448.0);
  a.pd = (float*)c.pd;
  a.pi = (int*)c.pi;
  const int rc = run_tiered(c, t, s, [&](int wave) {
    a.wave = wave;
    switch (c.lut_type) {
      case kLutF32: return launch_items<float>(a, plan.smem, c.max_items, s);
      case kLutBf16:
        return launch_items<__nv_bfloat16>(a, plan.smem, c.max_items, s);
      case kLutE4m3:
        return launch_items<__nv_fp8_e4m3>(a, plan.smem, c.max_items, s);
      default:
        return launch_items<__nv_fp8_e5m2>(a, plan.smem, c.max_items, s);
    }
  });
  if (rc != (int)cudaSuccess) return rc;
  return (int)launch_pq_merge(a, c.q,
                              c.ip_metric ? kEpilogNegate : kEpilogNone,
                              (float*)c.outd, (int*)c.outi, s);
}

// The work items of one search on the device (pq_plan_kernel): probes
// (q, p) int32 without repeats in a row (sentinel: any id outside
// [0, n_lists)); live (n_lists,) int32 rows up to each list's last live
// id; rows and group from raft_ivf_pq_plan. Writes offs (n_lists + 1,)
// int32, pair_q / pair_slot (q * p,) int32, item_off (n_lists + 1,)
// int64, slot_off (q * p + 1,) int32, with cursor (n_lists,) int32
// scratch. Returns cudaError_t.
extern "C" int raft_ivf_pq_items(const void* probes, int q, int p,
                                 int n_lists, const void* live, int rows,
                                 int group, void* offs, void* pair_q,
                                 void* pair_slot, void* item_off,
                                 void* slot_off, void* cursor,
                                 void* stream) {
  if (q < 0 || p < 1 || n_lists < 1 || rows < 1 || group < 1)
    return (int)cudaErrorInvalidValue;
  pq_plan_kernel<<<1, kPlanThreads, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int*)probes, q, p, n_lists, (const int*)live, rows, group,
      (int*)offs, (int*)pair_q, (int*)pair_slot, (long long*)item_off,
      (int*)slot_off, (int*)cursor);
  return (int)cudaGetLastError();
}

// Plain C entry for ctypes. qres: L2 (q, p, pq_dim * pq_len) f32, IP
// (q, pq_dim * pq_len); base: IP (q, p) f32 (L2: null); codebooks
// (pq_dim or n_lists, book, pq_len) f32, cb_norms (pq_dim or n_lists,
// book) f32 (L2); codes (n_lists, m, row_bytes) u8, two 4-bit codes a
// byte when packed; indices (n_lists, m) int32; filter words (null, one
// shared bitset with filter_stride 0, or filter_stride words a query);
// probes (q, p) int32 without repeats in a row (sentinel n_lists); live
// (n_lists,) int32 rows up to each list's last live id; the item plan of
// raft_ivf_pq_items (or ops/ivf_pq_scan `_pq_items`) with
// raft_ivf_pq_plan's rows and group: offs, pair_q / pair_slot, item_off,
// slot_off; max_items a host bound on item_off[n_lists]; with group 0
// the per-pair instance scans and the plan pointers are unused; lut_type
// 0 f32, 1 bf16, 2 e4m3, 3 e5m2; pd/pi scratch of slot_off[q * p] * k
// entries (group 0: q * p * k), written whole; outd/outi (q, k).
// Returns cudaError_t.
extern "C" int raft_ivf_pq_scan(
    const void* qres, const void* base, const void* codebooks,
    const void* cb_norms, const void* codes, const void* indices,
    const void* probes, const void* filter, long long filter_stride,
    const void* offs,
    const void* pair_q, const void* pair_slot, const void* live,
    const void* item_off, const void* slot_off, int q, int p, int n_lists,
    int m, int row_bytes, int pq_dim, int pq_len, int book, int k,
    int ip_metric, int per_cluster, int packed, int lut_type,
    long long max_items, int rows, int group, void* pd, void* pi,
    void* outd, void* outi, void* stream) {
  const PqCall c{qres,    base,     codebooks, cb_norms,  codes,    indices,
                 probes,  filter,   filter_stride,        offs,     pair_q,
                 pair_slot, live,   item_off,  slot_off,  q,        p,
                 n_lists, m,        row_bytes, pq_dim,    pq_len,   book,
                 k,       ip_metric, per_cluster, packed, lut_type, max_items,
                 rows,    group,    pd,        pi,        outd,     outi};
  return pq_scan_impl(c, nullptr, reinterpret_cast<cudaStream_t>(stream));
}

// The dual-source search of a tiered index: raft_ivf_pq_scan's arguments,
// with `codes` the hot plane (n_hot, m, row_bytes) and n_lists the index's
// list count, then the staging (struct PqTier): list_tab (2 * n_lists,)
// int64 on the device; cold (n_cold, m, row_bytes) u8 in pinned host
// memory, or null when no list is staged; ring the device staging ring;
// n_waves, reuse and the host arrays wave_end (n_waves,), copy_slot,
// copy_rows (n_copies,) int32 and copy_off (n_copies,) int64 of
// ops/tier_scan.tier_stage_plan; copy_stream the copies' side stream.
// A cold pointer that is not page-locked host memory is refused
// (cudaErrorInvalidValue): cudaMemcpyAsync from pageable memory would
// copy synchronously. Returns cudaError_t.
extern "C" int raft_ivf_pq_scan_tiered(
    const void* qres, const void* base, const void* codebooks,
    const void* cb_norms, const void* hot, const void* indices,
    const void* probes, const void* filter, long long filter_stride,
    const void* offs, const void* pair_q, const void* pair_slot,
    const void* live, const void* item_off, const void* slot_off, int q,
    int p, int n_lists, int m, int row_bytes, int pq_dim, int pq_len,
    int book, int k, int ip_metric, int per_cluster, int packed,
    int lut_type, long long max_items, int rows, int group, void* pd,
    void* pi, void* outd, void* outi, const void* list_tab,
    const void* cold, void* ring, int n_waves, int reuse,
    const int* wave_end, const int* copy_slot, const long long* copy_off,
    const int* copy_rows, void* stream, void* copy_stream) {
  if (!list_tab || n_waves < 0 || (n_waves > 0 && (!cold || !ring)))
    return (int)cudaErrorInvalidValue;
  if (cold != nullptr) {
    cudaPointerAttributes attr;
    cudaError_t err = cudaPointerGetAttributes(&attr, cold);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset it, so later error checks do not see it
      return (int)err;
    }
    if (attr.type != cudaMemoryTypeHost) return (int)cudaErrorInvalidValue;
  }
  const PqCall c{qres,    base,     codebooks, cb_norms,  hot,      indices,
                 probes,  filter,   filter_stride,        offs,     pair_q,
                 pair_slot, live,   item_off,  slot_off,  q,        p,
                 n_lists, m,        row_bytes, pq_dim,    pq_len,   book,
                 k,       ip_metric, per_cluster, packed, lut_type, max_items,
                 rows,    group,    pd,        pi,        outd,     outi};
  const PqTier t{(const long long*)list_tab,
                 (const unsigned char*)cold,
                 (unsigned char*)ring,
                 n_waves,
                 reuse,
                 wave_end,
                 copy_slot,
                 copy_rows,
                 copy_off,
                 reinterpret_cast<cudaStream_t>(copy_stream)};
  return pq_scan_impl(c, &t, reinterpret_cast<cudaStream_t>(stream));
}
