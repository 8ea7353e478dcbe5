// The work-item body of the IVF-Flat probe scan, shared by the all-device
// scan (ivf_scan.cu) and the tiered dual-source scan (tier_scan.cu). The
// two kernels differ only in where a list's rows come from; everything
// from the row pointer on is this one function, so the tiered scan
// returns the all-device scan's partial lists bit for bit.
//
// Work items. A union step j (one probed list) with `live` rows (up to
// its last live id) and `cnt` probing queries (pairs offs[j] .. offs[j+1]
// of the list-sorted pairs) has ceil(live / kChunkRows) row chunks times
// ceil(cnt / 64) query groups of items. item_off[s] is the first item of
// the launch's step s (over `order`, or the union itself when order is
// null); a block walks items blockIdx.x, + gridDim.x, ... and finds each
// one's step by a binary search, so no block is launched for an empty
// (list, group) and a long list is spread over many blocks.
//
// One item scores its chunk's rows against its group's queries:
//   - the group's query rows are staged into shared memory once, the
//     whole depth (zero padded to a multiple of 32) when it is at most
//     kQueryDepthMax, else 32 columns a stage beside the rows;
//   - the chunk streams through a ring of kStages stages of 128 rows x
//     32 columns, by cp.async (16-byte copies, zero-filled past the
//     chunk and past d) for 16-byte aligned float32 rows, by loads and
//     stores otherwise (bfloat16 widened exactly); stage s + 1 is in
//     flight while stage s is scored, with one barrier a stage (a third
//     and fourth stage measured slower on the H100: PERF.md);
//   - 256 threads, each a 4-query x 8-row register micro-tile: per
//     4 columns one float4 of each of its 4 query rows and of each of its
//     8 rows, 12 shared loads per 128 fused multiply-adds. An item of at
//     most 4 queries (small batches) is narrow instead: 128 threads score
//     one row each against its queries. Each (query, row) product is one
//     fmaf chain in column order (the exactness guards rest on it);
//   - after a tile's last stage, min-space `norms - 2 ip` (L2) or `-ip`
//     (IP) for rows with id >= 0, from the tile's ids and norms staged
//     with its first stage. Each warp owns 8 query lists; a thread tests
//     its 32 candidates against register copies of its queries' seed
//     bounds (seed_bounds below) and lists' k-th entries, and one vote
//     of the warp skips the tile when none passes, the common case past
//     the first tiles. Otherwise each query with a passing candidate
//     takes them into its list: for k <= 32 held in registers, one
//     entry a lane, each insertion a ballot and a shuffle; for larger k
//     warp_insert in shared memory;
//   - the item writes each query's list into its own partial slot,
//     slot_off[query * p + probe slot] + chunk, k entries (+inf / id
//     kEmptyId where unfilled): every partial is written by exactly one
//     item, so the buffer needs no fill, and the ragged merge
//     (topk_common.cuh) reduces a query's slots in (distance, id) order.
#pragma once

#include "topk_common.cuh"

namespace raft_tpu_torch {

constexpr int kChunkRows = 512;       // list rows of one work item
constexpr int kTileRows = 128;        // rows of one ring stage
constexpr int kStageDepth = 32;       // columns of one ring stage
constexpr int kStages = 2;            // ring depth (3 and 4 measured slower)
constexpr int kStageVecs = kStageDepth / 4;  // 16-byte copies a row
constexpr int kRowStride = kStageDepth + 4;  // floats per staged row
constexpr int kQueryDepthMax = 256;   // whole-depth query slab up to this
constexpr int kNarrowQ = 4;           // items of at most this many queries
constexpr int kScanBlocksPerSm = 2;  // launch bound: <= 128 registers
static_assert(kThreads == 2 * kTileRows, "a tile's ids and norms: a thread each");

struct ScanArgs {
  const float* Q;            // (q, d) float32
  const float* norms;        // (n_lists, m)
  const int* ids_g;          // (cap, m) id planes of the union
  const int* uniq;           // (cap,) union list ids
  const int* offs;           // (cap + 1,) CSR over the list-sorted pairs
  const int* pair_q;         // query row of each pair
  const int* pair_slot;      // probe slot of each pair
  const int* live;           // (cap,) rows up to each step's last live id
  const int* slot_off;       // (q * p + 1,) first partial of (query, slot)
  const long long* order;    // the launch's steps -> union step, or null
  const long long* item_off; // first item of each step of `order`
  int begin, end;            // this launch's steps: order[begin, end)
  int p, d, m, k, ip_metric;
  int vec;                   // rows and queries take 16-byte copies
  const float* bound_d;      // (q,) each query's seed bound, or null
  const int* bound_i;
  float* pd;                 // partial lists, k entries each
  int* pi;
};

// columns of the whole-depth query slab, 0 when the queries are staged
// a stage at a time
__host__ __device__ inline int query_slab_depth(int d) {
  const int dp = (d + kStageDepth - 1) / kStageDepth * kStageDepth;
  return dp <= kQueryDepthMax ? dp : 0;
}

// dynamic shared memory of one scan block
inline size_t scan_smem_bytes(int d, int k) {
  const int qd = query_slab_depth(d);
  const size_t qf = qd ? (size_t)kQT * (qd + 4)
                       : (size_t)kStages * kQT * kRowStride;
  return (qf + (size_t)kStages * kTileRows * kRowStride) * sizeof(float) +
         (size_t)kQT * k * (sizeof(float) + sizeof(int)) +
         2 * kQT * sizeof(int) + kQT * (sizeof(float) + sizeof(int)) +
         (size_t)kStages * kTileRows * (sizeof(float) + sizeof(int)) +
         (size_t)kNarrowQ * kTileRows * sizeof(float);
}

// one call site of the general insertion (k > 32), not one per unrolled
// candidate
__device__ __noinline__ void warp_insert_at(float* ld, int* li, int k,
                                            float cd, int ci, bool valid) {
  warp_insert(ld, li, k, cd, ci, valid);
}

// 4 consecutive values of a row into 4 floats of shared memory, element by
// element (bfloat16 rows, or rows that are not 16-byte aligned): zeros
// past `n` columns or for an invalid row
template <typename XT>
__device__ __forceinline__ void copy4(float* dst, const XT* __restrict__ src,
                                      int n, bool valid) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    dst[u] = (valid && u < n) ? to_f32(src[u]) : 0.f;
}

// Scores one work item. `list` is the step's (m, d) rows (the chunk
// starts at row r0 of it), `lid` its list id. With seed_row >= 0 the item
// is that one query's seed (cnt 1, no bound, no pairs): instead of its
// list it writes the list's k-th entry to seed_d / seed_i.
template <typename XT>
__device__ __forceinline__ void scan_item(const ScanArgs& a,
                                          const XT* __restrict__ list,
                                          int lid, int j, int start, int cnt,
                                          int chunk, int r0, int nrows,
                                          unsigned char* smem_raw,
                                          int seed_row = -1,
                                          float* seed_d = nullptr,
                                          int* seed_i = nullptr) {
  const int d = a.d, k = a.k;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int qd = query_slab_depth(d);
  const int nck = (d + kStageDepth - 1) / kStageDepth;
  const int qs = qd ? qd + 4 : kRowStride;  // query row stride
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Xs = Qs + (qd ? kQT * (qd + 4) : kStages * kQT * kRowStride);
  float* Ld = Xs + kStages * kTileRows * kRowStride;
  int* Li = reinterpret_cast<int*>(Ld + kQT * k);
  int* qidx = Li + kQT * k;
  int* qbase = qidx + kQT;
  float* bd = reinterpret_cast<float*>(qbase + kQT);  // seed bounds
  int* bi = reinterpret_cast<int*>(bd + kQT);
  // each tile's ids and norms, a ring of kStages tiles
  int* ids_s = bi + kQT;
  float* nrm_s = reinterpret_cast<float*>(ids_s + kStages * kTileRows);
  float* Ds = nrm_s + kStages * kTileRows;  // narrow items' distances

  const float* __restrict__ nrm = a.norms + (size_t)lid * a.m + r0;
  const int* __restrict__ ids = a.ids_g + (size_t)j * a.m + r0;
  const XT* __restrict__ X = list + (size_t)r0 * d;

  __syncthreads();  // the previous item is done with shared memory
  init_lists(Ld, Li, kQT * k);
  if (tid < kQT && seed_row >= 0) {
    qidx[tid] = tid == 0 ? seed_row : -1;
    qbase[tid] = 0;
    bd[tid] = CUDART_INF_F;
    bi[tid] = kEmptyId;
  } else if (tid < kQT) {
    const bool in = tid < cnt;
    const int e = start + tid;
    qidx[tid] = in ? a.pair_q[e] : -1;
    qbase[tid] = in ? a.slot_off[a.pair_q[e] * a.p + a.pair_slot[e]] + chunk
                    : 0;
    const bool bound = in && a.bound_d != nullptr;
    bd[tid] = bound ? a.bound_d[a.pair_q[e]] : CUDART_INF_F;
    bi[tid] = bound ? a.bound_i[a.pair_q[e]] : kEmptyId;
  }
  __syncthreads();
  if (qd && a.vec) {  // the whole query slab, once per item
    const int q4 = qd / 4;
    for (int e = tid; e < kQT * q4; e += kThreads) {
      const int r = e / q4, c = (e - r * q4) * 4;
      const int qi = qidx[r];
      const bool valid = qi >= 0 && c < d;
      cp_async16(Qs + r * qs + c, a.Q + (valid ? (size_t)qi * d + c : 0),
                 valid);
    }
  } else if (qd) {
    for (int e = tid; e < kQT * qd; e += kThreads) {
      const int r = e / qd, c = e - r * qd;
      const int qi = qidx[r];
      Qs[r * qs + c] = (qi >= 0 && c < d) ? a.Q[(size_t)qi * d + c] : 0.f;
    }
  }

  const int ntile = (nrows + kTileRows - 1) / kTileRows;
  const int nst = ntile * nck;
  auto load_stage = [&](int s) {
    const int tile = s / nck, ck = s - tile * nck;
    const int c0 = ck * kStageDepth;
    float* xs = Xs + (s % kStages) * kTileRows * kRowStride;
    if (ck == 0) {  // the tile's ids and norms, read by its epilog
      const int rr = tid & (kTileRows - 1), row = tile * kTileRows + rr;
      const bool valid = row < nrows;
      const int slot = (tile % kStages) * kTileRows + rr;
      if (tid < kTileRows)
        cp_async4(ids_s + slot, ids + (valid ? row : 0), valid);
      else
        cp_async4(nrm_s + slot, nrm + (valid ? row : 0), valid);
    }
#pragma unroll
    for (int u = 0; u < (kTileRows * kStageDepth / 4) / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int rr = e / kStageVecs, col = c0 + (e % kStageVecs) * 4;
      const int row = tile * kTileRows + rr;
      const bool valid = row < nrows && col < d;
      float* dst = xs + rr * kRowStride + (e % kStageVecs) * 4;
      const XT* src = X + (size_t)(valid ? row : 0) * d + (valid ? col : 0);
      if (sizeof(XT) == 4 && a.vec)
        cp_async16(dst, src, valid);
      else
        copy4<XT>(dst, src, d - col, valid);
    }
    if (!qd) {  // the queries' columns of this stage
      float* qsd = Qs + (s % kStages) * kQT * kRowStride;
#pragma unroll
      for (int u = 0; u < (kQT * kStageDepth / 4) / kThreads; ++u) {
        const int e = tid + u * kThreads;
        const int r = e / kStageVecs, col = c0 + (e % kStageVecs) * 4;
        const int qi = qidx[r];
        const bool valid = qi >= 0 && col < d;
        float* dst = qsd + r * kRowStride + (e % kStageVecs) * 4;
        const float* src =
            a.Q + (valid ? (size_t)qi * d + col : (size_t)0);
        if (a.vec)
          cp_async16(dst, src, valid);
        else
          copy4<float>(dst, src, d - col, valid);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  float acc[4][8];
  // Two mappings. Wide (more than kNarrowQ queries): a thread scores 4
  // queries x 8 rows. Narrow: the first 128 threads score one row each
  // against the (at most 4) queries, so a small batch does not leave
  // all but one warp of the block idle.
  const bool narrow = cnt <= kNarrowQ;  // block-uniform
  const bool active = narrow ? tid < kTileRows : ty * 4 < cnt;
  // register copies of this thread's queries' list k-th entries
  float kd[4];
  int ki[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kd[i] = CUDART_INF_F;
    ki[i] = kEmptyId;
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1's slot is free
    if (s + kStages - 1 < nst) load_stage(s + kStages - 1);
    cp_async_commit();
    const int tile = s / nck, ck = s - tile * nck;
    if (ck == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
    }
    const float* xs = Xs + (s % kStages) * kTileRows * kRowStride;
    const float* qb =
        qd ? Qs + ck * kStageDepth : Qs + (s % kStages) * kQT * kRowStride;
    if (narrow && active) {
#pragma unroll
      for (int kk = 0; kk < kStageDepth; kk += 4) {
        const float4 xb =
            *reinterpret_cast<const float4*>(xs + tid * kRowStride + kk);
#pragma unroll
        for (int i = 0; i < kNarrowQ; ++i) {
          const float4 qa =
              *reinterpret_cast<const float4*>(qb + i * qs + kk);
          acc[i][0] = fmaf(qa.x, xb.x, acc[i][0]);
          acc[i][0] = fmaf(qa.y, xb.y, acc[i][0]);
          acc[i][0] = fmaf(qa.z, xb.z, acc[i][0]);
          acc[i][0] = fmaf(qa.w, xb.w, acc[i][0]);
        }
      }
    } else if (active) {
#pragma unroll
      for (int kk = 0; kk < kStageDepth; kk += 4) {
        float4 qa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] = *reinterpret_cast<const float4*>(qb + (ty * 4 + i) * qs +
                                                   kk);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 xb = *reinterpret_cast<const float4*>(
              xs + (tx + 16 * jj) * kRowStride + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj] = fmaf(qa[i].x, xb.x, acc[i][jj]);
            acc[i][jj] = fmaf(qa[i].y, xb.y, acc[i][jj]);
            acc[i][jj] = fmaf(qa[i].z, xb.z, acc[i][jj]);
            acc[i][jj] = fmaf(qa[i].w, xb.w, acc[i][jj]);
          }
        }
      }
    }
    if (ck != nck - 1) continue;
    // ---- the tile's epilog: min-space distances, then insertion
    const int* ids_t = ids_s + (tile % kStages) * kTileRows;
    const float* nrm_t = nrm_s + (tile % kStages) * kTileRows;
    if (narrow) {
      // the distances through shared memory; warp r takes query r's 128
      if (active) {
        const int row = tile * kTileRows + tid;
        const int id = row < nrows ? ids_t[tid] : -1;
#pragma unroll
        for (int i = 0; i < kNarrowQ; ++i) {
          const float ip = acc[i][0];
          Ds[i * kTileRows + tid] =
              id < 0 ? CUDART_INF_F
              : a.ip_metric ? -ip
                            : __fsub_rn(nrm_t[tid], __fmul_rn(2.f, ip));
        }
      }
      __syncthreads();
      if (warp < cnt) {
        const float sd = bd[warp];
        const int si = bi[warp];
        float cv[4];
        int cid[4];
        unsigned pm = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = lane + 32 * c;
          cv[c] = Ds[warp * kTileRows + col];
          cid[c] = tile * kTileRows + col < nrows ? ids_t[col] : -1;
          if (cv[c] < CUDART_INF_F && !lex_less(sd, si, cv[c], cid[c]) &&
              lex_less(cv[c], cid[c], kd[0], ki[0]))
            pm |= 1u << c;
        }
        if (__any_sync(kFull, pm != 0)) {
          float* ld = Ld + warp * k;
          int* li = Li + warp * k;
          if (k <= 32) {
            const bool in = lane < k;
            float md = in ? ld[lane] : CUDART_INF_F;
            int mi = in ? li[lane] : kEmptyId;
            kd[0] = __shfl_sync(kFull, md, k - 1);
            ki[0] = __shfl_sync(kFull, mi, k - 1);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              warp_insert_regs(md, mi, kd[0], ki[0], k, cv[c], cid[c],
                               (pm >> c) & 1);
            if (in) {
              ld[lane] = md;
              li[lane] = mi;
            }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              warp_insert_at(ld, li, k, cv[c], cid[c], (pm >> c) & 1);
            __syncwarp();
            kd[0] = ld[k - 1];
            ki[0] = li[k - 1];
          }
          __syncwarp();
        }
      }
      continue;
    }
    int idr[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int row = tile * kTileRows + tx + 16 * jj;
      const int id = row < nrows ? ids_t[tx + 16 * jj] : -1;
      idr[jj] = id;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ip = acc[i][jj];
        acc[i][jj] = id < 0 ? CUDART_INF_F
                     : a.ip_metric
                         ? -ip
                         : __fsub_rn(nrm_t[tx + 16 * jj],
                                     __fmul_rn(2.f, ip));
      }
    }
    // which of this thread's candidates can enter its query's list: not
    // past the seed bound and ahead of the list's k-th entry (register
    // copies); one vote of the warp skips the tile's insertion
    unsigned pass[4];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sd = bd[ty * 4 + i];
      const int si = bi[ty * 4 + i];
      pass[i] = 0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (acc[i][jj] < CUDART_INF_F &&
            !lex_less(sd, si, acc[i][jj], idr[jj]) &&
            lex_less(acc[i][jj], idr[jj], kd[i], ki[i]))
          pass[i] |= 1u << jj;
      any |= pass[i] != 0;
    }
    if (!__any_sync(kFull, any)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (2 * warp + h) * 4 + i;  // warp-uniform
        const bool mine = (lane >> 4) == h;
        if (r >= cnt || !__any_sync(kFull, mine && pass[i])) continue;
        float* ld = Ld + r * k;
        int* li = Li + r * k;
        float nkd;
        int nki;
        if (k <= 32) {
          // the list in registers, one entry a lane, for the insertions
          const bool in = lane < k;
          float md = in ? ld[lane] : CUDART_INF_F;
          int mi = in ? li[lane] : kEmptyId;
          nkd = __shfl_sync(kFull, md, k - 1);
          nki = __shfl_sync(kFull, mi, k - 1);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            warp_insert_regs(md, mi, nkd, nki, k, acc[i][jj], idr[jj],
                             mine && ((pass[i] >> jj) & 1));
          if (in) {
            ld[lane] = md;
            li[lane] = mi;
          }
          __syncwarp();
        } else {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            warp_insert_at(ld, li, k, acc[i][jj], idr[jj],
                           mine && ((pass[i] >> jj) & 1));
          __syncwarp();
          nkd = ld[k - 1];
          nki = li[k - 1];
        }
        if (mine) {
          kd[i] = nkd;
          ki[i] = nki;
        }
      }
    }
  }
  cp_async_wait<0>();
  // a narrow item's lists were filled by warps 0 .. cnt - 1
  if (narrow) __syncthreads();
  if (seed_row >= 0) {
    if (tid == 0) {
      const float v = Ld[k - 1];
      seed_d[seed_row] = v;
      seed_i[seed_row] = v < CUDART_INF_F ? Li[k - 1] : kEmptyId;
    }
    return;
  }
  // each warp writes the lists of queries 8 * warp .. + 7
  __syncwarp();
  for (int r = warp * 8; r < min(cnt, warp * 8 + 8); ++r) {
    const size_t o = (size_t)qbase[r] * k;
    for (int e = lane; e < k; e += 32) {
      a.pd[o + e] = Ld[r * k + e];
      a.pi[o + e] = Li[r * k + e];
    }
  }
}

// Walks the launch's items; `rows_of(j, lid)` is step j's (m, d) rows.
template <typename XT, typename RowsOf>
__device__ __forceinline__ void scan_items(const ScanArgs& a,
                                           RowsOf rows_of) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long first = a.item_off[a.begin], last = a.item_off[a.end];
  for (long long it = first + blockIdx.x; it < last; it += gridDim.x) {
    // the step s of [begin, end) with item_off[s] <= it < item_off[s + 1]
    int lo = a.begin, hi = a.end - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.item_off[mid] <= it)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int j = a.order ? (int)a.order[lo] : lo;
    const int t = (int)(it - a.item_off[lo]);
    const int cnt_all = a.offs[j + 1] - a.offs[j];
    const int ngr = (cnt_all + kQT - 1) / kQT;
    const int chunk = t / ngr, g = t - chunk * ngr;
    const int r0 = chunk * kChunkRows;
    const int lid = a.uniq[j];
    scan_item<XT>(a, rows_of(j, lid), lid, j, a.offs[j] + g * kQT,
                  min(kQT, cnt_all - g * kQT), chunk, r0,
                  min(kChunkRows, a.live[j] - r0), smem_raw);
  }
}

// The seed bound of each query: the k-th smallest (distance, id) pair of
// the first kSeedRows rows of one list it probes (seed_step[row], a union
// step, -1 for none), scored as a one-query item of this body (the same
// fmaf chain in column order, the same epilog). Every pair in the query's
// final top-k is at most this bound, since k scored candidates reach it;
// the items drop the candidates past it before any insertion, and the
// result is the same. (+inf, kEmptyId), no bound, where the seed list
// holds fewer than k live rows or none was given. A block walks queries
// blockIdx.x, + gridDim.x, ...
constexpr int kSeedRows = kChunkRows;

template <typename XT, typename RowsOf>
__device__ __forceinline__ void seed_bounds(const ScanArgs& a, int q,
                                            const int* __restrict__ seed_step,
                                            float* __restrict__ out_d,
                                            int* __restrict__ out_i,
                                            RowsOf rows_of) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (int row = blockIdx.x; row < q; row += gridDim.x) {
    const int j = seed_step[row];  // block-uniform
    if (j < 0) {
      if (threadIdx.x == 0) {
        out_d[row] = CUDART_INF_F;
        out_i[row] = kEmptyId;
      }
      continue;
    }
    const int lid = a.uniq[j];
    scan_item<XT>(a, rows_of(j, lid), lid, j, 0, 1, 0, 0,
                  min(kSeedRows, a.live[j]), smem_raw, row, out_d, out_i);
  }
}

// Blocks of a scan launch: enough to fill the card, never more than the
// items can use.
template <typename Kernel>
inline cudaError_t scan_grid(Kernel kernel, size_t smem, long long items,
                             int* blocks) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long full = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(items < full ? items : full);
  return cudaSuccess;
}

}  // namespace raft_tpu_torch
