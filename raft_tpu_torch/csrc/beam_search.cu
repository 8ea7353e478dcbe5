// One-launch CAGRA beam search: the Hopper port of the JAX package's
// `_beam_kernel` (raft_tpu/ops/beam_search.py), in the role of the
// reference's single-CTA search kernel (search_single_cta_kernel-inl.cuh),
// here a thread block cluster per query.
//
// What it computes, per query: the itopk buffer of L entries (distance,
// id, explored), kept sorted by (distance, id), starts as (+inf, -1, 0);
// the seeds merge in C = w * deg wide chunks, in order; then each
// iteration
//   1. takes as parents the first w unexplored entries of the buffer
//      (its w smallest unexplored (distance, id) pairs: it is sorted),
//      one warp ballot per 32 entries, and marks them explored; a query
//      with none left, or past its row_iters budget, stops: its further
//      iterations would change nothing;
//   2. reads the parents' adjacency rows from the graph (global memory)
//      as the C candidates, -1 past the valid parents;
//   3. drops a candidate equal to a live buffer id or an earlier
//      candidate, through an open-addressing hash table in shared memory
//      built each round from the live buffer's ids and the round's
//      candidates (a buffer id keeps the mark -1, a candidate id the
//      smallest index that holds it): exactly what the linear scans of
//      the buffer and the earlier candidates dropped, in O(L + C) work
//      instead of O(C * L + C^2);
//   4. BQ traversal only: estimates each remaining candidate from its
//      packed record (bq_estimate.cuh) and keeps it when est - margin
//      beats the buffer's L-th distance;
//   5. scores the kept candidates exactly: <q, x> and |x|^2 as
//      warp_tree_dot's halving tree over rounded products
//      (ops/bq_scan.tree_sum's order), then max((|x|^2 - 2 <q, x>) +
//      |q|^2, 0), or -<q, x> for IP. A warp takes R rows at a time and
//      issues all of their loads before any arithmetic, so R row gathers
//      are in flight a warp (R * C values a lane: the rows are read once
//      and need no staging in shared memory);
//   6. merges: the scored candidates that beat the buffer's L-th entry
//      are sorted by a bitonic sort in shared memory, and each entry's
//      place in the new buffer is its own index plus a binary search in
//      the other sorted list (both lists hold distinct ids).
// The walk's state lives in the cluster's first CTA (the leader), which
// does steps 1-4 and 6. Step 5 is split over the cluster: each CTA's warps
// take their share of the kept rows, read the leader's candidates through
// distributed shared memory and write the distances into it; two cluster
// barriers a round order the phases. The wrapper sizes the cluster as
// bq_scan's walk does (ops/beam_search.beam_cluster_size): a small batch
// spreads each query's scoring over up to 16 SMs, a batch that fills the
// card keeps one CTA a query.
// Every float step is a `__f*_rn` intrinsic in the plain version's order
// (ops/beam_search.beam_search_plain), so ids and distances equal its
// bit for bit at every cluster size: a one-ulp difference would re-route
// the walk.
//
// Bound on the H100: per query, the rows it scores and the adjacency rows
// of its parents, both gathered from global memory (through L2: rows of
// a neighbourhood are read by many queries), and 4d float32 operations
// per scored row. The walk is serial per query: each round waits on its
// parents' graph rows, then on its candidates' rows.
#include <cooperative_groups.h>
#include <stdint.h>

#include "bq_estimate.cuh"

namespace cg = cooperative_groups;

namespace raft_tpu_torch {

constexpr int kMaxL = 512;   // itopk buffer
constexpr int kMaxC = 256;   // candidates per round (= threads per block)
constexpr int kBeamCtasPerSm = 4;  // resident CTAs an SM (launch bound)
constexpr int kMaxCluster = 16;    // the largest (non-portable) cluster
constexpr int kHashEmpty = -1;     // an empty hash slot (ids are >= 0)

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// rows a warp scores at once: R * C values a lane in flight
template <int C>
__host__ __device__ constexpr int rows_per_warp() {
  return C >= 16 ? 1 : 16 / C;
}

// A row's n values, C a lane (lane + 32 c), widened exactly; 0 past n.
template <int C, typename XT>
__device__ __forceinline__ void load_row(const XT* __restrict__ x, int n,
                                         int lane, float (&xv)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = lane + 32 * c;
    xv[c] = e < n ? to_f32(x[e]) : 0.f;
  }
}

// <q, x> and |x|^2 of one loaded row by one warp, each as warp_tree_dot's
// tree over rounded products. Every lane gets both.
template <int C>
__device__ __forceinline__ void tree_dot2(const float* q, const float (&xv)[C],
                                          int n, int lane, float& ip,
                                          float& rn) {
  float v[C], u[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = lane + 32 * c;
    const float qv = e < n ? q[e] : 0.f;
    v[c] = __fmul_rn(qv, xv[c]);
    u[c] = __fmul_rn(xv[c], xv[c]);
  }
#pragma unroll
  for (int h = C / 2; h >= 1; h >>= 1)
#pragma unroll
    for (int c = 0; c < h; ++c) {
      v[c] = __fadd_rn(v[c], v[c + h]);
      u[c] = __fadd_rn(u[c], u[c + h]);
    }
  float s = v[0], t = u[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
    t = __fadd_rn(t, __shfl_xor_sync(kFull, t, o));
  }
  ip = s;
  rn = t;
}

__device__ __forceinline__ unsigned hash_slot(int key, unsigned mask) {
  return ((unsigned)key * 2654435761u) & mask;
}

// Record `key` with value v in the open-addressing table: the slot keeps
// the smallest value recorded for its key.
__device__ __forceinline__ void hash_put(int* hkey, int* hval, unsigned mask,
                                         int key, int v) {
  unsigned h = hash_slot(key, mask);
  while (true) {
    const int prev = atomicCAS(hkey + h, kHashEmpty, key);
    if (prev == kHashEmpty || prev == key) {
      atomicMin(hval + h, v);
      return;
    }
    h = (h + 1) & mask;
  }
}

// The value recorded for a key that is in the table.
__device__ __forceinline__ int hash_get(const int* hkey, const int* hval,
                                        unsigned mask, int key) {
  unsigned h = hash_slot(key, mask);
  while (hkey[h] != key) h = (h + 1) & mask;
  return hval[h];
}

struct BeamArgs {
  const float* Q;        // (q, d)
  const void* X;         // (n, d) float32 / bfloat16 / int8
  const int* G;          // (n, gw), the first deg of each row used
  int gw, deg;
  const int* seeds;      // (q, S), S a multiple of w * deg
  int S;
  const int* row_iters;  // (q,)
  int d, k, L, w, max_iters, ip_metric;
  const int* recs;       // (n_pad, rec_pad) records, or null: no BQ
  int rec_pad, words, bits, qbits, de;
  const float* Qrot;     // (q, de)
  const float* Crot;     // (de,)
  float eps2;
  int hsize;             // hash slots, a power of two >= 2 (L + C)
  float* outd;           // (q, k)
  int* outi;             // (q, k)
  int* counts;           // (q, 3): live iterations, fresh, scored
};

// C: lanes per thread of the tree sums, max(d, de) <= 32 * C. One cluster
// walks one query: blockIdx.x / cluster size is the query.
template <typename XT, int C>
__global__ void __launch_bounds__(kBqThreads, kBeamCtasPerSm)
    beam_kernel(const BeamArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool leader = rank == 0;
  const int row = blockIdx.x / nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = a.d, L = a.L, de = a.de;
  const int CW = a.w * a.deg;
  const bool use_bq = a.recs != nullptr;
  const XT* __restrict__ X = static_cast<const XT*>(a.X);
  const unsigned hmask = (unsigned)a.hsize - 1u;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qf = reinterpret_cast<float*>(smem_raw);   // d
  float* bd = qf + d;                               // L: buffer distances
  float* nbd = bd + L;                              // L: next buffer
  int* bi = reinterpret_cast<int*>(nbd + L);        // L: buffer ids
  int* nbi = bi + L;                                // L
  int* be = nbi + L;                                // L: explored flags
  int* nbe = be + L;                                // L
  int* cand = nbe + L;                              // kMaxC candidates
  float* cd = reinterpret_cast<float*>(cand + kMaxC);  // kMaxC distances
  int* slist = reinterpret_cast<int*>(cd + kMaxC);  // kMaxC rows to score
  float* kd = reinterpret_cast<float*>(slist + kMaxC);  // kMaxC kept
  int* ki = reinterpret_cast<int*>(kd + kMaxC);     // kMaxC kept ids
  int* par = ki + kMaxC;                            // kMaxC parent slots
  int* hkey = par + kMaxC;                          // hsize
  int* hval = hkey + a.hsize;                       // hsize
  float* red = reinterpret_cast<float*>(hval + a.hsize);  // kBqWarps
  float* qr = red + kBqWarps;                       // de (BQ only)
  float* qt = qr + de;                              // de
  int* uw = reinterpret_cast<int*>(qt + de);        // kMaxQueryBits * de/32
  __shared__ int s_nlive, s_np, s_nscore, s_nk, s_fresh, s_scored, s_done;
  __shared__ float sums[2];

  for (int t = tid; t < d; t += kBqThreads) qf[t] = a.Q[(size_t)row * d + t];
  if (leader) {
    for (int t = tid; t < L; t += kBqThreads) {
      bd[t] = CUDART_INF_F;
      bi[t] = -1;
      be[t] = 0;
    }
    if (use_bq)
      for (int t = tid; t < de; t += kBqThreads)
        qr[t] = a.Qrot[(size_t)row * de + t];
    if (tid == 0) {
      s_nlive = s_nscore = s_nk = s_fresh = s_scored = s_done = 0;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const float s = warp_tree_dot<C>(qf, qf, d, lane);
    if (lane == 0) sums[0] = s;
  }
  __syncthreads();
  const float qn = sums[0];
  __syncthreads();  // sums is scratch of the query side below
  BqQuery bq = {};
  if (leader && use_bq)
    bq = bq_query_side<C>(qr, a.Crot, qt, uw, red, sums, de, a.qbits,
                          a.ip_metric);
  const int W = de >> 5;
  // the leader's round state, read and written by every CTA
  const int* l_cand = cluster.map_shared_rank(cand, 0);
  const int* l_slist = cluster.map_shared_rank(slist, 0);
  float* l_cd = cluster.map_shared_rank(cd, 0);
  const int* l_nscore = cluster.map_shared_rank(&s_nscore, 0);
  const int* l_done = cluster.map_shared_rank(&s_done, 0);
  // the barrier between a round's phases: the cluster's, or the block's
  // alone when the cluster is one CTA
  auto round_sync = [&]() {
    if (nc == 1)
      __syncthreads();
    else
      cluster.sync();
  };

  // Step 5 on every CTA: this CTA's warps score their share of the
  // leader's kept rows, R a warp at a time, into the leader's cd.
  auto score_share = [&]() {
    constexpr int R = rows_per_warp<C>();
    const int ns = *l_nscore;
    const int stride = nc * kBqWarps * R;
    for (int base = (rank * kBqWarps + warp) * R; base < ns;
         base += stride) {
      int cidx[R];
      float xv[R][C];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = base + r;
        cidx[r] = s < ns ? l_slist[s] : -1;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int id = cidx[r] >= 0 ? l_cand[cidx[r]] : 0;
        load_row<C>(X + (size_t)id * d, cidx[r] >= 0 ? d : 0, lane, xv[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (cidx[r] < 0) continue;  // warp-uniform
        float ip, rn;
        tree_dot2<C>(qf, xv[r], d, lane, ip, rn);
        if (lane == 0)
          l_cd[cidx[r]] =
              a.ip_metric
                  ? -ip
                  : fmaxf(__fadd_rn(__fsub_rn(rn, __fmul_rn(2.f, ip)), qn),
                          0.f);
      }
    }
  };

  // The leader: dedup, prune and list cand[0..CW) for scoring; then the
  // cluster scores; then the leader merges into the buffer.
  auto process = [&]() {
    const int nlive = s_nlive;  // buffer entries [0, nlive) are finite
    const float kth_d = bd[L - 1];
    const int kth_i = bi[L - 1];
    for (int t = tid; t < a.hsize; t += kBqThreads) {
      hkey[t] = kHashEmpty;
      hval[t] = 0x7fffffff;
    }
    __syncthreads();
    for (int i = tid; i < nlive; i += kBqThreads)
      hash_put(hkey, hval, hmask, bi[i], -1);
    if (tid < CW && cand[tid] >= 0)
      hash_put(hkey, hval, hmask, cand[tid], tid);
    __syncthreads();
    {
      const bool in = tid < CW;
      const int id = in ? cand[tid] : -1;
      const bool fresh =
          id >= 0 && hash_get(hkey, hval, hmask, id) == tid;
      bool score = fresh;
      if (fresh && use_bq) {
        const int* rec = a.recs + (size_t)id * a.rec_pad;
        score = bq_lower_bound(
                    rec, reinterpret_cast<const float*>(rec + a.words + 1),
                    __int_as_float(rec[a.words]),
                    __int_as_float(rec[a.words + 1 + a.bits]), uw, W, a.bits,
                    a.qbits, de, bq, a.ip_metric, a.eps2) < kth_d;
      }
      if (in) cd[tid] = CUDART_INF_F;
      // counts and the list of rows to score: one atomic a warp
      const unsigned fm = __ballot_sync(kFull, fresh);
      const unsigned sm = __ballot_sync(kFull, score);
      int base = 0;
      if (lane == 0) {
        if (fm) atomicAdd(&s_fresh, __popc(fm));
        if (sm) {
          atomicAdd(&s_scored, __popc(sm));
          base = atomicAdd(&s_nscore, __popc(sm));
        }
      }
      base = __shfl_sync(kFull, base, 0);
      if (score) slist[base + __popc(sm & ((1u << lane) - 1u))] = tid;
    }
    round_sync();  // [A] the round's rows to score are listed
    score_share();
    round_sync();  // [B] every kept row is scored
    if (tid == 0) s_nscore = 0;
    // only a candidate that beats the buffer's L-th entry can enter
    {
      const bool in = tid < CW;
      const float v = in ? cd[tid] : CUDART_INF_F;
      const bool keep = v < CUDART_INF_F && lex_less(v, cand[tid], kth_d,
                                                     kth_i);
      const unsigned km = __ballot_sync(kFull, keep);
      int base = 0;
      if (lane == 0 && km) base = atomicAdd(&s_nk, __popc(km));
      base = __shfl_sync(kFull, base, 0);
      if (keep) {
        const int p = base + __popc(km & ((1u << lane) - 1u));
        kd[p] = v;
        ki[p] = cand[tid];
      }
    }
    __syncthreads();
    const int nk = s_nk;
    if (nk > 0) {
      int P = 1;
      while (P < nk) P <<= 1;
      for (int t = nk + tid; t < P; t += kBqThreads) {
        kd[t] = CUDART_INF_F;
        ki[t] = kEmptyId;
      }
      __syncthreads();
      // bitonic sort of the kept candidates by (distance, id)
      for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int t = tid; t < P / 2; t += kBqThreads) {
            const int i = 2 * t - (t & (stride - 1));
            const int j = i + stride;
            const float x = kd[i], y = kd[j];
            const int xi = ki[i], yi = ki[j];
            const bool up = (i & size) == 0;
            if (up ? lex_less(y, yi, x, xi) : lex_less(x, xi, y, yi)) {
              kd[i] = y;
              ki[i] = yi;
              kd[j] = x;
              ki[j] = xi;
            }
          }
          __syncthreads();
        }
      }
      // merge of two sorted lists of distinct (distance, id) pairs: each
      // entry lands at its index plus its rank in the other list
      for (int i = tid; i < nlive; i += kBqThreads) {
        const float v = bd[i];
        const int id = bi[i];
        int lo = 0, hi = nk;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (lex_less(kd[mid], ki[mid], v, id))
            lo = mid + 1;
          else
            hi = mid;
        }
        const int r = i + lo;
        if (r < L) {
          nbd[r] = v;
          nbi[r] = id;
          nbe[r] = be[i];
        }
      }
      for (int j = tid; j < nk; j += kBqThreads) {
        const float v = kd[j];
        const int id = ki[j];
        int lo = 0, hi = nlive;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (lex_less(bd[mid], bi[mid], v, id))
            lo = mid + 1;
          else
            hi = mid;
        }
        const int r = j + lo;
        if (r < L) {
          nbd[r] = v;
          nbi[r] = id;
          nbe[r] = 0;
        }
      }
      const int live = min(nlive + nk, L);
      for (int p = live + tid; p < L; p += kBqThreads) {
        nbd[p] = CUDART_INF_F;
        nbi[p] = -1;
        nbe[p] = 0;
      }
      __syncthreads();
      float* tf = bd;
      bd = nbd;
      nbd = tf;
      int* ti = bi;
      bi = nbi;
      nbi = ti;
      ti = be;
      be = nbe;
      nbe = ti;
      if (tid == 0) s_nlive = live;
    }
    if (tid == 0) s_nk = 0;
    __syncthreads();
  };

  if (!leader) {
    // the other CTAs score each round the leader lists, until it is done
    while (true) {
      round_sync();  // [A]
      if (*l_done) break;
      score_share();
      round_sync();  // [B]
    }
  } else {
    // ---- seed rounds, C-wide chunks in order
    for (int c0 = 0; c0 < a.S; c0 += CW) {
      for (int t = tid; t < CW; t += kBqThreads)
        cand[t] = a.seeds[(size_t)row * a.S + c0 + t];
      __syncthreads();
      process();
    }

    // ---- the walk
    const int budget = min(a.row_iters[row], a.max_iters);
    int iters = 0;
    for (int it = 0; it < budget; ++it) {
      if (warp == 0) {
        const int nlive = s_nlive;
        int found = 0;
        for (int base = 0; base < nlive && found < a.w; base += 32) {
          const int i = base + lane;
          const bool ok = i < nlive && be[i] == 0;
          const unsigned m = __ballot_sync(kFull, ok);
          const int before = __popc(m & ((1u << lane) - 1u));
          if (ok && found + before < a.w) {
            par[found + before] = i;
            be[i] = 1;
          }
          found += __popc(m);
        }
        if (lane == 0) s_np = min(found, a.w);
      }
      __syncthreads();
      const int np = s_np;
      if (np == 0) break;  // nothing left to expand: the rest are no-ops
      ++iters;
      for (int t = tid; t < CW; t += kBqThreads) {
        const int j = t / a.deg, e = t - j * a.deg;
        cand[t] = j < np ? a.G[(size_t)bi[par[j]] * a.gw + e] : -1;
      }
      __syncthreads();
      process();
    }

    for (int t = tid; t < a.k; t += kBqThreads) {
      const float v = bd[t];
      a.outd[(size_t)row * a.k + t] = v;
      a.outi[(size_t)row * a.k + t] = v < CUDART_INF_F ? bi[t] : -1;
    }
    if (tid == 0) {
      a.counts[(size_t)row * 3] = iters;
      a.counts[(size_t)row * 3 + 1] = s_fresh;
      a.counts[(size_t)row * 3 + 2] = s_scored;
      s_done = 1;
    }
    round_sync();  // [A] of no round: the other CTAs read s_done
  }
  round_sync();  // no CTA leaves while another may read its memory
}

template <typename XT, int C>
cudaError_t launch(const BeamArgs& a, int q, size_t smem, int cluster,
                   int* cluster_used, cudaStream_t stream) {
  auto kernel = beam_kernel<XT, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kBqThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the largest cluster size, from the requested one down, that the card
  // can schedule (a size, never another engine)
  int c = cluster;
  for (; c > 1; c /= 2) {
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c, 1, 1);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) ==
            cudaSuccess &&
        active > 0)
      break;
    cudaGetLastError();  // a refused size is not an error of the call
  }
  *cluster_used = c;
  if (q == 0) return cudaSuccess;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(q * c), 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_lanes(int c, const BeamArgs& a, int q, size_t smem,
                         int cluster, int* cluster_used,
                         cudaStream_t stream) {
  switch (c) {
    case 1: return launch<XT, 1>(a, q, smem, cluster, cluster_used, stream);
    case 2: return launch<XT, 2>(a, q, smem, cluster, cluster_used, stream);
    case 4: return launch<XT, 4>(a, q, smem, cluster, cluster_used, stream);
    case 8: return launch<XT, 8>(a, q, smem, cluster, cluster_used, stream);
    case 16:
      return launch<XT, 16>(a, q, smem, cluster, cluster_used, stream);
    default:
      return launch<XT, 32>(a, q, smem, cluster, cluster_used, stream);
  }
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. Q (q, d) f32; X (n, d) of xtype 0 float32,
// 1 bfloat16, 2 int8; G (n, gw) int32, ids < n or -1; seeds (q, S) int32;
// row_iters (q,) int32; recs (ceil(n / rpt) * rpt, rec_pad) int32 or null,
// with Qrot (q, de) and Crot (de,) f32 and eps2 = 2 * epsilon; outd/outi
// (q, k), counts (q, 3); cluster the requested cluster size (1, 2, 4, 8 or
// 16), *cluster_used (host) gets the size launched. L <= 512,
// w * deg <= 256, d <= de <= 1024. Returns cudaError_t.
extern "C" int raft_beam_search(
    const void* Q, const void* X, int xtype, const void* G, int gw, int deg,
    const void* seeds, int S, const void* row_iters, int q, int d, int k,
    int L, int w, int max_iters, int ip_metric, const void* recs, int rec_pad,
    int words, int bits, int qbits, int de, const void* Qrot,
    const void* Crot, float eps2, void* outd, void* outi, void* counts,
    int cluster, int* cluster_used, void* stream) {
  const int cw = w * deg;
  if (L < 1 || L > kMaxL || k < 1 || k > L || w < 1 || deg < 1 ||
      deg > gw || cw > kMaxC || S < cw || S % cw != 0 || d < 1 ||
      d > 1024 || xtype < 0 || xtype > 2 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (recs != nullptr) {
    if (de % 32 != 0 || de < d || de > 1024 || bits < 1 || bits > 8 ||
        qbits < 1 || qbits > kMaxQueryBits || words != bits * de / 32 ||
        rec_pad < words + bits + 2)
      return (int)cudaErrorInvalidValue;
  } else {
    de = 0;
  }
  BeamArgs a;
  a.Q = (const float*)Q;
  a.X = X;
  a.G = (const int*)G;
  a.gw = gw;
  a.deg = deg;
  a.seeds = (const int*)seeds;
  a.S = S;
  a.row_iters = (const int*)row_iters;
  a.d = d;
  a.k = k;
  a.L = L;
  a.w = w;
  a.max_iters = max_iters;
  a.ip_metric = ip_metric;
  a.recs = (const int*)recs;
  a.rec_pad = rec_pad;
  a.words = words;
  a.bits = bits;
  a.qbits = qbits;
  a.de = de;
  a.Qrot = (const float*)Qrot;
  a.Crot = (const float*)Crot;
  a.eps2 = eps2;
  int hs = 64;
  while (hs < 2 * (L + cw)) hs <<= 1;
  a.hsize = hs;
  a.outd = (float*)outd;
  a.outi = (int*)outi;
  a.counts = (int*)counts;
  int c = 1;
  while (32 * c < (d > de ? d : de)) c *= 2;
  const size_t smem =
      (size_t)(d + 6 * L + 6 * kMaxC + 2 * hs + kBqWarps + 2 * de +
               kMaxQueryBits * (de / 32)) * 4;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (xtype) {
    case 0:
      return (int)launch_lanes<float>(c, a, q, smem, cluster, cluster_used,
                                      st);
    case 1:
      return (int)launch_lanes<__nv_bfloat16>(c, a, q, smem, cluster,
                                              cluster_used, st);
    default:
      return (int)launch_lanes<int8_t>(c, a, q, smem, cluster, cluster_used,
                                       st);
  }
}

// The kernel's resident CTAs per SM, for the wrapper's cluster size.
extern "C" int raft_beam_ctas_per_sm() { return kBeamCtasPerSm; }
