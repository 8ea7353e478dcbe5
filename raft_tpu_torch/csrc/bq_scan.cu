// Fused IVF-BQ (RaBitQ) estimate-then-rerank probe scan: the Hopper port
// of the JAX package's `_bq_scan_kernel` (raft_tpu/ops/bq_scan.py, engine
// "pallas").
//
// What it computes, per query: walk the lists the query probed in
// ascending list id (a repeated probe once, sentinel slots never); for
// each list
//   1. quantize the rotated query side q~ = Rq - Rc (L2) or Rq (IP) to
//      2^query_bits - 1 uniform levels and pack its bit-planes into words;
//   2. estimate every row from its sign words by XOR + popcount (exact
//      integers), assemble the estimate and the RaBitQ margin in float32;
//   3. mark survivors: id >= 0 and est - margin < the query's k-th exact
//      distance as it stood at the start of the list;
//   4. rerank the survivors exactly (float32, no TF32) and merge them
//      into the query's running top-k in (distance, smallest id) order.
//
// Why a query's walk is serial: step 3 reads the threshold that the
// merges of the lists before it left, so list s + 1 waits on list s.
// Nothing else does. The query side (step 1) does not read the
// threshold, nor does a row's estimate, and the merge in (distance, id)
// order is a function of the set of survivors, not of their order. So:
//   - bq_query_side_kernel computes the query side of every (query,
//     probed list) pair first, one warp each, all in parallel, into a
//     workspace: the packed bit-planes, lo, delta, |q~|^2, <Rq, Rc> and
//     |q~|, in the same op order as the walk would have (stored floats,
//     not recomputed), so every estimate stays bit-equal;
//   - bq_walk_kernel gives each query a thread block cluster of c CTAs
//     (c from the batch: enough CTAs to fill the card). For each list,
//     every CTA reads the list-start threshold from the leader CTA's
//     shared memory (distributed shared memory), estimates its slice of
//     the list's real rows [0, live) against it, reranks its survivors
//     (a few rows a warp, each over a group of lanes, in the same tree
//     order), keeps those that beat the list-start k-th entry, and the
//     leader merges all CTAs' kept survivors, read through DSMEM 32 at a
//     time, into the running top-k; a cluster barrier, and the next
//     list. Rows past the last live one are never visited. A CTA
//     estimates at most kChunk rows between two merges, so its survivor
//     buffer is bounded whatever the list size.
// Rows reranked per query are the CTAs' survivor counts summed.
//
// Float semantics follow the plain version op for op (`__fadd_rn` and
// friends keep the compiler from contracting to FMAs): the query's lo/hi
// are exact min/max, rintf rounds half to even as torch.round does, and
// every sum the prune reads (|q|^2, sum(q~^2), <Rq, Rc>, the exact dot
// products) is `warp_tree_dot`'s halving tree over rounded products,
// which is ops/bq_scan.tree_sum's order. So the prune decides as the
// plain version does, bit for bit, and the survivor counts are equal.
// The per-row estimate lives in bq_estimate.cuh, shared with
// beam_search.cu; the warp-wide query side here is this kernel's own.
//
// Bound on the H100: integer popcount throughput, one __popc per code
// word and query bit-plane of every (query, probed row) pair (16 a clock
// per SM; PERF.md: 0.60 ms at n_probes 128, batch 500), and the bytes of
// the union's code rows and of the survivors' raw rows. What the walk
// adds on top is its serial chain: per list, a threshold read, the
// slice's estimate, the reranks and the leader's merge, spread over c
// SMs instead of one.
#include <cooperative_groups.h>

#include "bq_estimate.cuh"

namespace cg = cooperative_groups;

namespace raft_tpu_torch {

constexpr int kChunk = 2048;      // rows a CTA estimates between merges
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster
constexpr int kSide = 5;          // lo, delta, qc2c, base_ip, qcn
// walk CTAs resident per SM (at most 64 registers a thread): the count
// ops/bq_scan.bq_cluster_size plans the card's CTAs with, exported by
// raft_bq_walk_ctas_per_sm()
constexpr int kWalkCtasPerSm = 4;

// sum over the lanes of v[c] (lane l holds element l + 32 c), in
// warp_tree_dot's order: halvings over c in registers, then the warp
template <int C>
__device__ __forceinline__ float warp_tree_sum(float v[C]) {
#pragma unroll
  for (int h = C / 2; h >= 1; h >>= 1)
#pragma unroll
    for (int c = 0; c < h; ++c) v[c] = __fadd_rn(v[c], v[c + h]);
  float s = v[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// sum_e a[e] * b[e] over e < n by a group of G lanes of a warp (G a power
// of two dividing 32), each lane holding the CE = 32 C / G elements
// e = j + G c of its group lane j: the same halving tree over the same
// 32 C zero-padded rounded products as warp_tree_dot (halvings over c in
// registers, then over the group's lanes), so the same sum, bit for bit.
// Every lane of the warp calls it; lane j = 0 of a group gets the sum.
template <int C, int G>
__device__ __forceinline__ float group_tree_dot(const float* a,
                                                const float* b, int n,
                                                int j) {
  constexpr int CE = 32 * C / G;
  float v[CE];
#pragma unroll
  for (int c = 0; c < CE; ++c) {
    const int e = j + G * c;
    v[c] = e < n ? __fmul_rn(a[e], b[e]) : 0.f;
  }
#pragma unroll
  for (int h = CE / 2; h >= 1; h >>= 1)
#pragma unroll
    for (int c = 0; c < h; ++c) v[c] = __fadd_rn(v[c], v[c + h]);
  float s = v[0];
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// lanes a survivor's rerank takes: up to 16 elements a lane
template <int C>
__host__ __device__ constexpr int rerank_lanes() {
  return C <= 4 ? 8 : (C == 8 ? 16 : 32);
}

// The query side of pair = row * p + s, against the list uniq[upos[pair]]
// (skipped where upos is -1), by one warp: bq_query_side's values,
// bit for bit, from registers. words: qbits * W packed bit-planes.
template <int C>
__global__ void __launch_bounds__(kBqThreads) bq_query_side_kernel(
    const float* __restrict__ Qrot, const float* __restrict__ Crot,
    const int* __restrict__ uniq, const int* __restrict__ upos,
    int n_pairs, int p, int de, int qbits, int ip_metric,
    int* __restrict__ side_words, float* __restrict__ side_scal) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kBqWarps + warp;
  if (pair >= n_pairs) return;  // warp-uniform
  const int j = upos[pair];
  if (j < 0) return;
  const float* qr = Qrot + (size_t)(pair / p) * de;
  const float* crot = Crot + (size_t)uniq[j] * de;
  const int W = de >> 5;
  const int levels = (1 << qbits) - 1;
  float qt[C], v[C], w[C];
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = lane + 32 * c;
    qt[c] = 0.f;
    v[c] = 0.f;
    w[c] = 0.f;
    if (e < de) {
      const float r = qr[e], cr = crot[e];
      qt[c] = ip_metric ? r : __fsub_rn(r, cr);
      lo = fminf(lo, qt[c]);
      hi = fmaxf(hi, qt[c]);
      v[c] = __fmul_rn(qt[c], qt[c]);
      w[c] = __fmul_rn(r, cr);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const float s2 = warp_tree_sum<C>(v);
  const float sip = ip_metric ? warp_tree_sum<C>(w) : 0.f;
  const float delta =
      fmaxf(__fdiv_rn(__fsub_rn(hi, lo), (float)levels), 1e-30f);
  int* words = side_words + (size_t)pair * qbits * W;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= W) break;  // warp-uniform: word c holds elements 32c .. 32c+31
    const float x = rintf(__fdiv_rn(__fsub_rn(qt[c], lo), delta));
    const int u = (int)fminf(fmaxf(x, 0.f), (float)levels);
    for (int jb = 0; jb < qbits; ++jb) {
      const unsigned b = __ballot_sync(kFull, (u >> jb) & 1);
      if (lane == 0) words[jb * W + c] = (int)b;
    }
  }
  if (lane == 0) {
    float* sc = side_scal + (size_t)pair * kSide;
    sc[0] = lo;
    sc[1] = delta;
    sc[2] = fmaxf(s2, 0.f);
    sc[3] = sip;
    sc[4] = __fsqrt_rn(s2);
  }
}

struct BqWalkArgs {
  const float *Q, *rnorm, *cfac, *errw, *data, *norms;
  const int *codes, *ids_g, *uniq, *upos, *live;
  const int* side_words;
  const float* side_scal;
  int p, d, de, m, bits, qbits, k, ip_metric;
  float eps2;
  float* outd;
  int *outi, *surv;
};

// One cluster walks one query: blockIdx.x / cluster size is the query.
template <int C>
__global__ void __launch_bounds__(kBqThreads, kWalkCtasPerSm) bq_walk_kernel(
    const BqWalkArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = a.d, de = a.de, m = a.m, k = a.k, bits = a.bits;
  const int W = de >> 5, words = bits * W, side_w = a.qbits * W;

  constexpr int G = rerank_lanes<C>(), R = 32 / G;
  const int gi = lane / G, gj = lane % G;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qf = reinterpret_cast<float*>(smem_raw);  // d
  float* ld = qf + d;                              // k
  float* cd = ld + k;                              // kChunk
  int* li = reinterpret_cast<int*>(cd + kChunk);   // k
  int* cidx = li + k;                              // kChunk
  int* cid = cidx + kChunk;                        // kChunk
  int* uw = cid + kChunk;                          // kMaxQueryBits * W
  __shared__ int ncand, nkeep;
  __shared__ float qn_s;

  for (int t = tid; t < d; t += kBqThreads)
    qf[t] = a.Q[(size_t)row * d + t];
  init_lists(ld, li, k);
  __syncthreads();
  if (warp == 0) {
    const float s = warp_tree_dot<C>(qf, qf, d, lane);
    if (lane == 0) qn_s = s;
  }
  cluster.sync();  // every CTA's list is initialized before any remote read
  const float qn = qn_s;
  const float* lead_ld = cluster.map_shared_rank(ld, 0);
  const int* lead_li = cluster.map_shared_rank(li, 0);
  int survivors = 0;

  for (int s = 0; s < a.p; ++s) {
    const size_t pair = (size_t)row * a.p + s;
    const int j = a.upos[pair];
    if (j < 0) continue;  // cluster-uniform: sentinel or repeated probe
    const size_t lid = (size_t)a.uniq[j];
    const int live = a.live[j];
    if (live <= 0) continue;  // cluster-uniform: no live row
    for (int t = tid; t < side_w; t += kBqThreads)
      uw[t] = a.side_words[pair * side_w + t];
    const float* sc = a.side_scal + pair * kSide;
    BqQuery bq;
    bq.lo = sc[0];
    bq.delta = sc[1];
    bq.qc2c = sc[2];
    bq.base_ip = sc[3];
    bq.qcn = sc[4];
    // the threshold of the whole list, and the k-th entry it belongs to
    const float kth = lead_ld[k - 1];
    const int kth_id = lead_li[k - 1];
    const float* list_rn = a.rnorm + lid * m;
    const float* list_ew = a.errw + lid * m;
    const float* list_cf = a.cfac + lid * m * bits;
    const int* list_codes = a.codes + lid * m * words;
    const int* list_ids = a.ids_g + (size_t)j * m;
    // each round: CTA `rank` takes `per` rows of the round's nc * per
    const int per = min(kChunk, (live + nc - 1) / nc);
    for (int base = 0; base < live; base += per * nc) {
      const int r0 = base + rank * per;
      const int r1 = min(live, r0 + per);
      if (tid == 0) ncand = nkeep = 0;
      __syncthreads();  // uw loaded, counts reset
      // ---- estimate and prune this CTA's slice
      for (int r = r0 + tid; r < r1; r += kBqThreads) {
        if (list_ids[r] < 0) continue;  // padding or filtered
        const float lb = bq_lower_bound(
            list_codes + (size_t)r * words, list_cf + (size_t)r * bits,
            list_rn[r], list_ew[r], uw, W, bits, a.qbits, de, bq,
            a.ip_metric, a.eps2);
        if (lb < kth) cidx[atomicAdd(&ncand, 1)] = r;
      }
      __syncthreads();
      const int n = ncand;
      // ---- exact rerank of the survivors, R rows a warp, G lanes a row.
      // One that does not beat the list-start k-th entry can never enter
      // the list (its k-th entry only falls during the list's merges):
      // only the others are kept for the merge
      for (int c0 = warp * R; c0 < n; c0 += kBqWarps * R) {
        const int c = c0 + gi;
        const int r = cidx[min(c, n - 1)];
        const float acc = group_tree_dot<C, G>(
            qf, a.data + (lid * m + r) * d, d, gj);
        if (c < n && gj == 0) {
          const float v =
              a.ip_metric
                  ? -acc
                  : fmaxf(__fsub_rn(__fadd_rn(qn, a.norms[lid * m + r]),
                                    __fmul_rn(2.f, acc)),
                          0.f);
          const int id = list_ids[r];
          if (lex_less(v, id, kth, kth_id)) {
            const int at = atomicAdd(&nkeep, 1);
            cd[at] = v;
            cid[at] = id;
          }
        }
      }
      survivors += n;
      cluster.sync();  // every CTA's kept survivors are written
      // ---- the leader merges the cluster's kept survivors, in any order:
      // the CTAs' counts a lane each, then 32 survivors at a time, each
      // lane reading its own from its CTA's shared memory
      if (rank == 0 && warp == 0) {
        const int cnt =
            lane < nc ? *cluster.map_shared_rank(&nkeep, lane) : 0;
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const int excl = incl - cnt;
        const int total = __shfl_sync(kFull, incl, 31);
        for (int g0 = 0; g0 < total; g0 += 32) {
          const int g = g0 + lane;
          int t = 0;  // the CTA that holds survivor g
          for (int u = 0; u < nc; ++u)
            t += __shfl_sync(kFull, incl, u) <= g;
          t = min(t, nc - 1);
          const int at = g - __shfl_sync(kFull, excl, t);
          const bool in = g < total;
          const float v =
              in ? cluster.map_shared_rank(cd, t)[at] : CUDART_INF_F;
          const int id = in ? cluster.map_shared_rank(cid, t)[at] : kEmptyId;
          warp_insert(ld, li, k, v, id, in && v < CUDART_INF_F);
        }
      }
      cluster.sync();  // the list is merged; the buffers are free again
    }
  }

  if (rank == 0) {
    for (int t = tid; t < k; t += kBqThreads) {
      const float v = ld[t];
      const bool filled = v < CUDART_INF_F;
      a.outd[(size_t)row * k + t] = a.ip_metric ? -v : v;
      a.outi[(size_t)row * k + t] = filled ? li[t] : -1;
    }
  }
  if (tid == 0) atomicAdd(a.surv + row, survivors);
  cluster.sync();  // no CTA leaves while another may read its memory
}

template <int C>
cudaError_t launch_bq(const BqWalkArgs& a, const float* Qrot,
                      const float* Crot, int* side_words, float* side_scal,
                      int q, int cluster, int* cluster_used,
                      cudaStream_t stream) {
  const int n_pairs = q * a.p;
  if (n_pairs > 0) {
    bq_query_side_kernel<C><<<(n_pairs + kBqWarps - 1) / kBqWarps,
                              kBqThreads, 0, stream>>>(
        Qrot, Crot, a.uniq, a.upos, n_pairs, a.p, a.de, a.qbits,
        a.ip_metric, side_words, side_scal);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = bq_walk_kernel<C>;
  const size_t smem =
      (size_t)(a.d + a.k + kChunk) * sizeof(float) +
      (size_t)(a.k + 2 * kChunk + kMaxQueryBits * (a.de / 32)) * sizeof(int);
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

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. Q (q, d), Qrot (q, de), Crot (n_lists, de)
// f32; codes (n_lists, m, bits * de / 32) int32; rnorm/errw (n_lists, m),
// cfac (n_lists, m, bits), data (n_lists, m, d), norms (n_lists, m) f32;
// ids_g (cap, m) int32 id planes of the probed-list union uniq (cap,);
// upos (q, p) each query's probes sorted by list id as positions into
// uniq, -1 to skip; live (cap,) int32 rows up to each union list's last
// live id; side_words (q * p * qbits * de / 32) int32 and side_scal
// (q * p * 5) f32 workspace; eps2 = 2 * epsilon; cluster the requested
// cluster size (1, 2, 4, 8 or 16); outd/outi (q, k), surv (q,) zeroed by
// the caller; *cluster_used (host) gets the size launched. d <= de <=
// 1024. Returns cudaError_t.
extern "C" int raft_bq_scan(const void* Q, const void* Qrot, const void* Crot,
                            const void* codes, const void* rnorm,
                            const void* cfac, const void* errw,
                            const void* data, const void* norms,
                            const void* ids_g, const void* uniq,
                            const void* upos, const void* live,
                            void* side_words, void* side_scal, int q, int p,
                            int d, int de, int m, int bits, int qbits, int k,
                            int ip_metric, int cluster, float eps2,
                            void* outd, void* outi, void* surv,
                            int* cluster_used, void* stream) {
  if (qbits < 1 || qbits > kMaxQueryBits || de % 32 != 0 || k < 1 ||
      k > 128 || d > de || de > 1024 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const BqWalkArgs a{(const float*)Q,     (const float*)rnorm,
                     (const float*)cfac,  (const float*)errw,
                     (const float*)data,  (const float*)norms,
                     (const int*)codes,   (const int*)ids_g,
                     (const int*)uniq,    (const int*)upos,
                     (const int*)live,    (const int*)side_words,
                     (const float*)side_scal,
                     p, d, de, m, bits, qbits, k, ip_metric, eps2,
                     (float*)outd,        (int*)outi,
                     (int*)surv};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int c = 1;
  while (32 * c < de) c *= 2;
  auto go = [&](auto launch) {
    return (int)launch(a, (const float*)Qrot, (const float*)Crot,
                       (int*)side_words, (float*)side_scal, q, cluster,
                       cluster_used, s);
  };
  switch (c) {
    case 1: return go(launch_bq<1>);
    case 2: return go(launch_bq<2>);
    case 4: return go(launch_bq<4>);
    case 8: return go(launch_bq<8>);
    case 16: return go(launch_bq<16>);
    default: return go(launch_bq<32>);
  }
}

// The walk kernel's resident CTAs per SM, for the wrapper's cluster size.
extern "C" int raft_bq_walk_ctas_per_sm() { return kWalkCtasPerSm; }
