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
// The answer depends on the order of the walk (the threshold tightens
// from list to list), so one block owns one query and walks its lists
// serially; the rows of a list are estimated in parallel by the block's
// threads, the survivors are reranked one warp each (coalesced reads of
// the raw row), and warp 0 inserts them into the shared-memory list with
// the warp insertion of topk_common.cuh. A list is estimated in chunks of
// kChunk rows, all against the threshold of the list's start, so the
// survivor buffer stays small whatever the list size.
//
// Float semantics follow the plain version op for op (`__fadd_rn` and
// friends keep the compiler from contracting to FMAs): the query's lo/hi
// are exact min/max, rintf rounds half to even as torch.round does, and
// every sum the prune reads (|q|^2, sum(q~^2), <Rq, Rc>, the exact dot
// products) is `warp_tree_dot`'s halving tree over rounded products,
// which is ops/bq_scan.tree_sum's order. So the prune decides as the
// plain version does, bit for bit, and the survivor counts are equal.
// The query side and the per-row estimate live in bq_estimate.cuh,
// shared with beam_search.cu.
//
// Bound on the H100: per query, the code words and corrections of its
// probed lists (read from L2 when many queries share a list), integer
// popcount work per row, and the raw vector of each survivor only. At
// small batches most SMs idle: one block per query.
#include "bq_estimate.cuh"

namespace raft_tpu_torch {

constexpr int kChunk = 1024;        // rows estimated between two merges

// C: lanes per thread of the tree sums, dim_ext <= 32 * C
template <int C>
__global__ void __launch_bounds__(kBqThreads) bq_scan_kernel(
    const float* __restrict__ Q, const float* __restrict__ Qrot,
    const float* __restrict__ Crot, const int* __restrict__ codes,
    const float* __restrict__ rnorm, const float* __restrict__ cfac,
    const float* __restrict__ errw, const float* __restrict__ data,
    const float* __restrict__ norms, const int* __restrict__ ids_g,
    const int* __restrict__ uniq, const int* __restrict__ upos, int p, int d,
    int de, int m, int bits, int qbits, int k, int ip_metric, float eps2,
    float* __restrict__ outd, int* __restrict__ outi,
    int* __restrict__ surv) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = de >> 5, words = bits * W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qf = reinterpret_cast<float*>(smem_raw);  // d
  float* qr = qf + d;                              // de
  float* qt = qr + de;                             // de
  float* ld = qt + de;                             // k
  float* cd = ld + k;                              // kChunk
  float* red = cd + kChunk;                        // kBqWarps
  int* li = reinterpret_cast<int*>(red + kBqWarps);  // k
  int* cidx = li + k;                                // kChunk
  int* uw = cidx + kChunk;                           // kMaxQueryBits * W
  __shared__ int ncand;
  __shared__ float sums[2];  // warp 0's tree sums, read by the block

  for (int t = tid; t < d; t += kBqThreads) qf[t] = Q[(size_t)row * d + t];
  for (int t = tid; t < de; t += kBqThreads)
    qr[t] = Qrot[(size_t)row * de + t];
  init_lists(ld, li, k);
  __syncthreads();
  if (warp == 0) {
    const float s = warp_tree_dot<C>(qf, qf, d, lane);
    if (lane == 0) sums[0] = s;
  }
  __syncthreads();
  const float qn = sums[0];
  int survivors = 0;

  for (int s = 0; s < p; ++s) {
    const int j = upos[(size_t)row * p + s];
    if (j < 0) continue;  // block-uniform: sentinel or repeated probe
    const size_t lid = (size_t)uniq[j];
    const float* crot = Crot + lid * de;

    // ---- the query side of this list: q~, lo/hi, |q~|^2, <Rq, Rc>
    const BqQuery bq = bq_query_side<C>(qr, crot, qt, uw, red, sums, de,
                                        qbits, ip_metric);
    const float kth = ld[k - 1];  // the threshold of the whole list
    const float* list_rn = rnorm + lid * m;
    const float* list_ew = errw + lid * m;
    const float* list_cf = cfac + lid * m * bits;
    const int* list_codes = codes + lid * m * words;
    const int* list_ids = ids_g + (size_t)j * m;

    for (int m0 = 0; m0 < m; m0 += kChunk) {
      const int m1 = min(m, m0 + kChunk);
      if (tid == 0) ncand = 0;
      __syncthreads();
      // ---- estimate and prune
      for (int r = m0 + tid; r < m1; r += kBqThreads) {
        if (list_ids[r] < 0) continue;  // padding or filtered
        const float lb = bq_lower_bound(
            list_codes + (size_t)r * words, list_cf + (size_t)r * bits,
            list_rn[r], list_ew[r], uw, W, bits, qbits, de, bq, ip_metric,
            eps2);
        if (lb < kth) cidx[atomicAdd(&ncand, 1)] = r;
      }
      __syncthreads();
      const int nc = ncand;
      // ---- exact rerank of the survivors, one warp per row
      for (int c = warp; c < nc; c += kBqWarps) {
        const int r = cidx[c];
        const float acc =
            warp_tree_dot<C>(qf, data + (lid * m + r) * d, d, lane);
        if (lane == 0)
          cd[c] = ip_metric
                      ? -acc
                      : fmaxf(__fsub_rn(__fadd_rn(qn, norms[lid * m + r]),
                                        __fmul_rn(2.f, acc)),
                              0.f);
      }
      __syncthreads();
      // ---- merge into the running top-k
      if (warp == 0) {
        for (int c0 = 0; c0 < nc; c0 += 32) {
          const int c = c0 + lane;
          const bool in = c < nc;
          const float v = in ? cd[c] : CUDART_INF_F;
          const int id = in ? list_ids[cidx[c]] : kEmptyId;
          warp_insert(ld, li, k, v, id, in && v < CUDART_INF_F);
        }
      }
      survivors += nc;
      __syncthreads();
    }
  }

  for (int t = tid; t < k; t += kBqThreads) {
    const float v = ld[t];
    const bool filled = v < CUDART_INF_F;
    outd[(size_t)row * k + t] = ip_metric ? -v : v;
    outi[(size_t)row * k + t] = filled ? li[t] : -1;
  }
  if (tid == 0) surv[row] = survivors;
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. Q (q, d), Qrot (q, de), Crot (n_lists, de)
// f32; codes (n_lists, m, bits * de / 32) int32; rnorm/errw (n_lists, m),
// cfac (n_lists, m, bits), data (n_lists, m, d), norms (n_lists, m) f32;
// ids_g (cap, m) int32 id planes of the probed-list union uniq (cap,);
// upos (q, p) each query's probes sorted by list id as positions into
// uniq, -1 to skip; eps2 = 2 * epsilon; outd/outi (q, k), surv (q,).
// d <= de <= 1024. Returns cudaError_t.
extern "C" int raft_bq_scan(const void* Q, const void* Qrot, const void* Crot,
                            const void* codes, const void* rnorm,
                            const void* cfac, const void* errw,
                            const void* data, const void* norms,
                            const void* ids_g, const void* uniq,
                            const void* upos, int q, int p, int d, int de,
                            int m, int bits, int qbits, int k, int ip_metric,
                            float eps2, void* outd, void* outi, void* surv,
                            void* stream) {
  if (qbits < 1 || qbits > kMaxQueryBits || de % 32 != 0 || k < 1 ||
      k > 128 || d > de || de > 1024)
    return (int)cudaErrorInvalidValue;
  int c = 1;
  while (32 * c < de) c *= 2;
  auto kernel = c == 1    ? bq_scan_kernel<1>
                : c == 2  ? bq_scan_kernel<2>
                : c == 4  ? bq_scan_kernel<4>
                : c == 8  ? bq_scan_kernel<8>
                : c == 16 ? bq_scan_kernel<16>
                          : bq_scan_kernel<32>;
  const size_t smem =
      (size_t)(d + 2 * de + k + kChunk + kBqWarps) * sizeof(float) +
      (size_t)(k + kChunk + kMaxQueryBits * (de / 32)) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (q == 0) return (int)cudaSuccess;
  kernel<<<q, kBqThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)Q, (const float*)Qrot, (const float*)Crot,
      (const int*)codes, (const float*)rnorm, (const float*)cfac,
      (const float*)errw, (const float*)data, (const float*)norms,
      (const int*)ids_g, (const int*)uniq, (const int*)upos, p, d, de, m,
      bits, qbits, k, ip_metric, eps2, (float*)outd, (int*)outi, (int*)surv);
  return (int)cudaGetLastError();
}
