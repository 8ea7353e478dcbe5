// IVF-Flat probe scan: the Hopper port of the JAX package's
// `_ivf_scan_kernel` (raft_tpu/ops/ivf_scan.py, engine "pallas"), the TPU
// re-design of the reference's ivf_flat_interleaved_scan.
//
// The TPU kernel walks the probed-list union in order for each query
// tile, scores the whole tile against each list in one GEMM, masks the
// rows of queries that did not probe the list, and carries the running
// top-k across the walk. Here the wrapper first turns the probes into
// (list, query) pairs, grouped by list (CSR over the sorted union); one
// block takes one list and up to 64 of the queries that probed it:
//   1. ivf_scan_partial_kernel: the block runs scan_list_block
//      (ivf_scan_body.cuh, shared with the tiered scan): it gathers its
//      queries' rows, streams the list 64 rows at a time (float32 FMA
//      products through shared memory), computes min-space `norms - 2 ip`
//      (L2) or `-ip` (IP) for rows with id >= 0, and keeps a top-k per
//      query. It writes the list's top-k into the query's probe slot:
//      (q, n_probes, k).
//   2. merge_partials_kernel (topk_common.cuh) merges the probe slots per
//      query in (distance, smallest id) order; IP is negated back.
// Membership is exact by construction: a block only scores queries that
// probed its list, sentinel-valued probe slots (id n_lists) form no pair,
// and a repeated probe of one list in a row counts once, as the TPU
// kernel's `any(probes == lid)`. Shared 1-D filters are folded into the
// gathered id planes before the launch (a filtered slot becomes -1).
//
// Bound on the H100: each probed list is read from device memory once
// per group of up to 64 probing queries (the TPU design's "once per
// query tile" property, without scoring queries that did not probe the
// list), and the products are 2 * pairs * list_size * d float32
// operations on the CUDA cores. Tiles of padding (all ids -1) are skipped.
#include "ivf_scan_body.cuh"

namespace raft_tpu_torch {

template <typename XT>
__global__ void __launch_bounds__(kThreads) ivf_scan_partial_kernel(
    const float* __restrict__ Q, const XT* __restrict__ data,
    const float* __restrict__ norms, const int* __restrict__ ids_g,
    const int* __restrict__ uniq, const int* __restrict__ offs,
    const int* __restrict__ pair_q, const int* __restrict__ pair_slot,
    int p, int d, int m, int k, int ip_metric, float* __restrict__ pd,
    int* __restrict__ pi) {
  const int j = blockIdx.x;
  const int start = offs[j] + blockIdx.y * kQT;
  const int cnt = min(kQT, offs[j + 1] - start);
  if (cnt <= 0) return;  // block-uniform: no queries for this chunk
  const size_t lid = (size_t)uniq[j];
  scan_list_block<XT>(Q, data + lid * m * d, norms + lid * m,
                      ids_g + (size_t)j * m, pair_q, pair_slot, start, cnt,
                      p, d, m, k, ip_metric, pd, pi);
}

template <typename XT>
cudaError_t launch_scan(const float* Q, const XT* data, const float* norms,
                        const int* ids_g, const int* uniq, const int* offs,
                        const int* pair_q, const int* pair_slot, int q, int p,
                        int d, int m, int k, int ip_metric, int cap,
                        int max_chunks, float* pd, int* pi, float* outd,
                        int* outi, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_partial_kernel<XT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cap > 0 && max_chunks > 0) {
    dim3 grid(cap, max_chunks);
    ivf_scan_partial_kernel<XT><<<grid, kThreads, smem, stream>>>(
        Q, data, norms, ids_g, uniq, offs, pair_q, pair_slot, p, d, m, k,
        ip_metric, pd, pi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_merge(pd, pi, q, p * k, k,
                      ip_metric ? kEpilogNegate : kEpilogNone, outd, outi,
                      stream);
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. Q (q, d) f32; data (n_lists, m, d) f32 or
// bf16 (data_bf16); norms (n_lists, m) f32; ids_g (cap, m) int32 id planes
// of the unique lists uniq (cap,); offs (cap + 1,) CSR offsets into the
// list-sorted pairs pair_q / pair_slot; pd/pi (q, p, k) scratch filled
// with (+inf, -1) by the caller; outd/outi (q, k). Returns cudaError_t.
extern "C" int raft_ivf_scan(const void* Q, const void* data, int data_bf16,
                             const void* norms, const void* ids_g,
                             const void* uniq, const void* offs,
                             const void* pair_q, const void* pair_slot, int q,
                             int p, int d, int m, int k, int ip_metric,
                             int cap, int max_chunks, void* pd, void* pi,
                             void* outd, void* outi, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (data_bf16)
    return (int)launch_scan<__nv_bfloat16>(
        (const float*)Q, (const __nv_bfloat16*)data, (const float*)norms,
        (const int*)ids_g, (const int*)uniq, (const int*)offs,
        (const int*)pair_q, (const int*)pair_slot, q, p, d, m, k, ip_metric,
        cap, max_chunks, (float*)pd, (int*)pi, (float*)outd, (int*)outi, s);
  return (int)launch_scan<float>(
      (const float*)Q, (const float*)data, (const float*)norms,
      (const int*)ids_g, (const int*)uniq, (const int*)offs,
      (const int*)pair_q, (const int*)pair_slot, q, p, d, m, k, ip_metric,
      cap, max_chunks, (float*)pd, (int*)pi, (float*)outd, (int*)outi, s);
}
