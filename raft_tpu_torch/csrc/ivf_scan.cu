// IVF-Flat probe scan: the Hopper port of the JAX package's
// `_ivf_scan_kernel` (raft_tpu/ops/ivf_scan.py, engine "pallas"), the TPU
// re-design of the reference's ivf_flat_interleaved_scan.
//
// The TPU kernel walks the probed-list union in order for each query
// tile, scores the whole tile against each list in one GEMM, masks the
// rows of queries that did not probe the list, and carries the running
// top-k across the walk. Here the wrapper turns the probes into (list,
// query) pairs grouped by list (CSR over the sorted union), and each
// probed list's live rows into chunks of 512; a work item is (list, row
// chunk, group of up to 64 of the list's probers):
//   0. ivf_seed_kernel: each query's seed bound, the k-th smallest pair
//      of 512 rows of its nearest probed list, scored as a one-query
//      item of the same body (ivf_scan_body.cuh); the
//      items drop every candidate past it before inserting, which leaves
//      the result as it is and spares most insertions;
//   1. ivf_scan_items_kernel: a grid that fills the card walks the items
//      (scan_items, ivf_scan_body.cuh, shared with the tiered scan); each
//      item stages its queries once, streams its chunk through a
//      cp.async ring, scores on a 4 x 8 register micro-tile a thread,
//      and writes one partial top-k per (query, probe slot, chunk);
//   2. merge_ragged_kernel (topk_common.cuh) merges each query's ragged
//      run of partials in (distance, smallest id) order, a block a query;
//      IP is negated back.
// Membership is exact by construction: an item only scores queries that
// probed its list, sentinel-valued probe slots (id n_lists) form no pair,
// and a repeated probe of one list in a row counts once, as the TPU
// kernel's `any(probes == lid)`. Shared 1-D filters are folded into the
// gathered id planes before the launch (a filtered slot becomes -1), and
// rows past a list's last live id are never read.
//
// Bound on the H100: 2 * (probed rows) * d float32 operations on the CUDA
// cores (no TF32: every product is an fmaf chain in column order, which
// the exactness guards and the tiered scan's bit-identity rest on), and
// each probed list's live rows read once per group of up to 64 probing
// queries. The design's answers: items spread a long list over many SMs
// (a small batch takes about its longest chunk's time, not its longest
// list's), the queries are staged once per item, the rows' loads overlap
// the arithmetic, and a thread does 128 FMAs per 12 shared loads.
#include "ivf_scan_body.cuh"

namespace raft_tpu_torch {

template <typename XT>
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSm)
    ivf_scan_items_kernel(const ScanArgs a, const XT* __restrict__ data) {
  const size_t list_elems = (size_t)a.m * a.d;
  scan_items<XT>(a, [&](int, int lid) { return data + lid * list_elems; });
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSm)
    ivf_seed_kernel(const ScanArgs a, const XT* __restrict__ data, int q,
                    const int* __restrict__ seed_step, float* bound_d,
                    int* bound_i) {
  const size_t list_elems = (size_t)a.m * a.d;
  seed_bounds<XT>(a, q, seed_step, bound_d, bound_i,
                  [&](int, int lid) { return data + lid * list_elems; });
}

template <typename XT>
cudaError_t launch_scan(ScanArgs a, const XT* data, int q,
                        long long max_items, const int* seed_step,
                        float* bound_d, int* bound_i, float* outd, int* outi,
                        cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(a.d, a.k);
  if (q > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        ivf_seed_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = scan_grid(ivf_seed_kernel<XT>, smem, q, &blocks);
    if (err != cudaSuccess) return err;
    ivf_seed_kernel<XT><<<blocks, kThreads, smem, stream>>>(
        a, data, q, seed_step, bound_d, bound_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.bound_d = bound_d;
    a.bound_i = bound_i;
  }
  auto kernel = ivf_scan_items_kernel<XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = scan_grid(kernel, smem, max_items, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks > 0) {
    kernel<<<blocks, kThreads, smem, stream>>>(a, data);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_merge_ragged(a.pd, a.pi, q, a.k,
                             a.ip_metric ? kEpilogNegate : kEpilogNone,
                             a.slot_off, a.p, outd, outi, stream);
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. Q (q, d) f32; data (n_lists, m, d) f32 or
// bf16 (data_bf16); norms (n_lists, m) f32; ids_g (cap, m) int32 id planes
// of the unique lists uniq (cap,); offs (cap + 1,) CSR offsets into the
// list-sorted pairs pair_q / pair_slot; live (cap,) int32 rows up to each
// union list's last live id; item_off (cap + 1,) int64 first work item of
// each union list; slot_off (q * p + 1,) int32 first partial list of each
// (query, probe slot); max_items a host bound on item_off[cap] (grid
// size); seed_step (q,) int32 the union step of each query's seed list
// (-1: none); bound_d/bound_i (q,) f32/int32 scratch; pd/pi scratch of
// slot_off[q * p] * k entries, written whole by the kernel; outd/outi
// (q, k). Returns cudaError_t.
extern "C" int raft_ivf_scan(const void* Q, const void* data, int data_bf16,
                             const void* norms, const void* ids_g,
                             const void* uniq, const void* offs,
                             const void* pair_q, const void* pair_slot,
                             const void* live, const void* item_off,
                             const void* slot_off, int q, int p, int d,
                             int m, int k, int ip_metric, int cap,
                             long long max_items, const void* seed_step,
                             void* bound_d, void* bound_i, void* pd, void* pi,
                             void* outd, void* outi, void* stream) {
  if (q < 0 || p < 0 || d < 1 || m < 0 || k < 1 || k > 128 || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  ScanArgs a;
  a.Q = (const float*)Q;
  a.norms = (const float*)norms;
  a.ids_g = (const int*)ids_g;
  a.uniq = (const int*)uniq;
  a.offs = (const int*)offs;
  a.pair_q = (const int*)pair_q;
  a.pair_slot = (const int*)pair_slot;
  a.live = (const int*)live;
  a.slot_off = (const int*)slot_off;
  a.order = nullptr;
  a.item_off = (const long long*)item_off;
  a.begin = 0;
  a.end = cap;
  a.p = p;
  a.d = d;
  a.m = m;
  a.k = k;
  a.ip_metric = ip_metric;
  a.vec = !data_bf16 && d % 4 == 0 &&
          ((uintptr_t)data | (uintptr_t)Q) % 16 == 0;
  a.bound_d = nullptr;
  a.bound_i = nullptr;
  a.pd = (float*)pd;
  a.pi = (int*)pi;
  if (data_bf16)
    return (int)launch_scan<__nv_bfloat16>(
        a, (const __nv_bfloat16*)data, q, max_items, (const int*)seed_step,
        (float*)bound_d, (int*)bound_i, (float*)outd, (int*)outi, s);
  return (int)launch_scan<float>(a, (const float*)data, q, max_items,
                                 (const int*)seed_step, (float*)bound_d,
                                 (int*)bound_i, (float*)outd, (int*)outi, s);
}
