// Tiered IVF-Flat probe scan: the Hopper port of the JAX package's
// `_tier_scan_kernel` with `_cold_dma` (raft_tpu/ops/tier_scan.py, engine
// "pallas"), the dual-source scan of a tiered index whose list blocks are
// split between a hot plane in device memory and a cold plane in pinned
// host memory.
//
// What it computes is the all-device scan's (ivf_scan.cu): each probed
// list is scored with min-space `norms - 2 ip` (L2) or `-ip` (IP), rows
// with id -1 (padding, filtered) are masked, sentinel probe slots are
// inert, and the per-probe partial top-k lists merge per query in
// (distance, smallest id) order. The only difference is where a list's
// rows come from: block j of the (list, query-group) grid reads the slot
// maps of its list and takes
//     cold_map[lid] >= 0 ? cold + cold_slot * m * d : hot + hot_slot * m * d
// then runs the all-device scan's block body (scan_list_block,
// ivf_scan_body.cuh) and the same merge (topk_common.cuh). Same pairs,
// same partial lists, same merge: the results equal the all-device scan's
// bit for bit by construction. The norm and id planes stay resident in
// device memory for every list.
//
// Cold rows are read in place from pinned host memory: under the unified
// virtual address space a cudaHostAlloc'd buffer (what torch's
// pin_memory() returns) can be dereferenced by a kernel, so the host link
// carries only the rows of the probed cold lists (tiles of padding are
// skipped, as in the all-device scan), and the cold plane is never copied
// to the device as a whole. The C entry checks with
// cudaPointerGetAttributes that the cold pointer is page-locked host
// memory and takes the device pointer from those attributes; anything
// else (pageable or device memory) is refused before the launch.
//
// Bound on the H100 (SXM, PCIe Gen5 x16): the larger of
//   - the probed cold rows over the host link, 64 GB/s per direction
//     (half of the data sheet's 128 GB/s, which counts both directions);
//   - the probed hot rows over HBM3 at 3.35 TB/s;
//   - 2 * pairs * rows * d float32 operations at 67 TFLOP/s.
// At serving sizes the cold bytes bound it. A cold list probed by more
// than 64 queries is read once per group of 64, over the link each time.
//
// The staged design, for a perf_opt PR: copy-engine cudaMemcpyAsync of
// the probed cold blocks into a ring of device buffers on a side stream,
// each copy followed by an event that the scan of that block waits on —
// the TPU kernel's double-buffered DMA — so each cold block crosses the
// link once per request at the copy engine's rate, whatever its query
// groups.
#include "ivf_scan_body.cuh"

namespace raft_tpu_torch {

__global__ void __launch_bounds__(kThreads) tier_scan_partial_kernel(
    const float* __restrict__ Q, const float* __restrict__ hot,
    const float* __restrict__ cold, const int* __restrict__ hot_map,
    const int* __restrict__ cold_map, const float* __restrict__ norms,
    const int* __restrict__ ids_g, const int* __restrict__ uniq,
    const int* __restrict__ offs, const int* __restrict__ pair_q,
    const int* __restrict__ pair_slot, int p, int d, int m, int k,
    int ip_metric, float* __restrict__ pd, int* __restrict__ pi) {
  const int j = blockIdx.x;
  const int start = offs[j] + blockIdx.y * kQT;
  const int cnt = min(kQT, offs[j + 1] - start);
  if (cnt <= 0) return;  // block-uniform: no queries for this chunk
  const int lid = uniq[j];
  const int cs = cold_map[lid];
  const float* list = cs >= 0 ? cold + (size_t)cs * m * d
                              : hot + (size_t)hot_map[lid] * m * d;
  scan_list_block<float>(Q, list, norms + (size_t)lid * m,
                         ids_g + (size_t)j * m, pair_q, pair_slot, start,
                         cnt, p, d, m, k, ip_metric, pd, pi);
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. Q (q, d) f32; hot (n_hot, m, d) f32 in device
// memory; cold (n_cold, m, d) f32 in pinned host memory (or null when
// n_cold is 0); hot_map / cold_map (n_lists,) int32 slot maps, -1 where a
// list lives in the other tier; norms (n_lists, m) f32; ids_g (cap, m)
// int32 id planes of the unique lists uniq (cap,); offs (cap + 1,) CSR
// offsets into the list-sorted pairs pair_q / pair_slot; pd/pi (q, p, k)
// scratch filled with (+inf, -1) by the caller; outd/outi (q, k).
// Returns cudaError_t (cudaErrorInvalidValue for a cold pointer that is
// not page-locked host memory).
extern "C" int raft_tier_scan(const void* Q, const void* hot, const void* cold,
                              const void* hot_map, const void* cold_map,
                              const void* norms, const void* ids_g,
                              const void* uniq, const void* offs,
                              const void* pair_q, const void* pair_slot, int q,
                              int p, int d, int m, int k, int ip_metric,
                              int cap, int max_chunks, void* pd, void* pi,
                              void* outd, void* outi, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* cold_dev = nullptr;
  if (cold != nullptr) {
    cudaPointerAttributes attr;
    cudaError_t err = cudaPointerGetAttributes(&attr, cold);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset it, so later error checks do not see it
      return (int)err;
    }
    if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
      return (int)cudaErrorInvalidValue;
    cold_dev = static_cast<const float*>(attr.devicePointer);
  }
  const size_t smem = scan_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      tier_scan_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cap > 0 && max_chunks > 0) {
    dim3 grid(cap, max_chunks);
    tier_scan_partial_kernel<<<grid, kThreads, smem, s>>>(
        (const float*)Q, (const float*)hot, cold_dev, (const int*)hot_map,
        (const int*)cold_map, (const float*)norms, (const int*)ids_g,
        (const int*)uniq, (const int*)offs, (const int*)pair_q,
        (const int*)pair_slot, p, d, m, k, ip_metric, (float*)pd, (int*)pi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_merge((const float*)pd, (const int*)pi, q, p * k, k,
                           ip_metric ? kEpilogNegate : kEpilogNone,
                           (float*)outd, (int*)outi, s);
}
