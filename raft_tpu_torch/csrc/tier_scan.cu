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
// (distance, smallest id) order. Block j of a (list, query-group) grid
// runs the all-device scan's block body (scan_list_block,
// ivf_scan_body.cuh) on its list's rows, and the one merge
// (topk_common.cuh) follows: same pairs, same partial lists, same merge,
// so the results equal the all-device scan's bit for bit by construction.
// The norm and id planes stay resident in device memory for every list.
//
// Where the rows come from. The TPU kernel double-buffers whole cold
// blocks into fast memory by DMA, one block ahead, steered by
// `tier_fetch_plan`, and scores them from there. Here the cold lists of
// the request are staged through the copy engine instead:
//   - the wrapper's staging plan (ops/tier_scan.tier_stage_plan) lists
//     the probed cold lists, longest first, with the rows each needs (its
//     real rows rounded up to the body's 64-row tile; tiles past them
//     hold only padding, which the body skips unread) and packs them into
//     a device ring in waves: a few waves one after the other when the
//     ring holds them all, else waves that take turns in the ring's two
//     halves (wave w in half w % 2: `reuse`);
//   - this entry launches the scan of the hot lists, then issues one
//     cudaMemcpyAsync per cold list, pinned host -> ring, on a copy
//     stream, with an event after each wave; a second scan stream scans
//     each wave after waiting on its event, beside the hot lists' scan
//     (each fills the other's tail) and while the next wave is copied;
//     under `reuse`, wave w + 2's copies wait on the scan of wave w,
//     which read the same half; the compute stream waits for the last
//     wave's scan before the merge;
//   - a launch's time is at least its longest list's walk by one block,
//     so every launch takes its lists longest first, and the longest cold
//     lists go in the first wave: the last wave, which nothing overlaps,
//     holds the shortest;
//   - each block takes its list's rows from a per-launch table: the hot
//     plane's slot or the list's ring offset. No kernel reads host memory.
// So each probed cold list crosses the host link once per request, at the
// copy engine's rate, whatever the number of queries that probe it.
//
// Bound on the H100 (SXM, PCIe Gen5 x16): the larger of
//   - the staged cold rows over the host link, 64 GB/s per direction
//     (half of the data sheet's 128 GB/s, which counts both directions);
//   - the all-device body's own time on the same pairs: the probed rows
//     over HBM3 at 3.35 TB/s and 2 * pairs * rows * d float32 operations
//     at 67 TFLOP/s (PERF.md: the body runs far from both).
// At serving sizes the link bounds the copies and the body bounds the
// scans; the two overlap except for the last wave's scan.
#include "ivf_scan_body.cuh"

#include <vector>

namespace raft_tpu_torch {

// order[blockIdx.x] names the union step j this block scans; ring_off[j]
// is the ring row offset of a staged cold list, -1 for a hot list.
__global__ void __launch_bounds__(kThreads) tier_scan_partial_kernel(
    const float* __restrict__ Q, const float* __restrict__ hot,
    const float* __restrict__ ring, const int* __restrict__ hot_map,
    const float* __restrict__ norms, const int* __restrict__ ids_g,
    const int* __restrict__ uniq, const int* __restrict__ offs,
    const int* __restrict__ pair_q, const int* __restrict__ pair_slot,
    const long long* __restrict__ order,
    const long long* __restrict__ ring_off,
    int p, int d, int m, int k, int ip_metric, float* __restrict__ pd,
    int* __restrict__ pi) {
  const int j = (int)order[blockIdx.x];
  const int start = offs[j] + blockIdx.y * kQT;
  const int cnt = min(kQT, offs[j + 1] - start);
  if (cnt <= 0) return;  // block-uniform: no queries for this chunk
  const int lid = uniq[j];
  const long long ro = ring_off[j];
  const float* list = ro >= 0 ? ring + ro * d
                              : hot + (size_t)hot_map[lid] * m * d;
  scan_list_block<float>(Q, list, norms + (size_t)lid * m,
                         ids_g + (size_t)j * m, pair_q, pair_slot, start,
                         cnt, p, d, m, k, ip_metric, pd, pi);
}

struct ScanArgs {
  const float *Q, *hot, *ring;
  const int* hot_map;
  const float* norms;
  const int *ids_g, *uniq, *offs, *pair_q, *pair_slot;
  const long long *order, *ring_off;
  int p, d, m, k, ip_metric, max_chunks;
  float* pd;
  int* pi;
};

// one scan launch over order[begin, end)
inline cudaError_t launch_steps(const ScanArgs& a, int begin, int end,
                                size_t smem, cudaStream_t s) {
  if (end <= begin || a.max_chunks <= 0) return cudaSuccess;
  dim3 grid(end - begin, a.max_chunks);
  tier_scan_partial_kernel<<<grid, kThreads, smem, s>>>(
      a.Q, a.hot, a.ring, a.hot_map, a.norms, a.ids_g, a.uniq, a.offs,
      a.pair_q, a.pair_slot, a.order + begin, a.ring_off, a.p, a.d, a.m,
      a.k, a.ip_metric, a.pd, a.pi);
  return cudaGetLastError();
}

// Events of one call: created here, destroyed on every return (a pending
// event is released once it completes).
struct Events {
  std::vector<cudaEvent_t> ev;
  ~Events() {
    for (cudaEvent_t e : ev) cudaEventDestroy(e);
  }
  cudaError_t make(int n) {
    for (int i = 0; i < n; ++i) {
      cudaEvent_t e;
      cudaError_t err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
      if (err != cudaSuccess) return err;
      ev.push_back(e);
    }
    return cudaSuccess;
  }
};

#define RAFT_TRY(x)                           \
  do {                                        \
    cudaError_t e_ = (x);                     \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes; issues the whole request (copies, scans,
// merge) and returns the first cudaError_t, cudaErrorInvalidValue for a
// cold pointer that is not page-locked host memory.
//
// Device: Q (q, d) f32; hot (n_hot, m, d) f32; hot_map (n_lists,) int32;
// norms (n_lists, m) f32; ids_g (cap, m) int32 id planes of the union
// uniq (cap,); offs (cap + 1,) CSR offsets into the list-sorted pairs
// pair_q / pair_slot; order (n_steps,) int64 union steps, the hot steps
// first, then each wave's cold steps; ring_off (cap,) int64 ring row
// offset of each staged step (-1 hot); ring (ring_rows, d) f32 workspace;
// pd/pi (q, p, k) scratch filled with (+inf, -1); outd/outi (q, k).
// Host: cold (n_cold, m, d) f32 in pinned host memory (null when n_cold
// is 0); reuse: 1 when wave w + 2 overwrites wave w's half of the ring;
// wave_end (n_waves,) int32 end of each wave in `order`;
// copy_slot, copy_rows (n_copies,) int32 and copy_off (n_copies,) int64:
// the cold slot, rows and ring row offset of order[n_hot + i].
// stream: the compute stream; copy_stream, scan_stream: side streams for
// the copies and for the scans of the cold waves.
extern "C" int raft_tier_scan(
    const void* Q, const void* hot, const void* cold, const void* hot_map,
    const void* norms, const void* ids_g, const void* uniq,
    const void* offs, const void* pair_q, const void* pair_slot,
    const void* order, const void* ring_off, void* ring, int q, int p,
    int d, int m, int k, int ip_metric, int max_chunks, int n_hot,
    int n_waves, int reuse, const int* wave_end, const int* copy_slot,
    const long long* copy_off, const int* copy_rows, void* pd, void* pi,
    void* outd, void* outi, void* stream, void* copy_stream,
    void* scan_stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(copy_stream);
  cudaStream_t ss = reinterpret_cast<cudaStream_t>(scan_stream);
  if (cold != nullptr) {
    // cudaMemcpyAsync from pageable memory is synchronous: refuse it
    cudaPointerAttributes attr;
    cudaError_t err = cudaPointerGetAttributes(&attr, cold);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset it, so later error checks do not see it
      return (int)err;
    }
    if (attr.type != cudaMemoryTypeHost) return (int)cudaErrorInvalidValue;
  } else if (n_waves > 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = scan_smem_bytes(k);
  RAFT_TRY(cudaFuncSetAttribute(tier_scan_partial_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
  const ScanArgs a{(const float*)Q,        (const float*)hot,
                   (const float*)ring,     (const int*)hot_map,
                   (const float*)norms,    (const int*)ids_g,
                   (const int*)uniq,       (const int*)offs,
                   (const int*)pair_q,     (const int*)pair_slot,
                   (const long long*)order, (const long long*)ring_off,
                   p, d, m, k, ip_metric,  max_chunks,
                   (float*)pd,             (int*)pi};
  const float* src = static_cast<const float*>(cold);
  float* dst = static_cast<float*>(ring);
  const size_t row_bytes = (size_t)d * sizeof(float);
  // events: [0] the compute stream's state on entry, then per wave its
  // copies' end and its scan's end
  Events ev;
  RAFT_TRY(ev.make(1 + 2 * n_waves));
  auto copied = [&](int w) { return ev.ev[1 + 2 * w]; };
  auto scanned = [&](int w) { return ev.ev[2 + 2 * w]; };
  auto wave_begin = [&](int w) { return w == 0 ? n_hot : wave_end[w - 1]; };
  auto issue_copies = [&](int w) -> cudaError_t {
    if (reuse && w >= 2) {  // the same half: after wave w - 2's scan
      cudaError_t err = cudaStreamWaitEvent(cs, scanned(w - 2), 0);
      if (err != cudaSuccess) return err;
    }
    for (int i = wave_begin(w) - n_hot; i < wave_end[w] - n_hot; ++i) {
      if (copy_rows[i] <= 0) continue;
      cudaError_t err = cudaMemcpyAsync(
          dst + copy_off[i] * d, src + (size_t)copy_slot[i] * m * d,
          (size_t)copy_rows[i] * row_bytes, cudaMemcpyHostToDevice, cs);
      if (err != cudaSuccess) return err;
    }
    return cudaEventRecord(copied(w), cs);
  };
  if (n_waves > 0) {
    // the ring (and the cold plane, which placement writes on the compute
    // stream) may still be in use by work queued before this call
    RAFT_TRY(cudaEventRecord(ev.ev[0], s));
  }
  // the hot lists first: they need no copy, and the host issues the
  // copies while they run
  RAFT_TRY(launch_steps(a, 0, n_hot, smem, s));
  if (n_waves > 0) {
    RAFT_TRY(cudaStreamWaitEvent(cs, ev.ev[0], 0));
    // without reuse every wave's copies go at once; with it, two ahead
    const int ahead = reuse ? 2 : n_waves;
    for (int w = 0; w < n_waves && w < ahead; ++w) RAFT_TRY(issue_copies(w));
  }
  for (int w = 0; w < n_waves; ++w) {
    RAFT_TRY(cudaStreamWaitEvent(ss, copied(w), 0));
    RAFT_TRY(launch_steps(a, wave_begin(w), wave_end[w], smem, ss));
    RAFT_TRY(cudaEventRecord(scanned(w), ss));
    if (reuse && w + 2 < n_waves) RAFT_TRY(issue_copies(w + 2));
  }
  // the last wave's scan follows every copy and every earlier scan: after
  // it, all of them are ordered before the compute stream's later work
  if (n_waves > 0) RAFT_TRY(cudaStreamWaitEvent(s, scanned(n_waves - 1), 0));
  return (int)launch_merge((const float*)pd, (const int*)pi, q, p * k, k,
                           ip_metric ? kEpilogNegate : kEpilogNone,
                           (float*)outd, (int*)outi, s);
}
