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
// (distance, smallest id) order. Each launch walks the work items
// (list, row chunk, query group) of its steps with the all-device scan's
// body (scan_items, ivf_scan_body.cuh), and the one ragged merge
// (topk_common.cuh) follows: same items, same partial lists, same merge,
// so the results equal the all-device scan's bit for bit by construction.
// The norm and id planes stay resident in device memory for every list.
//
// Where the rows come from. The TPU kernel double-buffers whole cold
// blocks into fast memory by DMA, one block ahead, steered by
// `tier_fetch_plan`, and scores them from there. Here the cold lists of
// the request are staged through the copy engine instead:
//   - the wrapper's staging plan (ops/tier_scan.tier_stage_plan) lists
//     the probed cold lists, longest first, with the rows each needs (its
//     real rows rounded up to 64; the body reads a list's rows only up
//     to its last live one) and packs them into
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
//   - the longest cold lists go in the first wave: the last wave, which
//     nothing overlaps, holds the shortest (a launch is at least its
//     longest item, 512 rows, since a list's chunks spread over blocks);
//   - each item takes its list's rows from a per-step table: the hot
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

// hot_map[lid] is a hot list's slot; ring_off[j] is the ring row offset
// of a staged cold step j, -1 for a hot one.
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSm)
    tier_scan_items_kernel(const ScanArgs a, const float* __restrict__ hot,
                           const float* __restrict__ ring,
                           const int* __restrict__ hot_map,
                           const long long* __restrict__ ring_off) {
  const size_t list_elems = (size_t)a.m * a.d;
  scan_items<float>(a, [&](int j, int lid) {
    const long long ro = ring_off[j];
    return ro >= 0 ? ring + ro * a.d : hot + hot_map[lid] * list_elems;
  });
}

// the seed bounds from hot lists only: their rows need no copy
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSm)
    tier_seed_kernel(const ScanArgs a, int q,
                     const int* __restrict__ seed_step,
                     const float* __restrict__ hot,
                     const int* __restrict__ hot_map, float* bound_d,
                     int* bound_i) {
  const size_t list_elems = (size_t)a.m * a.d;
  seed_bounds<float>(a, q, seed_step, bound_d, bound_i, [&](int, int lid) {
    return hot + hot_map[lid] * list_elems;
  });
}

struct TierLaunch {
  ScanArgs a;  // begin / end set per launch
  const float *hot, *ring;
  const int* hot_map;
  const long long* ring_off;
  const long long* item_off_h;  // host copy of a.item_off
  size_t smem;
};

// one scan launch over order[begin, end)
inline cudaError_t launch_steps(TierLaunch t, int begin, int end,
                                cudaStream_t s) {
  const long long items = end > begin
                              ? t.item_off_h[end] - t.item_off_h[begin]
                              : 0;
  if (items <= 0) return cudaSuccess;
  int blocks = 0;
  cudaError_t err = scan_grid(tier_scan_items_kernel, t.smem, items, &blocks);
  if (err != cudaSuccess) return err;
  t.a.begin = begin;
  t.a.end = end;
  tier_scan_items_kernel<<<blocks, kThreads, t.smem, s>>>(
      t.a, t.hot, t.ring, t.hot_map, t.ring_off);
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
// pair_q / pair_slot; live (cap,) int32 rows up to each union step's last
// live id; slot_off (q * p + 1,) int32 first partial list of each
// (query, probe slot); order (n_steps,) int64 union steps, the hot steps
// first, then each wave's cold steps; item_off (n_steps + 1,) int64 first
// work item of each step of `order`; ring_off (cap,) int64 ring row
// offset of each staged step (-1 hot); ring (ring_rows, d) f32 workspace;
// seed_step (q,) int32 the union step of a hot list each query probes
// (-1: none) and bound_d/bound_i (q,) f32/int32 scratch: the seed bounds;
// pd/pi scratch of slot_off[q * p] * k entries; outd/outi (q, k).
// Host: item_off_h, a copy of item_off; cold (n_cold, m, d) f32 in pinned
// host memory (null when n_cold is 0); reuse: 1 when wave w + 2
// overwrites wave w's half of the ring; wave_end (n_waves,) int32 end of
// each wave in `order`; copy_slot, copy_rows (n_copies,) int32 and
// copy_off (n_copies,) int64: the cold slot, rows and ring row offset of
// order[n_hot + i].
// stream: the compute stream; copy_stream, scan_stream: side streams for
// the copies and for the scans of the cold waves.
extern "C" int raft_tier_scan(
    const void* Q, const void* hot, const void* cold, const void* hot_map,
    const void* norms, const void* ids_g, const void* uniq,
    const void* offs, const void* pair_q, const void* pair_slot,
    const void* live, const void* slot_off, const void* order,
    const void* item_off, const void* ring_off, void* ring,
    const void* seed_step, void* bound_d, void* bound_i, int q, int p,
    int d, int m, int k, int ip_metric, int n_hot, int n_waves, int reuse,
    const long long* item_off_h, const int* wave_end, const int* copy_slot,
    const long long* copy_off, const int* copy_rows, void* pd, void* pi,
    void* outd, void* outi, void* stream, void* copy_stream,
    void* scan_stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(copy_stream);
  cudaStream_t ss = reinterpret_cast<cudaStream_t>(scan_stream);
  if (q < 0 || p < 0 || d < 1 || m < 0 || k < 1 || k > 128)
    return (int)cudaErrorInvalidValue;
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
  TierLaunch t;
  t.smem = scan_smem_bytes(d, k);
  RAFT_TRY(cudaFuncSetAttribute(tier_scan_items_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)t.smem));
  ScanArgs& a = t.a;
  a.Q = (const float*)Q;
  a.norms = (const float*)norms;
  a.ids_g = (const int*)ids_g;
  a.uniq = (const int*)uniq;
  a.offs = (const int*)offs;
  a.pair_q = (const int*)pair_q;
  a.pair_slot = (const int*)pair_slot;
  a.live = (const int*)live;
  a.slot_off = (const int*)slot_off;
  a.order = (const long long*)order;
  a.item_off = (const long long*)item_off;
  a.begin = a.end = 0;
  a.p = p;
  a.d = d;
  a.m = m;
  a.k = k;
  a.ip_metric = ip_metric;
  // the ring's rows are d floats from a 256-byte aligned allocation
  a.vec = d % 4 == 0 &&
          ((uintptr_t)hot | (uintptr_t)ring | (uintptr_t)Q) % 16 == 0;
  a.bound_d = nullptr;
  a.bound_i = nullptr;
  a.pd = (float*)pd;
  a.pi = (int*)pi;
  t.hot = (const float*)hot;
  t.ring = (const float*)ring;
  t.hot_map = (const int*)hot_map;
  t.ring_off = (const long long*)ring_off;
  t.item_off_h = item_off_h;
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
  if (q > 0) {  // the seed bounds come first: every scan reads them
    RAFT_TRY(cudaFuncSetAttribute(
        tier_seed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)t.smem));
    int blocks = 0;
    RAFT_TRY(scan_grid(tier_seed_kernel, t.smem, q, &blocks));
    tier_seed_kernel<<<blocks, kThreads, t.smem, s>>>(
        a, q, (const int*)seed_step, (const float*)hot, (const int*)hot_map,
        (float*)bound_d, (int*)bound_i);
    RAFT_TRY(cudaGetLastError());
    a.bound_d = (const float*)bound_d;
    a.bound_i = (const int*)bound_i;
  }
  if (n_waves > 0) {
    // the ring (and the cold plane, which placement writes on the compute
    // stream) may still be in use by work queued before this call, and
    // the wave scans read the seed bounds
    RAFT_TRY(cudaEventRecord(ev.ev[0], s));
  }
  // the hot lists first: they need no copy, and the host issues the
  // copies while they run
  RAFT_TRY(launch_steps(t, 0, n_hot, s));
  if (n_waves > 0) {
    RAFT_TRY(cudaStreamWaitEvent(cs, ev.ev[0], 0));
    // without reuse every wave's copies go at once; with it, two ahead
    const int ahead = reuse ? 2 : n_waves;
    for (int w = 0; w < n_waves && w < ahead; ++w) RAFT_TRY(issue_copies(w));
  }
  for (int w = 0; w < n_waves; ++w) {
    RAFT_TRY(cudaStreamWaitEvent(ss, copied(w), 0));
    RAFT_TRY(launch_steps(t, wave_begin(w), wave_end[w], ss));
    RAFT_TRY(cudaEventRecord(scanned(w), ss));
    if (reuse && w + 2 < n_waves) RAFT_TRY(issue_copies(w + 2));
  }
  // the last wave's scan follows every copy and every earlier scan: after
  // it, all of them are ordered before the compute stream's later work
  if (n_waves > 0) RAFT_TRY(cudaStreamWaitEvent(s, scanned(n_waves - 1), 0));
  return (int)launch_merge_ragged((const float*)pd, (const int*)pi, q, k,
                                  ip_metric ? kEpilogNegate : kEpilogNone,
                                  (const int*)slot_off, p, (float*)outd,
                                  (int*)outi, s);
}
