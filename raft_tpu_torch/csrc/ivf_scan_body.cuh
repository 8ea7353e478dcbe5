// The body of one IVF-Flat probe-scan block, shared by the all-device scan
// (ivf_scan.cu) and the tiered dual-source scan (tier_scan.cu). The two
// kernels differ only in where a list's rows come from; everything from
// the row pointer on is this one function, so the tiered scan returns
// the all-device scan's partial lists bit for bit.
//
// One block scores one probed list against `cnt` <= 64 of the queries
// that probed it (pairs start .. start + cnt of the list-sorted pairs):
// it gathers its queries' rows, streams the list 64 rows at a time
// (float32 FMA products through shared memory), computes min-space
// `norms - 2 ip` (L2) or `-ip` (IP) for rows with id >= 0, and keeps a
// top-k per query. It writes the list's top-k into each query's probe
// slot of the (q, n_probes, k) partials. Tiles that hold only padding or
// filtered rows (all ids -1) are skipped without reading their rows.
#pragma once

#include "topk_common.cuh"

namespace raft_tpu_torch {

// dynamic shared memory of one scan block
inline size_t scan_smem_bytes(int k) {
  return (size_t)(2 * kDK + kQT) * kStride * sizeof(float) +
         (size_t)kQT * k * (sizeof(float) + sizeof(int)) + kQT * sizeof(int);
}

// list: the list's (m, d) rows; list_norms / list_ids: its (m,) norms and
// id plane (-1 on padding and filtered rows). All threads of the block
// call it.
template <typename XT>
__device__ __forceinline__ void scan_list_block(
    const float* __restrict__ Q, const XT* __restrict__ list,
    const float* __restrict__ list_norms, const int* __restrict__ list_ids,
    const int* __restrict__ pair_q, const int* __restrict__ pair_slot,
    int start, int cnt, int p, int d, int m, int k, int ip_metric,
    float* __restrict__ pd, int* __restrict__ pi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Xs = Qs + kDK * kStride;
  float* Ds = Xs + kDK * kStride;
  float* Ld = Ds + kQT * kStride;
  int* Li = reinterpret_cast<int*>(Ld + kQT * k);
  int* qidx = Li + kQT * k;
  __shared__ int ids_s[kDT];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;

  init_lists(Ld, Li, kQT * k);
  if (tid < kQT) qidx[tid] = tid < cnt ? pair_q[start + tid] : -1;

  for (int m0 = 0; m0 < m; m0 += kDT) {
    const int nx = min(kDT, m - m0);
    __syncthreads();
    if (tid < kDT) ids_s[tid] = tid < nx ? list_ids[m0 + tid] : -1;
    // skip a tile that holds only padding or filtered rows
    if (!__syncthreads_or(tid < kDT && ids_s[tid] >= 0)) continue;
    float acc[4][4];
    dot_tile<XT>(acc, Q, qidx, cnt, list + (size_t)m0 * d, nx, d, Qs, Xs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        float v = CUDART_INF_F;
        if (c < nx && ids_s[c] >= 0) {
          const float ip = acc[i][jj];
          v = ip_metric ? -ip
                        : __fsub_rn(list_norms[m0 + c], __fmul_rn(2.f, ip));
        }
        Ds[r * kStride + c] = v;
      }
    }
    __syncthreads();
    for (int r = warp; r < cnt; r += kThreads / 32) {
#pragma unroll
      for (int h = 0; h < kDT; h += 32) {
        const float v = Ds[r * kStride + h + lane];
        warp_insert(Ld + r * k, Li + r * k, k, v, ids_s[h + lane],
                    v < CUDART_INF_F);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < cnt * k; e += kThreads) {
    const int r = e / k, c = e % k;
    const size_t o = ((size_t)qidx[r] * p + pair_slot[start + r]) * k + c;
    pd[o] = Ld[e];
    pi[o] = Li[e];
  }
}

}  // namespace raft_tpu_torch
