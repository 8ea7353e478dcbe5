// The RaBitQ estimate device code shared by bq_scan.cu (the IVF-BQ probe
// scan) and beam_search.cu (the CAGRA walk's BQ-coded traversal), so that
// both take their sums in ops/bq_scan.tree_sum's order and divide by
// constants through correctly rounded divisions (`_div`): their prune
// decisions equal the plain versions' bit for bit.
//
// Float steps are `__f*_rn` intrinsics, which the compiler never contracts
// into FMAs: each product and sum is rounded where the plain version
// rounds it.
#pragma once

#include "topk_common.cuh"

namespace raft_tpu_torch {

constexpr int kBqThreads = 256;    // block size of the kernels that use this
constexpr int kBqWarps = kBqThreads / 32;
constexpr int kMaxQueryBits = 8;

enum ReduceOp { kMin = 0, kMax = 1 };

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  return OP == kMin ? fminf(a, b) : fmaxf(a, b);
}

// sum_e a[e] * b[e] over e < n, in tree_sum's order: the products are
// rounded, zero-padded to 32 * C lanes (C a power of two, 32 * C >= n),
// and the upper half of the lanes is added to the lower half until one
// is left. Lane l holds lanes l + 32 c; the halvings over c run in its
// registers, the last five across the warp. Every lane gets the sum.
template <int C>
__device__ __forceinline__ float warp_tree_dot(const float* a,
                                               const float* b, int n,
                                               int lane) {
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = lane + 32 * c;
    v[c] = e < n ? __fmul_rn(a[e], b[e]) : 0.f;
  }
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

// Block-wide reduction of one value per thread (kBqThreads threads); every
// thread gets the result. `red` holds kBqWarps floats of shared scratch.
template <int OP>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = combine<OP>(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();  // `red` may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kBqWarps; ++w) r = combine<OP>(r, red[w]);
  return r;
}

// What the estimate of any row needs from the query side.
struct BqQuery {
  float lo, delta, qc2c, base_ip, qcn;
};

// The query side against one rotated center `crot` (de floats), by the
// whole block: q~ = Rq - Rc (L2) or Rq (IP) into `qt`, its lo/hi, the
// quantization step, the packed bit-planes `uw` (qbits * de / 32 words:
// one warp per 32-lane word, the ballot of bit j over the lanes is plane
// j's word), sum(q~^2) and <Rq, Rc> in tree order. `sums` holds 2 floats
// of shared scratch. Ends with a __syncthreads.
template <int C>
__device__ BqQuery bq_query_side(const float* qr, const float* crot,
                                 float* qt, int* uw, float* red, float* sums,
                                 int de, int qbits, int ip_metric) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = de >> 5;
  const int levels = (1 << qbits) - 1;
  float lo_p = CUDART_INF_F, hi_p = -CUDART_INF_F;
  for (int t = tid; t < de; t += kBqThreads) {
    const float v = ip_metric ? qr[t] : __fsub_rn(qr[t], crot[t]);
    qt[t] = v;
    lo_p = fminf(lo_p, v);
    hi_p = fmaxf(hi_p, v);
  }
  const float lo = block_reduce<kMin>(lo_p, red);
  const float hi = block_reduce<kMax>(hi_p, red);  // qt is written
  if (warp == 0) {
    const float s2 = warp_tree_dot<C>(qt, qt, de, lane);
    const float sip = ip_metric ? warp_tree_dot<C>(qr, crot, de, lane) : 0.f;
    if (lane == 0) {
      sums[0] = s2;
      sums[1] = sip;
    }
  }
  const float delta =
      fmaxf(__fdiv_rn(__fsub_rn(hi, lo), (float)levels), 1e-30f);
  for (int w = warp; w < W; w += kBqWarps) {
    const float v = rintf(__fdiv_rn(__fsub_rn(qt[w * 32 + lane], lo), delta));
    const int u = (int)fminf(fmaxf(v, 0.f), (float)levels);
    for (int jb = 0; jb < qbits; ++jb) {
      const unsigned b = __ballot_sync(kFull, (u >> jb) & 1);
      if (lane == 0) uw[jb * W + w] = (int)b;
    }
  }
  __syncthreads();
  BqQuery b;
  b.lo = lo;
  b.delta = delta;
  b.qc2c = fmaxf(sums[0], 0.f);
  b.base_ip = sums[1];
  b.qcn = __fsqrt_rn(sums[0]);
  return b;
}

// est - margin of one row, by one thread: `cw` the row's bits * W code
// words, `cf` its bits level scales, `rn` its residual norm, `ew` its
// error weight; eps2 = 2 * epsilon. The row survives the prune when the
// result is below the threshold.
__device__ __forceinline__ float bq_lower_bound(const int* cw, const float* cf,
                                                float rn, float ew,
                                                const int* uw, int W,
                                                int bits, int qbits, int de,
                                                const BqQuery& b,
                                                int ip_metric, float eps2) {
  const int levels = (1 << qbits) - 1;
  float cross = 0.f;
  for (int lev = 0; lev < bits; ++lev) {
    int pcc = 0, acc = 0;
    for (int w = 0; w < W; ++w) {
      const int c = cw[lev * W + w];
      pcc += __popc(c);
      for (int jb = 0; jb < qbits; ++jb)
        acc += __popc(uw[jb * W + w] ^ c) << jb;
    }
    // sum_j 2^j (pcc - popc(u_j ^ c)), an exact integer
    const int ius = levels * pcc - acc;
    const float ssum = (float)(2 * pcc - de);
    const float qs =
        __fadd_rn(__fmul_rn(b.delta, (float)ius), __fmul_rn(b.lo, ssum));
    const float a = __fmul_rn(rn, cf[lev]);
    cross = __fadd_rn(cross, __fmul_rn(a, qs));
  }
  float est;
  if (ip_metric)
    est = -__fadd_rn(b.base_ip, cross);
  else
    est = __fsub_rn(__fadd_rn(b.qc2c, __fmul_rn(rn, rn)),
                    __fmul_rn(2.f, cross));
  const float recon2 = __fadd_rn(__fmul_rn(rn, rn), __fmul_rn(ew, ew));
  const float t1 = __fmul_rn(b.qcn, ew);
  const float rot = __fdiv_rn(__fmul_rn(t1, t1), (float)de);
  const float qnt =
      __fdiv_rn(__fmul_rn(__fmul_rn(b.delta, b.delta), recon2), 12.f);
  const float margin = __fmul_rn(eps2, __fsqrt_rn(__fadd_rn(rot, qnt)));
  return __fsub_rn(est, margin);
}

}  // namespace raft_tpu_torch
