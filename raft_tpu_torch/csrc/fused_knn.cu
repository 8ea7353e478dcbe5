// Exact kNN without the (q, n) distance matrix: the Hopper port of the
// JAX package's `_knn_kernel` (raft_tpu/ops/fused_topk.py), the TPU
// re-design of the reference's fusedL2kNN.
//
// On the TPU one core walks the dataset tiles in order and carries the
// running (q, k) top-k in VMEM from step to step. Blocks on a GPU run in
// parallel and in no order, so nothing carries across the grid. Two
// passes instead:
//   1. knn_kernel: block (query tile, dataset split) scores its split 128
//      rows a tile and keeps a per-query top-k for the split -> (q,
//      splits, k). A tile holds 128 queries for k <= 32 (64 for larger
//      k, whose lists take twice the room): each dataset row crosses L2
//      once for 128 queries. The query tile stays in shared memory for
//      the block's life (zero padded to whole stages; streamed beside the
//      rows when the depth is too large for that). Dataset rows stream
//      through a ring of 128 rows x 128 bytes a stage (with the tile's row
//      norms), filled by cp.async ahead of the products, as deep as shared
//      memory allows (one block an SM). Products run on the tensor cores
//      with mma.sync, 8 warps of 2 (queries) x 4 (rows): bfloat16
//      datasets (bf16-rounded queries, as the JAX kernel casts them) in
//      one m16n8k16 pass, every product exact in the float32 accumulator;
//      float32 datasets by the 3xTF32 split, hi = rna.tf32(x), lo =
//      rna.tf32(x - hi) for both operands, in registers as fragments load,
//      and ip = lo.hi' + hi.lo' + hi.hi' in m16n8k8 passes into one
//      float32 accumulator: the counterpart of the JAX kernel's
//      Precision.HIGHEST (split bf16 passes on the TPU's matrix unit). The
//      rounding is cvt.rna.tf32.f32's, computed with two integer
//      operations (the cvt instruction issues at ~0.6 a clock an SM on the
//      H100, scripts/torch_mma_rate.py, slower than the products need).
//      Its error is float32 accumulation's: a CPU model
//      (ops/fused_topk.split_tf32_ip) stays within 4e-6 (|q|^2 + |x|^2) of
//      float64 where one TF32 pass misses by ~1.4e-4; small integers have
//      lo = 0 and are exact. Fragments load 64 bits a row: logical k
//      indices t and t + 4 of a step take its words 2t and 2t + 1 in both
//      operands. The epilog stays in registers: the accumulator fragment
//      becomes the metric's min-space distance (the plain version's
//      roundings) and is compared against its query's threshold, the
//      lower of the block's k-th value (one float a query in shared
//      memory) and the query's shared bound (the smallest k-th key any
//      block of the query has published to one device word, read through
//      L2 at a tile's start); one block vote (__syncthreads_or) ends the
//      tile, the JAX kernel's `any_better`. Passing candidates go straight
//      from registers to their query's buffer in shared memory (a counter
//      a query); only when a buffer is full does each warp merge its
//      queries' buffers into their sorted lists (topk_common.cuh: bitonic
//      networks), and the candidates that found no room try again under
//      the tighter threshold.
//   2. merge_partials_kernel (topk_common.cuh): one warp per query merges
//      the splits in the same (distance, smallest id) order through the
//      filtered queue, applies sqrt or the sign of inner products, and
//      writes -1 for unfilled slots.
//
// Bound on the H100: 3 x 2*q*n*d TF32 tensor-core operations for float32
// (494.7 TFLOP/s dense; mma.sync reaches ~0.57 m16n8k8 a clock an SM,
// ~306 TFLOP/s), 2*q*n*d bf16 ones for bfloat16 (989.4); the dataset
// crosses device memory about once a request (the query tiles of one
// split are neighbours in the grid and share it through L2).
#include "topk_common.cuh"

namespace raft_tpu_torch {

enum MetricKind { kL2 = 0, kInnerProduct = 1, kCosine = 2 };

constexpr int kKnnBN = 128;            // dataset rows a tile
constexpr int kKnnWords = 32;          // 32-bit words of a row a stage
constexpr int kKnnLd = kKnnWords + 8;  // padded stride: conflict-free frags
constexpr int kKnnMaxStages = 8;       // ring depth: as many as fit
constexpr int kKnnThreads = 256;       // 8 warps: 2 (queries) x 4 (rows)

struct KnnArgs {
  const void* Q;   // (q, d) in the dataset's type
  const float* qn;
  const void* X;   // (n, d)
  const float* xn;
  int q, n, d, k, metric, chunk, splits;
  int d_pad;       // depth padded to whole stages (elements)
  int resident;    // the query tile stays in shared memory
  int stages;      // ring depth, 3 .. kKnnMaxStages
  int vec;         // rows 16-byte aligned: cp.async of 16 bytes
  float* pd;
  int* pi;
  u64* bound;      // (q,) complement of the query's smallest k-th key
};

// cvt.rna.tf32.f32 of a finite x (to nearest, ties away from zero: add
// half a unit of the 13 dropped bits to the magnitude, then drop them), in
// two integer operations: the cvt instruction issues at ~0.6 a clock an
// SM on the H100 (scripts/torch_mma_rate.py), a quarter of the product
// rate this kernel needs
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi,
                                           unsigned& lo) {
  const float f = __uint_as_float(x);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the metric's min-space distance of an inner product (the plain
// version's min_space_distances, step for step)
template <int M>
__device__ __forceinline__ float knn_dist(float ip, float qv, float xv) {
  if (M == kInnerProduct) return -ip;
  if (M == kCosine) {
    const float inv = 1.f / sqrtf(fmaxf(__fmul_rn(qv, xv), 1e-30f));
    return __fsub_rn(1.f, __fmul_rn(ip, inv));
  }
  // L2 family, clamped at 0 before selection: (qv + xv) - 2 ip with the
  // plain version's two roundings (2 ip is exact, so one fused step)
  return fmaxf(__fmaf_rn(-2.f, ip, __fadd_rn(qv, xv)), 0.f);
}

// A block scores BM = 32 * MI queries: 8 warps of 2 (queries) x 4 (rows),
// a warp MI m16 tiles (16 * MI queries) x 4 n8 tiles (32 rows). k <= 32
// takes MI = 4 (each dataset tile then serves 128 queries); larger k MI =
// 2, its lists twice as long. (Two blocks an SM of 64 queries x 64 rows
// measured 7% slower at k = 10.)
__host__ __device__ constexpr int knn_mi(int S) { return S == 1 ? 4 : 2; }

// shared memory of a block, in bytes, without its ring; dw is the padded
// depth in words
inline size_t knn_smem_fixed(int S, int dw, bool resident) {
  const size_t bm = 32 * knn_mi(S);
  return ((resident ? bm * (dw + 8) : 0) + bm * 4 * 32 * S) * 4 +
         bm * (8 + 4 + 4);
}
// a stage: its rows (and the queries' columns when not resident), then
// the tile's row norms (copied with a tile's first stage)
inline size_t knn_stage_bytes(int S, bool resident) {
  return (size_t)(kKnnBN + (resident ? 0 : 32 * knn_mi(S))) * kKnnLd * 4 +
         kKnnBN * 4;
}

template <typename XT, int S, int M>
__global__ void __launch_bounds__(kKnnThreads, 1) knn_kernel(KnnArgs a) {
  constexpr int KP = 32 * S;
  constexpr int MI = knn_mi(S);
  constexpr int BM = 32 * MI;            // queries a block
  constexpr int QW = BM / 8;             // queries a warp owns (lists)
  constexpr int EPW = 4 / sizeof(XT);  // elements a word
  constexpr int E = kKnnWords * EPW;   // elements of a row a stage
  constexpr int VPE = 16 / sizeof(XT); // elements a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment group, thread in it
  const int wm = warp >> 2, wn = warp & 3; // warp tile: 16 MI queries x 32 rows
  const int dw = a.d_pad / EPW;
  const int qld = dw + 8;
  const int R = a.stages;
  const int stage_rows = kKnnBN + (a.resident ? 0 : BM);
  const int stage_words = stage_rows * kKnnLd + kKnnBN;
  unsigned* Qres = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* ring = Qres + (a.resident ? BM * qld : 0);
  // per query: list (KP values, KP ids), then buffer (KP values, KP ids)
  float* lists = reinterpret_cast<float*>(ring + R * stage_words);
  u64* qthr = reinterpret_cast<u64*>(lists + BM * 4 * KP);
  int* qcount = reinterpret_cast<int*>(qthr + BM);
  float* kthv = reinterpret_cast<float*>(qcount + BM);

  const int q0 = blockIdx.x * BM, nq = min(BM, a.q - q0);
  const int split = blockIdx.y;
  const int row_begin = split * a.chunk;
  const int row_end = min(a.n, row_begin + a.chunk);
  const XT* Q = reinterpret_cast<const XT*>(a.Q);
  const XT* X = reinterpret_cast<const XT*>(a.X);

  for (int e = tid; e < BM * KP; e += kKnnThreads) {
    float* ld = lists + (e / KP) * 4 * KP;
    ld[e % KP] = CUDART_INF_F;
    reinterpret_cast<int*>(ld + KP)[e % KP] = kEmptyId;
  }
  if (tid < BM) {
    qthr[tid] = kNoBound;
    qcount[tid] = 0;
    kthv[tid] = CUDART_INF_F;
  }
  if (a.resident) {  // the query tile, zero padded
    for (int e = tid; e < BM * dw; e += kKnnThreads) {
      const int r = e / dw, w = e - (e / dw) * dw;
      unsigned word = 0;
      XT* wp = reinterpret_cast<XT*>(&word);
#pragma unroll
      for (int h = 0; h < EPW; ++h) {
        const int c = w * EPW + h;
        if (r < nq && c < a.d) wp[h] = Q[(size_t)(q0 + r) * a.d + c];
      }
      Qres[r * qld + w] = word;
    }
  }
  // the query row of fragment row (mi, h) of this thread
  auto qrow = [&](int mi, int h) { return wm * 16 * MI + mi * 16 + h * 8 + g; };
  float qnr[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qnr[mi][h] = qrow(mi, h) < nq ? a.qn[q0 + qrow(mi, h)] : 0.f;

  const int nck = a.d_pad / E;
  const int ntile = (row_end - row_begin + kKnnBN - 1) / kKnnBN;
  const int nst = ntile * nck;
  // stage s: tile s / nck, columns (s % nck) * E ..; rows 0..127 of the
  // stage are the tile's, 128.. the queries' (when not resident)
  auto load_stage = [&](int s) {
    const int tile = s / nck, ck = s - tile * nck;
    unsigned* st = ring + (s % R) * stage_words;
    if (ck == 0 && tid < kKnnBN) {  // the tile's norms
      float* xn_s = reinterpret_cast<float*>(st + stage_rows * kKnnLd);
      const int row = row_begin + tile * kKnnBN + tid;
      cp_async4(xn_s + tid, a.xn + (row < row_end ? row : 0),
                row < row_end);
    }
    if (a.resident && a.vec) {  // 4 rows a thread, one column vector
      const int col = ck * E + (tid & 7) * VPE;
      const int r0 = row_begin + tile * kKnnBN + (tid >> 3);
#pragma unroll
      for (int i = 0; i < kKnnBN * 8 / kKnnThreads; ++i) {
        const int row = r0 + i * (kKnnThreads / 8);
        const bool valid = row < row_end && col < a.d;
        cp_async16(st + ((tid >> 3) + i * (kKnnThreads / 8)) * kKnnLd +
                       (tid & 7) * 4,
                   X + (valid ? (size_t)row * a.d + col : (size_t)0), valid);
      }
      return;
    }
    for (int v = tid; v < stage_rows * 8; v += kKnnThreads) {
      const int rr = v >> 3, col = ck * E + (v & 7) * VPE;
      const XT* src;
      bool valid;
      if (rr < kKnnBN) {
        const int row = row_begin + tile * kKnnBN + rr;
        valid = row < row_end && col < a.d;
        src = X + (valid ? (size_t)row * a.d + col : (size_t)0);
      } else {
        const int r = rr - kKnnBN;
        valid = r < nq && col < a.d;
        src = Q + (valid ? (size_t)(q0 + r) * a.d + col : (size_t)0);
      }
      unsigned* dst = st + rr * kKnnLd + (v & 7) * 4;
      if (a.vec) {
        cp_async16(dst, src, valid);
      } else {  // unaligned rows: element loads, zero past d
        unsigned w4[4] = {0u, 0u, 0u, 0u};
        XT* wp = reinterpret_cast<XT*>(w4);
#pragma unroll
        for (int h = 0; h < VPE; ++h)
          if (valid && col + h < a.d) wp[h] = src[h];
        *reinterpret_cast<uint4*>(dst) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
      }
    }
  };

  // each warp merges its QW queries' buffers into their lists and
  // publishes the lists' k-th keys as the queries' shared bounds
  auto merge_buffers = [&]() {
    for (int rr = 0; rr < QW; ++rr) {
      const int r = warp * QW + rr;
      const int cnt = min(qcount[r], KP);
      if (cnt == 0) continue;  // uniform across the warp
      float* ld = lists + r * 4 * KP;
      int* li = reinterpret_cast<int*>(ld + KP);
      float* bd = ld + 2 * KP;
      int* bi = reinterpret_cast<int*>(ld + 3 * KP);
      const u64 thr = queue_flush<S>(ld, li, bd, bi, cnt, a.k, qthr[r]);
      if (lane == 0) {
        if (thr < qthr[r]) atomicMax(a.bound + q0 + r, ~thr);
        qthr[r] = thr;
        kthv[r] = key_value(thr);
        qcount[r] = 0;
      }
    }
  };

  for (int s = 0; s < R - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  float acc[MI][4][4];
  float xnr[4][2];
  u64 gbound[MI][2];  // the queries' shared bounds, read at a tile's start
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_n(R - 2);
    __syncthreads();  // stage s landed; stage s - 1's slot is free
    if (s + R - 1 < nst) load_stage(s + R - 1);
    cp_async_commit();
    const int tile = s / nck, ck = s - tile * nck;
    const int t0 = row_begin + tile * kKnnBN;
    const unsigned* xs = ring + (s % R) * stage_words;
    if (ck == 0) {
      const float* xn_s =
          reinterpret_cast<const float*>(xs + stage_rows * kKnnLd);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          xnr[ni][j] = xn_s[wn * 32 + ni * 8 + 2 * t + j];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          gbound[mi][h] =
              qrow(mi, h) < nq ? load_l2(a.bound + q0 + qrow(mi, h)) : 0;
    }
    const unsigned* qs = a.resident ? Qres + ck * kKnnWords
                                    : xs + kKnnBN * kKnnLd;
    const int qst = a.resident ? qld : kKnnLd;
#pragma unroll
    for (int kk = 0; kk < kKnnWords / 8; ++kk) {
      // the fragments' k index t holds word 2t of the 8-word step and
      // k index t + 4 word 2t + 1, in both operands (a bijection of the
      // step's words, so the products cover the same depth): one 64-bit
      // load a row instead of two 32-bit ones
      unsigned af[MI][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int o = (wm * 16 * MI + mi * 16 + g) * qst + kk * 8 + 2 * t;
        const uint2 r0 = *reinterpret_cast<const uint2*>(qs + o);
        const uint2 r1 = *reinterpret_cast<const uint2*>(qs + o + 8 * qst);
        af[mi][0] = r0.x;
        af[mi][1] = r1.x;
        af[mi][2] = r0.y;
        af[mi][3] = r1.y;
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            xs + (wn * 32 + ni * 8 + g) * kKnnLd + kk * 8 + 2 * t);
        bf[ni][0] = b.x;
        bf[ni][1] = b.y;
      }
      if constexpr (sizeof(XT) == 4) {
        unsigned ah[MI][4], al[MI][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int c = 0; c < 4; ++c) split_tf32(af[mi][c], ah[mi][c], al[mi][c]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) split_tf32(bf[ni][c], bh[ni][c], bl[ni][c]);
        // small terms first; 4 MI independent accumulators between the
        // dependent passes
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
      } else {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
      }
    }
    if (ck != nck - 1) continue;

    // epilog of the tile: c[h * 2 + j] of fragment (mi, ni) becomes the
    // distance of query row qrow(mi, h) to tile row wn*32 + ni*8 + 2t + j;
    // bit ((mi * 2 + h) * 4 + ni) * 2 + j of `pend` marks a candidate not
    // yet in its query's buffer
    const bool full = nq == BM && t0 + kKnnBN <= row_end;  // block-uniform
    float kv[MI][2];  // the queries' thresholds: own k-th, shared bound
    u64 pend = 0;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = qrow(mi, h);
        // at most the largest float: one compare also leaves out +inf
        kv[mi][h] = fminf(fminf(kthv[r], 3.4028235e38f),
                          gbound[mi][h] ? key_value(~gbound[mi][h])
                                        : CUDART_INF_F);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = knn_dist<M>(acc[mi][ni][h * 2 + j], qnr[mi][h],
                                  xnr[ni][j]);
            if (!full && (r >= nq || t0 + wn * 32 + ni * 8 + 2 * t + j >=
                                         row_end))
              v = CUDART_INF_F;
            acc[mi][ni][h * 2 + j] = v;
            if (v <= kv[mi][h])
              pend |= 1ull << (((mi * 2 + h) * 4 + ni) * 2 + j);
          }
      }
    // candidates go to their query's buffer (a shared counter a query); a
    // candidate that finds its buffer full stays pending, and then the
    // owners merge every buffer and the pending ones try again under the
    // tighter threshold. In most tiles nothing passes or every candidate
    // finds room, and the tile costs one barrier.
    auto append = [&]() {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = qrow(mi, h);
          const float lim = fminf(kthv[r], kv[mi][h]);
          float* bd = lists + r * 4 * KP + 2 * KP;
          int* bi = reinterpret_cast<int*>(bd + KP);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const u64 bit = 1ull << (((mi * 2 + h) * 4 + ni) * 2 + j);
              if (!(pend & bit)) continue;
              const float v = acc[mi][ni][h * 2 + j];
              if (v <= lim) {
                const int pos = atomicAdd(qcount + r, 1);
                if (pos >= KP) continue;  // full: again after a merge
                bd[pos] = v;
                bi[pos] = t0 + wn * 32 + ni * 8 + 2 * t + j;
              }
              pend &= ~bit;
            }
        }
    };
    if (pend) append();
    if (__syncthreads_or(pend != 0)) {
      do {
        merge_buffers();
        __syncthreads();
        append();
      } while (__syncthreads_or(pend != 0));
    }
  }
  __syncthreads();
  merge_buffers();
  __syncwarp();

  for (int rr = 0; rr < QW; ++rr) {
    const int r = warp * QW + rr;
    if (r >= nq) break;
    const float* ld = lists + r * 4 * KP;
    const int* li = reinterpret_cast<const int*>(ld + KP);
    const size_t o = ((size_t)(q0 + r) * a.splits + split) * a.k;
    for (int j = lane; j < a.k; j += 32) {
      a.pd[o + j] = ld[j];
      a.pi[o + j] = li[j];
    }
  }
}

template <typename XT, int S, int M>
cudaError_t launch_knn(KnnArgs a, int epilog, float* outd, int* outi,
                       cudaStream_t stream) {
  static int optin = 0;        // once a process (one device)
  static size_t attr_bytes = 0;
  cudaError_t err;
  if (!optin) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  constexpr int EPW = 4 / sizeof(XT), E = kKnnWords * EPW;
  constexpr int BM = 32 * knn_mi(S);
  a.d_pad = (a.d + E - 1) / E * E;
  const int dw = a.d_pad / EPW;
  // the query tile stays resident when a ring of at least 4 stages fits
  // beside it; the ring takes as many stages as fit (at most 8)
  auto depth = [&](bool res) {
    const size_t fixed = knn_smem_fixed(S, dw, res);
    if (fixed >= (size_t)optin) return 0;
    const size_t fit = ((size_t)optin - fixed) / knn_stage_bytes(S, res);
    return fit < (size_t)kKnnMaxStages ? (int)fit : kKnnMaxStages;
  };
  a.resident = depth(true) >= 4;
  a.stages = depth(a.resident);
  if (a.stages < 3) return cudaErrorInvalidValue;
  const size_t smem = knn_smem_fixed(S, dw, a.resident) +
                      (size_t)a.stages * knn_stage_bytes(S, a.resident);
  if (smem > attr_bytes) {
    err = cudaFuncSetAttribute(knn_kernel<XT, S, M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attr_bytes = smem;
  }
  dim3 grid((a.q + BM - 1) / BM, a.splits);
  knn_kernel<XT, S, M><<<grid, kKnnThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(a.pd, a.pi, a.q, a.splits * a.k, a.k, epilog, outd,
                      outi, stream);
}

template <typename XT, int M>
cudaError_t launch_knn_m(const KnnArgs& a, int epilog, float* outd,
                         int* outi, cudaStream_t stream) {
  if (a.k <= 32) return launch_knn<XT, 1, M>(a, epilog, outd, outi, stream);
  return launch_knn<XT, 2, M>(a, epilog, outd, outi, stream);
}

template <typename XT>
cudaError_t launch_knn_t(const KnnArgs& a, int epilog, float* outd,
                         int* outi, cudaStream_t stream) {
  if (a.metric == kInnerProduct)
    return launch_knn_m<XT, kInnerProduct>(a, epilog, outd, outi, stream);
  if (a.metric == kCosine)
    return launch_knn_m<XT, kCosine>(a, epilog, outd, outi, stream);
  return launch_knn_m<XT, kL2>(a, epilog, outd, outi, stream);
}

}  // namespace raft_tpu_torch

using namespace raft_tpu_torch;

// Plain C entry for ctypes. Q (q, d) in the dataset's type (float32, or
// bfloat16 when x_bf16); X (n, d) float32 or bfloat16; qn (q,), xn (n,)
// f32 squared norms; dataset rows split into `splits` chunks of `chunk`
// rows (a multiple of 128); pd/pi (q, splits, k) scratch; bound (q,)
// 8-byte words, set to 0 here (the queries' shared bounds); outd/outi
// (q, k). k <= 64. Returns the cudaError_t of the launches.
extern "C" int raft_fused_knn(const void* Q, const void* qn, const void* X,
                              const void* xn, int x_bf16, int q, int n, int d,
                              int k, int metric, int epilog, int splits,
                              int chunk, void* pd, void* pi, void* bound,
                              void* outd, void* outi, void* stream) {
  if (k < 1 || k > 64 || q < 1 || d < 1 || chunk % kKnnBN ||
      (long long)splits * chunk < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t esize = x_bf16 ? 2 : 4;
  KnnArgs a{Q, (const float*)qn, X, (const float*)xn, q, n, d, k, metric,
            chunk, splits, 0, 0, 0, 0, (float*)pd, (int*)pi, (u64*)bound};
  const cudaError_t err = cudaMemsetAsync(bound, 0, (size_t)q * sizeof(u64), s);
  if (err != cudaSuccess) return (int)err;
  a.vec = ((size_t)d * esize) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  if (x_bf16)
    return (int)launch_knn_t<__nv_bfloat16>(a, epilog, (float*)outd,
                                            (int*)outi, s);
  return (int)launch_knn_t<float>(a, epilog, (float*)outd, (int*)outi, s);
}
