// Fused emulator kernels for Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of linna_tpu/ops/fused.py:
//   linna_fused_apply     <- _apply_impl     (the ChtoModelv2 trunk, one launch)
//   linna_fused_log_prob  <- _log_prob_impl  (whitened walker -> one log-posterior f32)
//
// What bounds them: per walker 2.52 MFLOP for the trunk (+0.42 MFLOP for the
// 457x457 chi^2 product) against 5.03 MB (+0.84 MB) of weights per launch at
// the DES width (27 -> 457, hidden 1000), so operations bound the work, not
// bytes.  On the TPU every weight sits in VMEM for the whole launch.  Here
// the weights are far above one SM's 227 KB of shared memory, so they stream
// from global memory (they stay resident in the 50 MB L2 across blocks and
// launches).
//
// fused_apply_kernel, on the tensor cores.  Its f32 work at 4096 rows is
// 10.3 GFLOP: 0.154 ms at the 67 TFLOP/s of the CUDA cores.  f32 accuracy on
// the TF32 tensor cores takes three products per product (3xTF32: each
// operand split into a TF32 big part and the remainder; a_small*b_big +
// a_big*b_small, then a_big*b_big, summed in f32), so its bound there is
// 3 x FLOPs / 494.7 TFLOP/s: 0.0625 ms at 4096 rows, 0.0039 ms at 256.  The
// design: one cooperative launch of SMs x 4 blocks, which walk the work
// items of the trunk's 10 products in turn, with a grid barrier after each
// product.  lin1 and skip of a residual block read the same input and form
// one product of two segments.  The activations live in a global scratch
// (two ping-pong buffers and the inner-channel buffer, row strides
// multiples of 4 floats; ~33 MB at 4096 rows, so they stay in L2 beside
// the weights).  A work item is a 64 x 64 output tile: 4 warps of
// mma.sync.m16n8k8 TF32, each warp a 32 x 32 quarter; K runs in chunks of
// 32 staged by cp.async into a 3-stage ring in shared memory, so the next
// chunks' copies overlap this chunk's products.  Each weight is thus read
// from L2 once per 64-row tile, and each value staged in shared memory
// feeds a whole fragment.  The epilogue runs on the accumulators in
// registers: bias, alpha, the skip output a residual block's lin2 adds,
// relu per segment, and stores of rows < nrows only, every load before any
// store.  At the sampler's 128-256 rows a product has only 4-64 tiles, and
// one block walks a tile's k-chunks in sequence, so a product with fewer
// tiles than blocks splits its k-chunks over more blocks (at least 2
// chunks each); their partial tiles go to the scratch, and after one more
// grid barrier every block sums a share of them in a fixed order and
// applies the epilogue.  The scratch is written by other SMs before a
// barrier, so it is read only through L2 (cp.async.cg, ld.global.cg),
// never through the read-only or L1 path.  On the card (PERF.md) the
// k-loop is bound by L2 bandwidth for the tiles that each block re-reads
// and by the instructions that feed mma.sync (the splits, the fragment
// loads), not by the tensor cores.
//
// fused_log_prob_kernel: thread-block clusters of 8 blocks (the portable
// cluster size).  A cluster takes R walkers and block rank q computes
// columns [q N/8, (q+1) N/8) (edges rounded to multiples of 4) of every
// product for all R walkers, so each weight is read from L2 once per
// cluster.  Every block keeps the full-width activations of its cluster's
// walkers; each product's epilogue writes its values into the destination
// buffer of all 8 blocks through distributed shared memory, and one cluster
// barrier per product completes them (it is the block barrier too, and
// orders the ping-pong buffers' reuse).  lin1 and skip of a residual block
// read the same input and run as one product.  The chi^2 product gives each
// block its columns of C^-1 delta and their part of delta . C^-1 delta,
// which rank 0 sums in a fixed order.
//
// What bounds it at the sampler's 128-256 walkers is latency, not the FMA
// rate: a launch is a chain of 11 products, each a round of weight loads,
// a split-K reduction, an epilogue and a cluster barrier (on-chip timings in
// PERF.md).  So the 11 products run as one loop over a table in shared
// memory (one code path, so the instruction cache stays warm); a thread task
// is a tile of 8 walkers x 4 columns (each activation word read from shared
// memory feeds 4 FMAs, each weight 8); the epilogue constants of a block's
// columns are copied to shared memory once per launch; and the epilogue
// does all its loads before any store into a peer.  R is 8, 16 or 24, the
// fewest that let all of a launch's clusters be resident at once (a cluster
// must fit in one GPC, and the H100's GPCs hold 15 clusters of 8 one-block
// SMs, so 16 clusters of 8 walkers at 128 rows would take two waves), or
// the most that fit a block's shared memory, in more than one wave.
//
// Semantics kept from the TPU kernels: f32 accumulation; log10 lanes take
// log10(max(x, 1e-30)) and flag the row when any masked physical value is
// <= 0; such a row, or a NaN log-posterior, gives -inf.  Rows past the batch
// are computed on zeros and never stored (no padding by repeating row 0).

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // threads per block of fused_log_prob_kernel
constexpr int kWeights = 23;  // layer1 (2) + 3 resblocks (5 each) + layers 6/7/8 (2 each)
constexpr int kCluster = 8;    // blocks per cluster of fused_log_prob_kernel
// linna_fused_log_prob's return values when no cluster fits on the card, and
// when the model is too wide for one block's threads or shared memory
constexpr int kNoCluster = 1 << 20;
constexpr int kTooWide = kNoCluster + 1;

struct TrunkWeights {
  const float* w[kWeights];
};

struct TrunkDims {
  int in, h, h2, h4, h8, c1, c2, c3, l6, out;
  int width;  // row stride of the two activation buffers (>= every trunk width, multiple of 4)
  int hmax;   // row stride of the inner-channel buffer (multiple of 4)
  int ldx;    // row stride of the whitened-input buffer (multiple of 4)
};

struct LikeArgs {
  const uint8_t* is_gauss;  // bool[D]
  const float* arg1;        // f32[D]
  const float* arg2;        // f32[D]
  const float* x_mean;      // f32[D]
  const float* x_std;       // f32[D]
  const uint8_t* x_log10;   // bool[D]
  const float* y_mean;      // f32[N]
  const float* y_std;       // f32[N]
  const float* sigma;       // f32[N]
  const float* data;        // f32[N]
  const float* inv_cov;     // f32[N, N]
  const float* temperature; // f32[1]
  int ypositive;
};

// ------------------------------------------- fused_apply on the tensor cores

constexpr int kBM = 64;             // rows of an output tile
constexpr int kBN = 64;             // columns of an output tile
constexpr int kBK = 32;             // k of one stage of the ring
constexpr int kStages = 3;          // stages of the cp.async ring
constexpr int kWarpsM = 2;          // warps down a tile's rows
constexpr int kWarpsN = 2;          // warps across its columns
constexpr int kApplyThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;  // m16 fragments of a warp's part of the tile
constexpr int kNT = kBN / kWarpsN / 8;   // n8 fragments
// Row strides of a stage's tiles in shared memory, padded so that the 32
// lanes' fragment loads fall in 32 different banks.
constexpr int kLdA = kBK + 4;
constexpr int kLdW = kBN + 8;
constexpr int kStageFloats = kBM * kLdA + kBK * kLdW;
constexpr size_t kApplySmem = sizeof(float) * kStages * kStageFloats;
// layer1, 3 x (lin1 | skip, lin2), layers 6, 7, 8
constexpr int kApplyProducts = 10;
// the fewest k-chunks of one part of a product split over blocks
constexpr int kMinSplitChunks = 2;

// One output segment of a product: out[r, c] = relu?((in[r, :] @ W[:, c] +
// bias[c]) * alpha (+ out[r, c] when accum)) for c < n.
struct ApplySeg {
  const float* W;     // [K, n], row-major
  const float* bias;  // [n] or nullptr
  float* out;
  int ld;             // row stride of out
  int n;
  int col_tiles;      // ceil(n / kBN); 0 for an absent segment
  float alpha;
  bool relu, accum;
  bool vec;           // W's rows are 16-byte aligned: 16-byte copies
};

// One product: segments that read the same input (a residual block's lin1
// and skip; other products leave seg[1] empty).  Its k-chunks are split
// into `split` ranges, each a work item of its own (plan_apply).
struct ApplyProduct {
  const float* in;  // [nrows, K], row stride ld
  int ld, K;
  bool vec;         // in's rows are 16-byte aligned
  int split;
  ApplySeg seg[2];
};

struct ApplyPlan {
  ApplyProduct prod[kApplyProducts];
  float* part;  // split products' partial tiles, [work item][kBM][kBN]
  int nrows, row_tiles;
  int deal;     // block b takes the work items i = b * deal mod blocks (plan_apply)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes through L2 only (.cg: the scratch is written by other SMs before
// a grid barrier, so it must not come from a stale L1 line); the bytes past
// `bytes` are zero-filled, and none is read when `bytes` is 0.
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// 4 bytes (or a zero when `bytes` is 0), for rows that are not 16-byte
// aligned: the weights and the input x only, which nothing in the launch writes.
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = big + small: big is v with the 13 low mantissa bits that TF32 does
// not hold cleared, small = v - big (exact in f32, |small| < 2^-10 |v|),
// which the tensor cores read as TF32 by dropping its own low bits, an
// error below 2^-20 |v|.  Two instructions; cvt.rna.tf32.f32 compiles to
// four with a predicate, and the splits, not the products, bound a warp's
// instruction issue.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// d += a (16 x 8, row-major) @ b (8 x 8, column-major) in TF32, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// What one tile reads: rows [row0, row0 + kBM) of `in` and columns
// [col0, col0 + kBN) of W.
struct TileSrc {
  const float* in;
  const float* W;
  int ld, K, n, nrows, row0, col0;
  bool vec_in, vec_w;
};

// Stage k-chunk [k0, k0 + kBK) of the tile: sa[r][k] = in[row0 + r, k0 + k],
// sw[k][c] = W[k0 + k, col0 + c]; zeros past nrows, K and n.
__device__ __forceinline__ void load_chunk(const TileSrc& t, int k0, float* sa, float* sw) {
  if (t.vec_in) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / 4 / kApplyThreads; ++it) {
      const int i = threadIdx.x + it * kApplyThreads;
      const int r = i / (kBK / 4), k = (i % (kBK / 4)) * 4;
      const int row = t.row0 + r;
      const int bytes = row < t.nrows ? 4 * max(0, min(4, t.K - k0 - k)) : 0;
      copy16(sa + r * kLdA + k, bytes ? t.in + (size_t)row * t.ld + k0 + k : t.in, bytes);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kBM * kBK / kApplyThreads; ++it) {
      const int i = threadIdx.x + it * kApplyThreads;
      const int r = i / kBK, k = i % kBK;
      const int row = t.row0 + r;
      const bool ok = row < t.nrows && k0 + k < t.K;
      copy4(sa + r * kLdA + k, ok ? t.in + (size_t)row * t.ld + k0 + k : t.in, ok ? 4 : 0);
    }
  }
  if (t.vec_w) {
#pragma unroll
    for (int it = 0; it < kBK * kBN / 4 / kApplyThreads; ++it) {
      const int i = threadIdx.x + it * kApplyThreads;
      const int k = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const int bytes = k0 + k < t.K ? 4 * max(0, min(4, t.n - t.col0 - c)) : 0;
      copy16(sw + k * kLdW + c, bytes ? t.W + (size_t)(k0 + k) * t.n + t.col0 + c : t.W, bytes);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kBK * kBN / kApplyThreads; ++it) {
      const int i = threadIdx.x + it * kApplyThreads;
      const int k = i / kBN, c = i % kBN;
      const bool ok = k0 + k < t.K && t.col0 + c < t.n;
      copy4(sw + k * kLdW + c, ok ? t.W + (size_t)(k0 + k) * t.n + t.col0 + c : t.W, ok ? 4 : 0);
    }
  }
}

// acc += this warp's part of sa @ sw over one chunk, in 3xTF32.  Fragment
// layouts of m16n8k8 (g = lane / 4, q = lane % 4): A holds rows g, g + 8
// and columns q, q + 4; B rows (k) q, q + 4 and column g; the sums rows g,
// g + 8 and columns 2q, 2q + 1.  Each of the three passes is kMT x kNT
// independent products, so no product waits on the one before it.
__device__ __forceinline__ void mma_chunk(const float* sa, const float* sw, int wm, int wn, int g,
                                          int q, float (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t a_big[kMT][4], a_small[kMT][4], b_big[kNT][2], b_small[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const float* a = sa + (wm * kMT * 16 + i * 16 + g) * kLdA + kk + q;
      split_tf32(a[0], a_big[i][0], a_small[i][0]);
      split_tf32(a[8 * kLdA], a_big[i][1], a_small[i][1]);
      split_tf32(a[4], a_big[i][2], a_small[i][2]);
      split_tf32(a[8 * kLdA + 4], a_big[i][3], a_small[i][3]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* b = sw + (kk + q) * kLdW + wn * kNT * 8 + j * 8 + g;
      split_tf32(b[0], b_big[j][0], b_small[j][0]);
      split_tf32(b[4 * kLdW], b_big[j][1], b_small[j][1]);
    }
    // the two small cross terms first, then the big product
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], a_small[i], b_big[j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], a_big[i], b_small[j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], a_big[i], b_big[j]);
    }
  }
}

// The output value of segment s from its sum v over k; skip: the output
// lin2 adds to (0 for other segments).
__device__ __forceinline__ float epilogue(const ApplySeg& s, float v, float bias, float skip) {
  const float y = (v + bias) * s.alpha + skip;
  return s.relu ? fmaxf(y, 0.f) : y;
}

// One 64 x 64 output tile of segment s of product P over k-chunks [c0, c1)
// through the ring.  Then the epilogue from the accumulators, or, when P is
// split, the raw sums into `part` ([kBM][kBN]).
__device__ void apply_tile(const ApplyProduct& P, const ApplySeg& s, int nrows, int row0, int col0,
                           int c0, int c1, float* part, float* smem) {
  const TileSrc t{P.in, s.W, P.ld, P.K, s.n, nrows, row0, col0, P.vec, s.vec};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, g = lane / 4, q = lane % 4;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  // chunk c goes to stage (c - c0) % kStages
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    float* st = smem + i * kStageFloats;
    if (c0 + i < c1) load_chunk(t, (c0 + i) * kBK, st, st + kBM * kLdA);
    copy_commit();
  }
  for (int c = c0; c < c1; ++c) {
    copy_wait<kStages - 2>();
    // chunk c has landed for every thread, and every warp is done with
    // chunk c - 1, whose stage the next copies overwrite
    __syncthreads();
    if (c + kStages - 1 < c1) {
      float* st = smem + ((c - c0 + kStages - 1) % kStages) * kStageFloats;
      load_chunk(t, (c + kStages - 1) * kBK, st, st + kBM * kLdA);
    }
    copy_commit();
    const float* st = smem + ((c - c0) % kStages) * kStageFloats;
    mma_chunk(st, st + kBM * kLdA, wm, wn, g, q, acc);
  }
  copy_wait<0>();
  __syncthreads();  // the ring is free for the next tile

  if (part != nullptr) {
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * kMT * 16 + i * 16 + g + h * 8;
          const int c = wn * kNT * 8 + j * 8 + 2 * q;
          *reinterpret_cast<float2*>(part + r * kBN + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
    return;
  }

  // the epilogue: every load (bias, the skip output lin2 adds to) before any
  // store, since a store could alias a later load and would hold it back
  float* const out = s.out;
  const int ld = s.ld, n = s.n;
  float bias[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + wn * kNT * 8 + j * 8 + 2 * q + e;
      bias[j][e] = s.bias != nullptr && c < n ? __ldg(s.bias + c) : 0.f;
    }
  }
  float skip[kMT][kNT][4] = {};
  if (s.accum) {
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + wm * kMT * 16 + i * 16 + g + (e / 2) * 8;
          const int c = col0 + wn * kNT * 8 + j * 8 + 2 * q + e % 2;
          if (r < nrows && c < n) skip[i][j][e] = __ldcg(out + (size_t)r * ld + c);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = epilogue(s, acc[i][j][e], bias[j][e % 2], skip[i][j][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * kMT * 16 + i * 16 + g + (e / 2) * 8;
        const int c = col0 + wn * kNT * 8 + j * 8 + 2 * q + e % 2;
        if (r < nrows && c < n) out[(size_t)r * ld + c] = acc[i][j][e];
      }
    }
  }
}

// Tile `tile` of product P: its segment, first row and first column.
__device__ __forceinline__ const ApplySeg& tile_of(const ApplyProduct& P, int row_tiles, int tile,
                                                   int& row0, int& col0) {
  const int ct = tile / row_tiles, n0 = P.seg[0].col_tiles;
  row0 = (tile % row_tiles) * kBM;
  col0 = (ct < n0 ? ct : ct - n0) * kBN;
  return P.seg[ct < n0 ? 0 : 1];
}

// The trunk on nrows rows (ApplyPlan: make_apply_plan, plan_apply).  Each
// product's work items (its tiles, or tiles x k ranges when it is split)
// go round the grid's blocks; a grid barrier then makes the product's
// outputs visible to every block before the next product reads them.  A
// split product has one more barrier, after which its partial tiles are
// summed in a fixed order and the epilogue applied, by all threads of the
// grid.  4 blocks an SM (at most 128 registers a thread, ~100 bytes
// spilled) ran faster at 4096 rows than 3 blocks without the spill.
__global__ void __launch_bounds__(kApplyThreads, 4)
fused_apply_kernel(const __grid_constant__ ApplyPlan plan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  constexpr int kTile = kBM * kBN;
  // the first work item of this block (plan_apply: a product with few
  // items spreads them over many SMs)
  const int rank = (int)((long long)blockIdx.x * plan.deal % gridDim.x);
#pragma unroll 1
  for (int p = 0; p < kApplyProducts; ++p) {
    const ApplyProduct& P = plan.prod[p];
    const int tiles = plan.row_tiles * (P.seg[0].col_tiles + P.seg[1].col_tiles);
    const int split = P.split, nk = (P.K + kBK - 1) / kBK;
    for (int item = rank; item < tiles * split; item += gridDim.x) {
      const int tile = item / split, part = item % split;
      int row0, col0;
      const ApplySeg& s = tile_of(P, plan.row_tiles, tile, row0, col0);
      apply_tile(P, s, plan.nrows, row0, col0, part * nk / split, (part + 1) * nk / split,
                 split > 1 ? plan.part + (size_t)item * kTile : nullptr, smem);
    }
    if (split > 1) {
      grid.sync();
      for (int e = rank * kApplyThreads + threadIdx.x; e < tiles * kTile;
           e += gridDim.x * kApplyThreads) {
        const int tile = e / kTile, at = e % kTile;
        int row0, col0;
        const ApplySeg& s = tile_of(P, plan.row_tiles, tile, row0, col0);
        const int r = row0 + at / kBN, c = col0 + at % kBN;
        if (r >= plan.nrows || c >= s.n) continue;
        const float* sums = plan.part + (size_t)tile * split * kTile + at;
        float v = 0.f;
#pragma unroll 4
        for (int q = 0; q < split; ++q) v += __ldcg(sums + (size_t)q * kTile);
        float* dst = s.out + (size_t)r * s.ld + c;
        const float bias = s.bias != nullptr ? __ldg(s.bias + c) : 0.f;
        *dst = epilogue(s, v, bias, s.accum ? __ldcg(dst) : 0.f);
      }
    }
    if (p + 1 < kApplyProducts) grid.sync();
  }
}

// ------------------------------------------------ fused_log_prob on clusters

constexpr int kRowTile = 8;    // walkers of one thread task
constexpr int kColTile = 4;    // columns of one thread task: each activation read feeds 4 FMAs
constexpr int kMaxGroups = 3;  // row groups of kRowTile walkers per cluster: at most 24 walkers
constexpr int kItems = 8;      // epilogue values per thread and product, at most
// the products of one launch: layer1, 3 x (lin1 | skip, lin2), layers 6, 7, 8, chi^2
constexpr int kProducts = 11;
constexpr int kDeltaProduct = 9;  // layer 8, whose epilogue gives delta

// The first column of an n-wide product that cluster rank q computes (q = 8
// gives n): q n / 8 rounded up to a multiple of 4.
__host__ __device__ inline int slice_edge(int n, int q) {
  const int e = ((q * n / kCluster) + 3) & ~3;
  return e < n ? e : n;
}

// Row stride of the buffer A, which holds the input and the outputs of the
// residual blocks 1 and 3 and of layers 7 and 8 (B holds the wider ones).
__host__ __device__ inline int narrow_width(const TrunkDims& d) {
  const int a = d.in > d.h2 ? d.in : d.h2;
  const int b = d.h8 > d.out ? d.h8 : d.out;
  return ((a > b ? a : b) + 3) & ~3;
}

// Output width of product p.
__host__ __device__ inline int product_width(const TrunkDims& d, int p) {
  const int w[kProducts] = {d.h,  d.c1 + d.h2, d.h2, d.c2 + d.h4, d.h4, d.c3 + d.h8,
                            d.h8, d.l6,        d.out, d.out,      d.out};
  return w[p];
}

// Epilogue constants of one block: per product and column the bias, and for
// layer 8 also y_std, y_mean, sigma and data.
__host__ __device__ inline int cst_floats(const TrunkDims& d) {
  int total = 0;
  for (int p = 0; p < kProducts; ++p) {
    total += (p == kDeltaProduct ? 5 : 1) * (product_width(d, p) / kCluster + 4);
  }
  return (total + 3) & ~3;
}

// One output segment of a product: out[r, c] = epilogue(in[r, :] @ W[:, c]), c < n.
struct Seg {
  const float* W;     // [K, n], row-major
  const float* bias;  // [n] or nullptr
  float* out;         // this block's buffer; every peer's copy is at the same offset
  int ld;             // row stride of out
  int n;
  bool relu;
};

// What the epilogue does with a column's sum s (b: the bias, or 0).
enum class Out {
  kPush,   // relu?((s + b) * alpha) into every block of the cluster
  kAccum,  // relu?((s + b) * alpha + this block's out) into every block
  kDelta,  // m = (s + b) * y_std + y_mean, exp(m) when ypositive; m * sigma - data into every block
  kLocal,  // s + b into this block only
};

// One product of the launch, as this block computes it: the columns of s0
// and then of s1 form one range (the residual blocks' lin1 and skip read the
// same input; other products leave s1.n = 0), of which the block takes
// [c0, c0 + ncols).  A thread task is a tile of kRowTile walkers x kColTile
// columns g, g + ngc, ... (neighbouring threads read neighbouring weights)
// over one of `split` ranges of kchunk k.
struct Product {
  Seg s0, s1;
  const float* in;  // this block's input buffer
  float* cst;       // this block's epilogue constants (see cst_floats)
  int ld_in, K;
  float alpha;
  Out mode;
  int c0, ncols, ngc, tiles, split, kchunk;
};

constexpr size_t kProductBytes = (sizeof(Product) * kProducts + 15) & ~size_t(15);

__device__ void plan_product(Product& P, int R, int rank) {
  const int n = P.s0.n + P.s1.n;
  P.c0 = slice_edge(n, rank);
  P.ncols = slice_edge(n, rank + 1) - P.c0;
  P.ngc = (P.ncols + kColTile - 1) / kColTile;
  P.tiles = P.ngc * (R / kRowTile);
  // as many k ranges as the threads allow (tiles <= kThreads: plan_log_prob),
  // but none shorter than 4
  P.split = P.tiles == 0 ? 0 : min(kThreads / P.tiles, (P.K + 3) / 4);
  P.kchunk = P.split == 0 ? 0 : (((P.K + P.split - 1) / P.split) + 3) & ~3;
}

struct Task {
  const float* w[kColTile];  // column i's weights at w[i] + k * ldw[i]
  int ldw[kColTile];
  int g, r0, part, k0, k1;
};

__device__ __forceinline__ Task make_task(const Product& P, int task) {
  Task t;
  t.g = task % P.ngc;
  t.r0 = (task % P.tiles) / P.ngc * kRowTile;
  t.part = task / P.tiles;
  t.k0 = t.part * P.kchunk;
  t.k1 = min(P.K, t.k0 + P.kchunk);
#pragma unroll
  for (int i = 0; i < kColTile; ++i) {
    // a padding column past the range reads a real one and is never stored
    const int j = P.c0 + min(t.g + i * P.ngc, P.ncols - 1);
    t.w[i] = j < P.s0.n ? P.s0.W + j : P.s1.W + (j - P.s0.n);
    t.ldw[i] = j < P.s0.n ? P.s0.n : P.s1.n;
  }
  return t;
}

// acc[r][i] += sum_{k0 <= k < k1} in[r, k] * w_i[k] for the task's tile.  A
// step of 4 k keeps 16 weight loads in flight and reads one broadcast float4
// of activations per walker, which feeds 16 FMAs (the shared-memory-to-
// register path moves 32 words a clock per SM against 128 FMAs).
// in + r * ld_in + k0 must be 16-byte aligned.
__device__ __forceinline__ void tile_sums(const Task& t, const float* in, int ld_in,
                                          float (&acc)[kRowTile][kColTile]) {
  int k = t.k0;
  for (; k + 4 <= t.k1; k += 4) {
    float wv[4][kColTile];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < kColTile; ++i) wv[kk][i] = __ldg(t.w[i] + (k + kk) * t.ldw[i]);
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(in + r * ld_in + k);
#pragma unroll
      for (int i = 0; i < kColTile; ++i) {
        acc[r][i] = fmaf(a.x, wv[0][i], acc[r][i]);
        acc[r][i] = fmaf(a.y, wv[1][i], acc[r][i]);
        acc[r][i] = fmaf(a.z, wv[2][i], acc[r][i]);
        acc[r][i] = fmaf(a.w, wv[3][i], acc[r][i]);
      }
    }
  }
  for (; k < t.k1; ++k) {
    float w1[kColTile];
#pragma unroll
    for (int i = 0; i < kColTile; ++i) w1[i] = __ldg(t.w[i] + k * t.ldw[i]);
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      const float a = in[r * ld_in + k];
#pragma unroll
      for (int i = 0; i < kColTile; ++i) acc[r][i] = fmaf(a, w1[i], acc[r][i]);
    }
  }
}

// Shared memory of one block for R walkers: the product table, then B, A,
// H, the split-K scratch, the whitened input, ln prior, the bad-row flag,
// the chi^2 partials and the epilogue constants.
__host__ __device__ inline size_t cluster_smem_bytes(const TrunkDims& d, int R) {
  return kProductBytes +
         sizeof(float) * ((size_t)R * (d.width + narrow_width(d) + d.hmax + d.ldx + 2 + kCluster) +
                          (size_t)kThreads * kRowTile * kColTile + cst_floats(d));
}

__global__ void __launch_bounds__(kThreads, 1)
fused_log_prob_kernel(const float* __restrict__ x, int nrows, int R, TrunkWeights w, TrunkDims d,
                      LikeArgs a, float* __restrict__ lp) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lb = d.width;          // row stride of B
  const int la = narrow_width(d);  // row stride of A
  Product* prods = reinterpret_cast<Product*>(smem4);
  float* B = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + kProductBytes);
  float* A = B + R * lb;
  float* H = A + R * la;
  float* red = H + R * d.hmax;
  float* X = red + kThreads * kRowTile * kColTile;
  float* lnprior = X + R * d.ldx;
  int* bad = reinterpret_cast<int*>(lnprior + R);
  float* partial = lnprior + 2 * R;  // [kCluster][R]: the chi^2 partials, on rank 0
  float* cst = partial + kCluster * R;
  const int row0 = (blockIdx.x / kCluster) * R;
  const int D = d.in;
  const int N = d.out;

  // the product table: layer1 (A -> B), residual blocks (B -> A, A -> B,
  // B -> A; lin1 into H and skip as one product, then lin2 adds to the
  // skip's output), layers 6 (A -> B), 7 (B -> A), 8 (A -> B, delta), then
  // this block's columns of C^-1 delta into its own A (no peer writes A any
  // more)
  if (threadIdx.x == 0) {
    const Seg none{nullptr, nullptr, nullptr, 0, 0, false};
    int np = 0;
    float* c = cst;
    auto add = [&](const float* in, int ld_in, int K, Seg s0, Seg s1, float alpha, Out mode) {
      Product& P = prods[np++];
      P.s0 = s0;
      P.s1 = s1;
      P.in = in;
      P.ld_in = ld_in;
      P.K = K;
      P.alpha = alpha;
      P.mode = mode;
      plan_product(P, R, rank);
      P.cst = c;
      c += (mode == Out::kDelta ? 5 : 1) * P.ncols;
    };
    add(A, la, D, Seg{w.w[0], w.w[1], B, lb, d.h, true}, none, 1.f, Out::kPush);
    const int in_w[3] = {d.h, d.h2, d.h4};
    const int ch[3] = {d.c1, d.c2, d.c3};
    const int out_w[3] = {d.h2, d.h4, d.h8};
    for (int i = 0; i < 3; ++i) {
      const int b = 2 + 5 * i;  // (lin1 w, lin1 b, lin2 w, lin2 b, skip w)
      const float* src = i == 1 ? A : B;
      float* dst = i == 1 ? B : A;
      const int ls = i == 1 ? la : lb, ldst = i == 1 ? lb : la;
      add(src, ls, in_w[i], Seg{w.w[b], w.w[b + 1], H, d.hmax, ch[i], true},
          Seg{w.w[b + 4], nullptr, dst, ldst, out_w[i], false}, 1.f, Out::kPush);
      add(H, d.hmax, ch[i], Seg{w.w[b + 2], w.w[b + 3], dst, ldst, out_w[i], true}, none, 0.1f,
          Out::kAccum);
    }
    add(A, la, d.h8, Seg{w.w[17], w.w[18], B, lb, d.l6, true}, none, 1.f, Out::kPush);
    add(B, lb, d.l6, Seg{w.w[19], w.w[20], A, la, N, true}, none, 1.f, Out::kPush);
    add(A, la, N, Seg{w.w[21], w.w[22], B, lb, N, false}, none, 1.f, Out::kDelta);
    add(B, lb, N, Seg{a.inv_cov, nullptr, A, la, N, false}, none, 1.f, Out::kLocal);
  }
  if (threadIdx.x < R) bad[threadIdx.x] = 0;
  __syncthreads();

  // the epilogue constants of this block's columns
  for (int p = 0; p < kProducts; ++p) {
    const Product& P = prods[p];
    for (int jj = threadIdx.x; jj < P.ncols; jj += blockDim.x) {
      const int j = P.c0 + jj;
      const bool first = j < P.s0.n;
      const int col = first ? j : j - P.s0.n;
      const float* bias = first ? P.s0.bias : P.s1.bias;
      P.cst[jj] = bias ? __ldg(bias + col) : 0.f;
      if (P.mode == Out::kDelta) {
        P.cst[P.ncols + jj] = __ldg(a.y_std + col);
        P.cst[2 * P.ncols + jj] = __ldg(a.y_mean + col);
        P.cst[3 * P.ncols + jj] = __ldg(a.sigma + col);
        P.cst[4 * P.ncols + jj] = __ldg(a.data + col);
      }
    }
  }
  // 1-3 (in every block of the cluster): prior transform, log10 lanes (with
  // the bad-row flag), standardize
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, k = i % D;
    const float xw = row0 + r < nrows ? x[(size_t)(row0 + r) * D + k] : 0.f;
    X[r * d.ldx + k] = xw;
    const float lo = a.arg1[k], hi = a.arg2[k];
    float phys;
    if (a.is_gauss[k]) {
      phys = xw * hi + lo;
    } else {
      const float u = 0.5f * (1.f + erff(xw / 1.41421356237309515f));
      phys = u * (hi - lo) + lo;
    }
    float xin = phys;
    if (a.x_log10[k]) {
      if (phys <= 0.f) atomicOr(&bad[r], 1);
      xin = log10f(fmaxf(phys, 1e-30f));
    }
    A[r * la + k] = (xin - a.x_mean[k]) / a.x_std[k];
  }
  // every block of the cluster has started, and holds its input, before any
  // block writes into a peer
  cluster.sync();
  if (threadIdx.x < R) {
    float q = 0.f;
    for (int k = 0; k < D; ++k) q += X[threadIdx.x * d.ldx + k] * X[threadIdx.x * d.ldx + k];
    lnprior[threadIdx.x] = -0.5f * q;
  }

  // 4-6: the products, one code path for all (the instruction cache stays
  // warm).  A thread takes one task and leaves its sums in `red`; then each
  // thread loads the sums of its epilogue values before it stores any (a
  // store into a peer would otherwise hold back every later load).  One
  // cluster barrier after each product: its writes into the peers are then
  // complete, and no block reads a buffer that a peer's next product
  // overwrites.  The last (chi^2) writes only this block's A.
#pragma unroll 1
  for (int p = 0; p < kProducts; ++p) {
    const Product& P = prods[p];
    const int ld_red = P.ngc * kColTile;
    if ((int)threadIdx.x < P.tiles * P.split) {
      const Task t = make_task(P, threadIdx.x);
      float acc[kRowTile][kColTile];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
#pragma unroll
        for (int i = 0; i < kColTile; ++i) acc[r][i] = 0.f;
      }
      tile_sums(t, P.in + t.r0 * P.ld_in, P.ld_in, acc);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
#pragma unroll
        for (int i = 0; i < kColTile; ++i) {
          red[(t.part * R + t.r0 + r) * ld_red + t.g + i * P.ngc] = acc[r][i];
        }
      }
    }
    __syncthreads();
    // the epilogue of this thread's values idx = threadIdx.x + it * kThreads
    // (walker idx / ncols, column c0 + idx % ncols): every load (the split
    // sums, the constants, the output a residual block adds to) comes before
    // any store, since a store into a peer would hold back every later load
    const int ncols = P.ncols, c0 = P.c0, s0n = P.s0.n, nsplit = P.split, mode = (int)P.mode;
    const float alpha = P.alpha;
    const float* cst = P.cst;
    float* const out0 = P.s0.out;
    float* const out1 = P.s1.out;
    const int ld0 = P.s0.ld, ld1 = P.s1.ld;
    const bool relu0 = P.s0.relu, relu1 = P.s1.relu;
    float y[kItems];
    float* dst[kItems];
    int row[kItems], col[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      row[it] = ncols > 0 ? idx / ncols : R;  // row R: no value
      col[it] = idx - row[it] * ncols;
      y[it] = 0.f;
    }
    for (int q = 0; q < nsplit; ++q) {
      const float* part = red + q * R * ld_red;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        if (row[it] >= R) break;
        y[it] += part[row[it] * ld_red + col[it]];
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (row[it] >= R) break;
      const int r = row[it], jj = col[it];
      const bool first = c0 + jj < s0n;
      dst[it] = first ? out0 + r * ld0 + c0 + jj : out1 + r * ld1 + c0 + jj - s0n;
      float v = (y[it] + cst[jj]) * alpha;
      if (mode == (int)Out::kAccum) v += *dst[it];
      if (first ? relu0 : relu1) v = fmaxf(v, 0.f);
      if (mode == (int)Out::kDelta) {
        float m = v * cst[ncols + jj] + cst[2 * ncols + jj];
        if (a.ypositive) m = expf(m);
        v = m * cst[3 * ncols + jj] - cst[4 * ncols + jj];
      }
      y[it] = v;
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (row[it] >= R) break;
      if (mode == (int)Out::kLocal) {
        *dst[it] = y[it];
      } else {
#pragma unroll
        for (int q = 0; q < kCluster; ++q) *cluster.map_shared_rank(dst[it], q) = y[it];
      }
    }
    if (p + 1 < kProducts) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }

  // 6 (end): this block's part of delta . (C^-1 delta), one warp per
  // walker, into rank 0's partials
  const Product& chi2 = prods[kProducts - 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += blockDim.x / 32) {
    float q = 0.f;
    for (int c = chi2.c0 + lane; c < chi2.c0 + chi2.ncols; c += 32) {
      q += B[r * lb + c] * A[r * la + c];
    }
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
    if (lane == 0) *cluster.map_shared_rank(partial + rank * R + r, 0) = q;
  }
  // the last cluster barrier: after it no block touches a peer's shared
  // memory, so every block may leave
  cluster.sync();

  // 7 (rank 0): chi^2 summed over the ranks in order, tempered likelihood +
  // unit-normal prior; NaN or a bad row -> -inf
  if (rank == 0 && (int)threadIdx.x < R && row0 + (int)threadIdx.x < nrows) {
    const int r = threadIdx.x;
    float q = 0.f;
    for (int p = 0; p < kCluster; ++p) q += partial[p * R + r];
    const float v = -0.5f * q * (1.f / a.temperature[0]) + lnprior[r];
    lp[row0 + r] = (isnan(v) || bad[r]) ? -INFINITY : v;
  }
}

int round4(int v) { return (v + 3) & ~3; }

TrunkDims make_dims(const int* dims) {
  TrunkDims d;
  d.in = dims[0];
  d.h = dims[1];
  d.h2 = dims[2];
  d.h4 = dims[3];
  d.h8 = dims[4];
  d.c1 = dims[5];
  d.c2 = dims[6];
  d.c3 = dims[7];
  d.l6 = dims[8];
  d.out = dims[9];
  int wmax = d.in;
  const int ws[5] = {d.h, d.h2, d.l6, d.out, d.h4};
  for (int v : ws) wmax = wmax > v ? wmax : v;
  d.width = round4(wmax);
  int hm = d.c1 > d.c2 ? d.c1 : d.c2;
  hm = hm > d.c3 ? hm : d.c3;
  d.hmax = round4(hm);
  d.ldx = round4(d.in);
  return d;
}

TrunkWeights make_weights(const void* const* ptrs) {
  TrunkWeights w;
  for (int i = 0; i < kWeights; ++i) w.w[i] = static_cast<const float*>(ptrs[i]);
  return w;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Floats of fused_apply's activations over nrows rows: the ping-pong
// buffers A and B (row stride width) and the inner-channel buffer H (row
// stride hmax).  The scratch holds them and then the partial tiles of the
// split products (ApplyLaunch::part_floats).
size_t apply_act_floats(int nrows, const TrunkDims& d) {
  return (size_t)nrows * (2 * d.width + d.hmax);
}

bool rows_aligned16(const void* p, int ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

ApplySeg apply_seg(const float* W, const float* bias, float* out, int ld, int n, float alpha,
                   bool relu, bool accum) {
  return ApplySeg{W, bias, out, ld, n, (n + kBN - 1) / kBN, alpha, relu, accum,
                  rows_aligned16(W, n)};
}

ApplyProduct apply_product(const float* in, int ld, int K, ApplySeg s0,
                           ApplySeg s1 = ApplySeg{}) {
  return ApplyProduct{in, ld, K, rows_aligned16(in, ld), 1, {s0, s1}};
}

// The 10 products of the trunk on nrows rows of x, through the scratch:
// layer1 (x -> B), residual blocks (B -> A, A -> B, B -> A; lin1 into H and
// skip as one product, then lin2 adds to the skip's output), layers 6
// (A -> B), 7 (B -> A) and 8 (A -> out).
ApplyPlan make_apply_plan(const float* x, int nrows, const TrunkWeights& w, const TrunkDims& d,
                          float* out, float* scratch) {
  ApplyPlan P{};
  P.nrows = nrows;
  P.row_tiles = (nrows + kBM - 1) / kBM;
  float* A = scratch;
  float* B = A + (size_t)nrows * d.width;
  float* H = B + (size_t)nrows * d.width;
  const int ld = d.width;
  int p = 0;
  P.prod[p++] = apply_product(x, d.in, d.in, apply_seg(w.w[0], w.w[1], B, ld, d.h, 1.f, true, false));
  const int in_w[3] = {d.h, d.h2, d.h4};
  const int ch[3] = {d.c1, d.c2, d.c3};
  const int out_w[3] = {d.h2, d.h4, d.h8};
  float* src = B;
  float* dst = A;
  for (int i = 0; i < 3; ++i) {
    const float* const* q = w.w + 2 + 5 * i;  // lin1 w, lin1 b, lin2 w, lin2 b, skip w
    P.prod[p++] = apply_product(src, ld, in_w[i],
                                apply_seg(q[0], q[1], H, d.hmax, ch[i], 1.f, true, false),
                                apply_seg(q[4], nullptr, dst, ld, out_w[i], 1.f, false, false));
    P.prod[p++] = apply_product(H, d.hmax, ch[i],
                                apply_seg(q[2], q[3], dst, ld, out_w[i], 0.1f, true, true));
    float* t = src;
    src = dst;
    dst = t;
  }
  // after three blocks the activation is in A (src)
  P.prod[p++] = apply_product(A, ld, d.h8, apply_seg(w.w[17], w.w[18], B, ld, d.l6, 1.f, true, false));
  P.prod[p++] = apply_product(B, ld, d.l6, apply_seg(w.w[19], w.w[20], A, ld, d.out, 1.f, true, false));
  P.prod[p++] = apply_product(A, ld, d.out,
                              apply_seg(w.w[21], w.w[22], out, d.out, d.out, 1.f, false, false));
  return P;
}

// The cooperative launch of fused_apply_kernel.
struct ApplyLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  int sms;            // the card's SMs
  int per_sm;         // blocks of the kernel an SM holds at once
  int max_items;      // the most work items of any product
  size_t part_floats; // the split products' partial tiles
};

// Sets the kernel's dynamic shared-memory limit, sizes the grid (every
// block the card holds at once: a cooperative launch may have no more) and
// splits the k-chunks of each product whose tiles are fewer than the
// blocks, into as many ranges of at least kMinSplitChunks chunks as keep
// its work items within the grid.  At the sampler's 128-256 rows a product
// has 4-64 tiles, and one block walks a tile's k-chunks in sequence.
cudaError_t plan_apply(ApplyPlan& P, cudaStream_t stream, ApplyLaunch* L) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&L->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = prepare(fused_apply_kernel, kApplySmem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&L->per_sm, fused_apply_kernel,
                                                        kApplyThreads, kApplySmem);
  }
  if (err != cudaSuccess) return err;
  // a grid the card cannot hold at once is refused at launch
  // (cudaErrorCooperativeLaunchTooLarge)
  const int grid = std::max(1, L->sms * L->per_sm);
  L->max_items = 1;
  L->part_floats = 0;
  for (ApplyProduct& p : P.prod) {
    const int tiles = P.row_tiles * (p.seg[0].col_tiles + p.seg[1].col_tiles);
    const int nk = (p.K + kBK - 1) / kBK;
    p.split = std::max(1, std::min(grid / std::max(tiles, 1), nk / kMinSplitChunks));
    L->max_items = std::max(L->max_items, tiles * p.split);
    if (p.split > 1) L->part_floats = std::max(L->part_floats, (size_t)tiles * p.split * kBM * kBN);
  }
  L->attr.id = cudaLaunchAttributeCooperative;
  L->attr.val.cooperative = 1;
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3(grid);
  // Work item i goes to block i * 37 mod grid (deal is 37's inverse mod
  // grid; 37 is prime, and a grid that 37 divides keeps items in block
  // order).  The card places consecutive blocks on the few SMs of one GPC
  // before the next, so blocks 0..31 of a 4-per-SM grid share 8 SMs; a
  // stride of 37 blocks spreads a product's first items over the GPCs.
  P.deal = 1;
  if (grid % 37 != 0) {
    while ((long long)P.deal * 37 % grid != 1) ++P.deal;
  }
  L->cfg.blockDim = dim3(kApplyThreads);
  L->cfg.dynamicSmemBytes = kApplySmem;
  L->cfg.stream = stream;
  L->cfg.attrs = &L->attr;
  L->cfg.numAttrs = 1;
  return cudaSuccess;
}

// The launch of fused_log_prob_kernel over nrows walkers, groups x 8 of
// them per cluster.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  int walkers;       // per cluster
  int max_clusters;  // the most clusters of this shape the card holds at once
};

// Sets the kernel's dynamic shared-memory limit to the launch's and asks how
// many clusters of the launch's shape the card holds at once.
cudaError_t prepare_cluster(ClusterLaunch* L) {
  const cudaError_t err = prepare(fused_log_prob_kernel, L->cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(&L->max_clusters, (const void*)fused_log_prob_kernel,
                                        &L->cfg);
}

// Whether, at R walkers per cluster, a block's shared memory fits in
// smem_max bytes and every block's part of every product is one task per
// thread at most and kItems epilogue values per thread.
bool fits_block(const TrunkDims& d, int R, int smem_max) {
  if (cluster_smem_bytes(d, R) > (size_t)smem_max) return false;
  for (int p = 0; p < kProducts; ++p) {
    const int n = product_width(d, p);
    for (int q = 0; q < kCluster; ++q) {
      const int ncols = slice_edge(n, q + 1) - slice_edge(n, q);
      const int tiles = (ncols + kColTile - 1) / kColTile * (R / kRowTile);
      if (tiles > kThreads || R * ncols > kItems * kThreads) return false;
    }
  }
  return true;
}

// Walkers per cluster: the fewest row groups (8 walkers each) whose clusters
// all fit on the card at once, so that a launch is one wave (a cluster of 8
// blocks must fit in one GPC, and the H100's GPCs hold 15 at one block per
// SM, not 132 / 8); else the most that fit a block, in more than one wave
// (the LSST width, 40 -> 1560, fits 8 walkers in the 227 KB of shared memory
// a block may have, not 16).  Returns kTooWide when not even one row group
// fits a block.
int plan_log_prob(int nrows, const TrunkDims& d, cudaStream_t stream, ClusterLaunch* L) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (!fits_block(d, kRowTile, smem_max)) return kTooWide;
  for (int groups = 1;; ++groups) {
    const int R = groups * kRowTile;
    L->walkers = R;
    L->attr.id = cudaLaunchAttributeClusterDimension;
    L->attr.val.clusterDim.x = kCluster;
    L->attr.val.clusterDim.y = 1;
    L->attr.val.clusterDim.z = 1;
    L->cfg = cudaLaunchConfig_t{};
    L->cfg.gridDim = dim3(((nrows + R - 1) / R) * kCluster);  // a multiple of the cluster size
    L->cfg.blockDim = dim3(kThreads);
    L->cfg.dynamicSmemBytes = cluster_smem_bytes(d, R);
    L->cfg.stream = stream;
    L->cfg.attrs = &L->attr;
    L->cfg.numAttrs = 1;
    err = prepare_cluster(L);
    if (err != cudaSuccess) return err;
    if (groups == kMaxGroups || !fits_block(d, R + kRowTile, smem_max) ||
        (int)L->cfg.gridDim.x / kCluster <= L->max_clusters) {
      return cudaSuccess;
    }
  }
}

}  // namespace

extern "C" {

// dims: in, h, h/2, h/4, h/8, c, 2c, 4c, layer6 width, out.
// weights: 23 device pointers in the JAX package's _flatten_params order.
// scratch: scratch_floats >= linna_apply_scratch_floats(nrows, dims)
// floats, 16-byte aligned.  Returns a cudaError_t (0 on success;
// cudaErrorCooperativeLaunchTooLarge when the card cannot hold the grid at
// once); the launch does not synchronise.
int linna_fused_apply(const float* x, int nrows, const void* const* weights, const int* dims,
                      float* out, float* scratch, long long scratch_floats, void* stream) {
  if (nrows <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0) return cudaErrorMisalignedAddress;
  const TrunkDims d = make_dims(dims);
  ApplyPlan P = make_apply_plan(x, nrows, make_weights(weights), d, out, scratch);
  ApplyLaunch L{};
  cudaError_t err = plan_apply(P, static_cast<cudaStream_t>(stream), &L);
  if (err != cudaSuccess) return err;
  const size_t act = apply_act_floats(nrows, d);
  if ((size_t)scratch_floats < act + L.part_floats) return cudaErrorInvalidValue;
  P.part = scratch + act;
  err = cudaLaunchKernelEx(&L.cfg, fused_apply_kernel, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The floats of linna_fused_apply's scratch over nrows rows on the current
// device, or minus a cudaError_t.
long long linna_apply_scratch_floats(int nrows, const int* dims) {
  if (nrows <= 0) return 0;
  const TrunkDims d = make_dims(dims);
  ApplyPlan P = make_apply_plan(nullptr, nrows, TrunkWeights{}, d, nullptr, nullptr);
  ApplyLaunch L{};
  const cudaError_t err = plan_apply(P, 0, &L);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)(apply_act_floats(nrows, d) + L.part_floats);
}

// like: is_gauss, arg1, arg2, x_mean, x_std, x_log10, y_mean, y_std, sigma,
// data, inv_cov, temperature (12 device pointers).
// Returns a cudaError_t, or kNoCluster / kTooWide when no cluster of the
// launch's shape fits on the card or the model is too wide for the kernel
// (linna_error_string says which); the launch does not synchronise.
int linna_fused_log_prob(const float* x, int nrows, const void* const* weights, const int* dims,
                         const void* const* like, int ypositive, float* lp, void* stream) {
  if (nrows <= 0) return 0;
  const TrunkDims d = make_dims(dims);
  const TrunkWeights w = make_weights(weights);
  LikeArgs a;
  a.is_gauss = static_cast<const uint8_t*>(like[0]);
  a.arg1 = static_cast<const float*>(like[1]);
  a.arg2 = static_cast<const float*>(like[2]);
  a.x_mean = static_cast<const float*>(like[3]);
  a.x_std = static_cast<const float*>(like[4]);
  a.x_log10 = static_cast<const uint8_t*>(like[5]);
  a.y_mean = static_cast<const float*>(like[6]);
  a.y_std = static_cast<const float*>(like[7]);
  a.sigma = static_cast<const float*>(like[8]);
  a.data = static_cast<const float*>(like[9]);
  a.inv_cov = static_cast<const float*>(like[10]);
  a.temperature = static_cast<const float*>(like[11]);
  a.ypositive = ypositive;
  ClusterLaunch L;
  const int planned = plan_log_prob(nrows, d, static_cast<cudaStream_t>(stream), &L);
  if (planned != 0) return planned;
  if (L.max_clusters < 1) return kNoCluster;
  const cudaError_t err =
      cudaLaunchKernelEx(&L.cfg, fused_log_prob_kernel, x, nrows, L.walkers, w, d, a, lp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch shape of a kernel (0: fused_apply, 1: fused_log_prob) over
// nrows walkers, for the record; smem: dynamic shared memory per block.
// shape (9 + 10 ints), fused_apply: tile rows, tile columns, blocks,
// threads per block, blocks per SM, SMs, tile k, stages, the most work
// items of a product, then each product's k split; fused_log_prob:
// walkers per cluster, blocks per cluster, blocks, threads per block, the
// most clusters the card holds at once, then zeros.  Returns a cudaError_t.
int linna_launch_shape(int kernel, int nrows, const int* dims, int* shape, long long* smem) {
  const TrunkDims d = make_dims(dims);
  for (int i = 0; i < 9 + kApplyProducts; ++i) shape[i] = 0;
  if (kernel == 0) {
    ApplyPlan P = make_apply_plan(nullptr, nrows, TrunkWeights{}, d, nullptr, nullptr);
    ApplyLaunch L{};
    const cudaError_t err = plan_apply(P, 0, &L);
    const int v[9] = {kBM, kBN, (int)L.cfg.gridDim.x, kApplyThreads, L.per_sm, L.sms, kBK,
                      kStages, L.max_items};
    for (int i = 0; i < 9; ++i) shape[i] = v[i];
    for (int p = 0; p < kApplyProducts; ++p) shape[9 + p] = P.prod[p].split;
    *smem = (long long)kApplySmem;
    return err;
  }
  ClusterLaunch L;
  const int err = plan_log_prob(nrows, d, 0, &L);
  shape[0] = L.walkers;
  shape[1] = kCluster;
  shape[2] = (int)L.cfg.gridDim.x;
  shape[3] = kThreads;
  shape[4] = L.max_clusters;
  *smem = (long long)L.cfg.dynamicSmemBytes;
  return err;
}

const char* linna_error_string(int err) {
  if (err == kNoCluster) {
    return "no cluster of 8 blocks of this shape fits on the card "
           "(cudaOccupancyMaxActiveClusters gave 0)";
  }
  if (err == kTooWide) {
    return "this model is too wide for one block's threads or shared memory "
           "at 8 walkers per cluster";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
