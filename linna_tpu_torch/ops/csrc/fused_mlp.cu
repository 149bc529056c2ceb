// Fused emulator kernels for Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of linna_tpu/ops/fused.py:
//   linna_fused_apply     <- _apply_impl     (the ChtoModelv2 trunk, one launch)
//   linna_fused_log_prob  <- _log_prob_impl  (whitened walker -> one log-posterior f32)
//
// What bounds them: per walker 2.52 MFLOP for the trunk (+0.42 MFLOP for the
// 457x457 chi^2 product) against 5.03 MB (+0.84 MB) of weights per launch at
// the DES width (27 -> 457, hidden 1000); 8.10 MFLOP (+4.87) against 16.2 MB
// (+9.73) at the LSST width (40 -> 1560).  On the TPU every weight sits in
// VMEM for the whole launch.  Here the weights are far above one SM's 227 KB
// of shared memory, so they stream from global memory (they stay resident in
// the 50 MB L2 across blocks and launches).
//
// fused_log_prob has two designs, and the host picks one by the model's
// widths alone (ops/fused.py, log_prob_design): the tiled design, on the
// tensor cores like fused_apply, and the cluster design, on the CUDA cores,
// where a cluster of 8 blocks holds 16 or more walkers' activations (the
// DES width: 24; the LSST width: 8).
//
// The tiled designs (fused_apply_kernel, fused_log_prob_kernel): f32
// accuracy on the TF32 tensor cores takes three products per product
// (3xTF32: each operand split into a TF32 big part and the remainder;
// a_small*b_big + a_big*b_small, then a_big*b_big, summed in f32).  The
// trunk's f32 work at 4096 rows is 10.3 GFLOP at the DES width: 0.154 ms at
// the 67 TFLOP/s of the CUDA cores, 3 x FLOPs / 494.7 TFLOP/s = 0.0625 ms in
// 3xTF32, 0.0039 ms at 256 rows.  One cooperative launch, whose blocks walk
// the work items of the products in turn, with a grid barrier after each
// product.  lin1 and skip of a residual block read the same input and form
// one product of two segments.  The activations live in a global scratch
// (two ping-pong buffers and the inner-channel buffer, row strides
// multiples of 4 floats), small enough to stay in L2 beside the weights.  A
// work item is a 64 x 64 output tile: 4 warps of mma.sync.m16n8k8 TF32,
// each warp a 32 x 32 quarter; K runs in chunks of 32 staged by cp.async
// into a ring of stages in shared memory, so the next chunks' copies
// overlap this chunk's products.  Each weight is thus read from L2 once per
// 64-row tile, and each value staged in shared memory feeds a whole
// fragment.  The epilogue runs on the accumulators in registers: bias,
// alpha, the skip output a residual block's lin2 adds, relu per segment,
// and stores of rows < nrows only, every load before any store.  At the
// sampler's 128-256 rows a product has only 4-100 tiles, and one block
// walks a tile's k-chunks in sequence, so a product with few tiles splits
// its k-chunks over blocks (at least 2 chunks each); after one more grid
// barrier all threads of the grid sum the partial tiles in the order 0, 1,
// ... and apply the epilogue.  The scratch is written by other SMs before a
// barrier, so it is read only through L2 (cp.async.cg, ld.global.cg), never
// through the read-only or L1 path.  On the card (PERF.md) the k-loop is
// bound by the instructions that feed mma.sync (the splits, the fragment
// loads) and by L2, not by the tensor cores; a launch at the sampler's rows
// is bound by the chain of products, each a few rounds of L2 latency and
// one or two grid barriers (about 6 us a product at 128 rows).
//
// fused_apply_kernel: the trunk's 10 products, 4 blocks an SM; the split
// follows the launch's tiles (it is the trunk on its own, with no promise
// about rows launched together).
//
// fused_log_prob_kernel: a pass for layer 1's input (the prior transform of
// the whitened walkers, the log10 lanes, standardized), then 11 products,
// the trunk and the chi^2 product C^-1 delta; layer 8's epilogue gives
// delta = destandardize(y) (exp when ypositive) * sigma - data.  The last
// pass, one block a row, sums the chi^2 product's partial tiles, takes
// delta . C^-1 delta, the unit-normal prior and the bad-row flag, and
// writes the tempered log-posterior (-inf for a bad row or a NaN).  Every
// sum a row's value takes follows the model's width alone, never nrows:
// each product's k split is planned on the host from the widths
// (ops/fused.py, log_prob_plan), its parts are summed in order, every
// rounding of the epilogue is explicit, and where a launch has as many
// tiles as the grid has blocks one block sums a tile's k ranges in the same
// order (the `local` products: no partial tiles), to the same bits.  2
// blocks an SM of 5 stages and up to 255 registers a thread: at the
// sampler's rows the launch waits on L2 and barriers more than on issue,
// and the larger ring and the spill-free registers ran faster than 3 or 4
// blocks of 3 or 4 stages (PERF.md).  At the LSST width it reads each
// weight once per 64-row tile in one wave, where the cluster design reads
// them once per 8 walkers in 2-3 waves.
//
// Semantics kept from the TPU kernels: f32 accumulation; log10 lanes take
// log10(max(x, 1e-30)) and flag the row when any masked physical value is
// <= 0; such a row, or a NaN log-posterior, gives -inf.  Rows past the batch
// are staged as zeros and never stored (no padding by repeating row 0).

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWeights = 23;  // layer1 (2) + 3 resblocks (5 each) + layers 6/7/8 (2 each)
// linna_fused_log_prob's return value when the plan it is given does not
// match the model's widths or the scratch; linna_fused_log_prob_cluster's
// when no cluster of the launch's shape fits on the card, and when the
// model is too wide for one block's threads or shared memory
constexpr int kBadPlan = 1 << 20;
constexpr int kNoCluster = kBadPlan + 1;
constexpr int kTooWide = kBadPlan + 2;

struct TrunkWeights {
  const float* w[kWeights];
};

struct TrunkDims {
  int in, h, h2, h4, h8, c1, c2, c3, l6, out;
  int width;  // row stride of the two activation buffers (>= every trunk width, multiple of 4)
  int hmax;   // row stride of the inner-channel buffer (multiple of 4)
  int ldx;    // row stride of a whitened-input buffer (multiple of 4)
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

// ------------------------------------------------- products on the tensor cores

constexpr int kBM = 64;             // rows of an output tile
constexpr int kBN = 64;             // columns of an output tile
constexpr int kBK = 32;             // k of one stage of the ring
constexpr int kWarpsM = 2;          // warps down a tile's rows
constexpr int kWarpsN = 2;          // warps across its columns
constexpr int kApplyThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;  // m16 fragments of a warp's part of the tile
constexpr int kNT = kBN / kWarpsN / 8;   // n8 fragments
constexpr int kTile = kBM * kBN;
// Row strides of a stage's tiles in shared memory, padded so that the 32
// lanes' fragment loads fall in 32 different banks.
constexpr int kLdA = kBK + 4;
constexpr int kLdW = kBN + 8;
constexpr int kStageFloats = kBM * kLdA + kBK * kLdW;
// Stages of the cp.async ring and blocks an SM holds: fused_apply at 4
// blocks of 3 stages (128 registers a thread); fused_log_prob at 3 blocks
// of 4 stages (168 registers, almost no spill), whose launches at the
// sampler's rows wait on L2 more than on the issue of the products.
constexpr int kApplyStages = 3;
constexpr int kApplyBlocksPerSM = 4;
constexpr int kLikeStages = 5;
constexpr int kLikeBlocksPerSM = 2;
constexpr size_t kApplySmem = sizeof(float) * kApplyStages * kStageFloats;
constexpr size_t kLikeSmem = sizeof(float) * kLikeStages * kStageFloats;
// layer1, 3 x (lin1 | skip, lin2), layers 6, 7, 8
constexpr int kApplyProducts = 10;
// the same, then the chi^2 product
constexpr int kLikeProducts = 11;
// the fewest k-chunks of one part of a product split over blocks
constexpr int kMinSplitChunks = 2;

// One output segment of a product: out[r, c] = relu?((in[r, :] @ W[:, c] +
// bias[c]) * alpha (+ out[r, c] when accum)) for c < n; when delta, that
// value y then becomes (y * y_std[c] + y_mean[c], exp'd when ypositive) *
// sigma[c] - data[c]; when mask (composition_grad_kernel's backward), it
// becomes 0 where mask[r, c] (row stride ld) is not above 0: a ReLU's
// backward, read from the forward's output.  The member strides (floats
// from one member's W, bias, out and mask to the next) are read by
// composition_grad_kernel alone.
struct ApplySeg {
  const float* W;     // [K, n], row-major
  const float* bias;  // [n] or nullptr
  float* out;
  const float* mask;  // nullptr, or [nrows, n] with out's strides
  int ld;             // row stride of out
  int n;
  int col_tiles;      // ceil(n / kBN); 0 for an absent segment
  float alpha;
  int w_ms, b_ms, out_ms;
  bool relu, accum;
  bool vec;           // W's rows are 16-byte aligned: 16-byte copies
  bool delta;         // fused_log_prob's layer 8
};

// One product: segments that read the same input (a residual block's lin1
// and skip; other products leave seg[1] empty).  Its k-chunks are split
// into `split` ranges, each a work item of its own whose partial tiles are
// summed after a grid barrier, or, when `local`, all summed in order by the
// block of the tile (run_product).  composition_grad_kernel runs a product
// for `members` stacked members at once, member m reading in + m * in_ms
// (0: the members share the input) and its segments' strides.
struct ApplyProduct {
  const float* in;  // [nrows, K], row stride ld
  int ld, K;
  int split;
  int members, in_ms;
  bool vec;         // in's rows are 16-byte aligned
  bool local;
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

// The physical value of whitened lane k: the prior transform.
__device__ __forceinline__ float physical(const LikeArgs& a, float xw, int k) {
  const float lo = __ldg(a.arg1 + k), hi = __ldg(a.arg2 + k);
  if (a.is_gauss[k]) return xw * hi + lo;
  const float u = 0.5f * (1.f + erff(xw / 1.41421356237309515f));
  return u * (hi - lo) + lo;
}

// Layer 1's input at lane k: the physical value, log10(max(v, 1e-30)) on a
// log10 lane, standardized.
__device__ __forceinline__ float standardized(const LikeArgs& a, float xw, int k) {
  float v = physical(a, xw, k);
  if (a.x_log10[k]) v = log10f(fmaxf(v, 1e-30f));
  return (v - __ldg(a.x_mean + k)) / __ldg(a.x_std + k);
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

// Which kernel a product runs in: fused_apply's trunk, fused_log_prob's
// (layer 8 gives delta) or composition_grad's (delta, the members' strides
// and the ReLU masks of the backward).
enum class Epi { kApply, kLike, kGrad };

// The output value of segment s at column c from its sum v over k; skip:
// the output lin2 adds to (0 for other segments); mask: the forward's
// output a masked segment reads at this element (1 for the others).
// Rounded op by op (no contraction left to the compiler), so that the two
// places that apply it to a product give the same bits.
template <Epi kEpi>
__device__ __forceinline__ float epilogue(const ApplySeg& s, const LikeArgs* like, float v,
                                          float bias, float skip, int c, float mask = 1.f) {
  float y = __fmaf_rn(__fadd_rn(v, bias), s.alpha, skip);
  if (s.relu) y = fmaxf(y, 0.f);
  if (kEpi != Epi::kApply && s.delta) {
    float m = __fmaf_rn(y, __ldg(like->y_std + c), __ldg(like->y_mean + c));
    if (like->ypositive) m = expf(m);
    y = __fmaf_rn(m, __ldg(like->sigma + c), -__ldg(like->data + c));
  }
  if (kEpi == Epi::kGrad && !(mask > 0.f)) y = 0.f;
  return y;
}

// How apply_tile sums a tile's k-chunks.
enum class Sum {
  kWhole,  // chunks [c0, c1) in one sum, then the epilogue, or the raw sums into `part`
  kLocal,  // chunks [0, c1) in `split` parts, each from zero, added in order to a running
           // total kept in `part` (this block's slab) between them: the sum the split
           // products' partial tiles are given after a grid barrier, in one block
};

// The element (r, c) of a tile that fragment (i, j) half h of this lane
// holds: acc[i][j][2h] at column c and acc[i][j][2h + 1] at c + 1.
__device__ __forceinline__ int frag_at(int wm, int wn, int g, int q, int i, int j, int h) {
  return (wm * kMT * 16 + i * 16 + g + h * 8) * kBN + wn * kNT * 8 + j * 8 + 2 * q;
}

// One 64 x 64 output tile of segment s of product P over k-chunks [c0, c1)
// through the ring, summed as kHow says; then the epilogue from the
// accumulators, or, for kWhole with `part`, the raw sums into it
// ([kBM][kBN]).  kLocal gives the bits of a split product's partial tiles
// summed in run_product: a part's sum starts from zero, and the parts add
// to a total from zero in the order 0, 1, ..., rounded op by op.
// Member m of a composition_grad product reads and writes through the
// member strides; the other kernels have one member.
template <Sum kHow, int kStages, Epi kEpi>
__device__ __forceinline__ void apply_tile(const ApplyProduct& P, const ApplySeg& s, int m,
                                           int nrows, int row0, int col0, int c0, int c1,
                                           int split, float* part, float* smem,
                                           const LikeArgs* like) {
  const size_t mm = kEpi == Epi::kGrad ? (size_t)m : 0;
  const TileSrc t{P.in + mm * P.in_ms, s.W + mm * s.w_ms, P.ld, P.K, s.n, nrows, row0, col0,
                  P.vec, s.vec};
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
  // kLocal: the chunk that starts the next part (part r from r c1 / split)
  int range = 0, range_end = kHow == Sum::kLocal ? c1 / split : c1;
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
    if (kHow == Sum::kLocal && c == range_end) {
      // the total so far (from zero at the first part) plus this part, kept
      // in the slab; the next part starts from zero
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* at = reinterpret_cast<float2*>(part + frag_at(wm, wn, g, q, i, j, h));
            const float2 v = range > 0 ? __ldcg(at) : make_float2(0.f, 0.f);
            __stcg(at, make_float2(__fadd_rn(v.x, acc[i][j][2 * h]),
                                   __fadd_rn(v.y, acc[i][j][2 * h + 1])));
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
          }
        }
      }
      ++range;
      range_end = (range + 1) * c1 / split;
    }
    const float* st = smem + ((c - c0) % kStages) * kStageFloats;
    mma_chunk(st, st + kBM * kLdA, wm, wn, g, q, acc);
  }
  copy_wait<0>();
  __syncthreads();  // the ring is free for the next tile

  if (kHow == Sum::kLocal) {
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(part + frag_at(wm, wn, g, q, i, j, h)));
          acc[i][j][2 * h] = __fadd_rn(v.x, acc[i][j][2 * h]);
          acc[i][j][2 * h + 1] = __fadd_rn(v.y, acc[i][j][2 * h + 1]);
        }
      }
    }
  } else if (part != nullptr) {
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(part + frag_at(wm, wn, g, q, i, j, h)) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
    return;
  }

  // the epilogue: every load (bias, the skip output lin2 adds to, the
  // mask) before any store, since a store could alias a later load and
  // would hold it back
  float* const out = s.out + mm * s.out_ms;
  const float* const bias_m = s.bias != nullptr ? s.bias + mm * s.b_ms : nullptr;
  const int ld = s.ld, n = s.n;
  float bias[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + wn * kNT * 8 + j * 8 + 2 * q + e;
      bias[j][e] = bias_m != nullptr && c < n ? __ldg(bias_m + c) : 0.f;
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
  float mask[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mask[i][j][e] = 1.f;
    }
  }
  if (kEpi == Epi::kGrad && s.mask != nullptr) {
    const float* const mk = s.mask + mm * s.out_ms;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + wm * kMT * 16 + i * 16 + g + (e / 2) * 8;
          const int c = col0 + wn * kNT * 8 + j * 8 + 2 * q + e % 2;
          if (r < nrows && c < n) mask[i][j][e] = __ldcg(mk + (size_t)r * ld + c);
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
        const int c = col0 + wn * kNT * 8 + j * 8 + 2 * q + e % 2;
        acc[i][j][e] = epilogue<kEpi>(s, like, acc[i][j][e], bias[j][e % 2], skip[i][j][e],
                                      min(c, n - 1), mask[i][j][e]);
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

// One product on nrows rows: its work items (its tiles, or tiles x k
// ranges when it is split; composition_grad's for each member, the member
// before the tile) go round the grid's blocks; `rank` is this block's
// first.  A split product then waits at one more grid barrier, after which
// all threads of the grid sum its partial tiles (`part`,
// [tile][range][kBM][kBN]) in the order 0, 1, ... and apply the epilogue.
// A local product's tiles each sum their ranges in one block, in the same
// order, through the block's slab of `part`.  `reduce` false leaves a
// split product's partial tiles to the caller.  kEpi: the kernel (local
// products in fused_log_prob's and composition_grad's).
template <int kStages, Epi kEpi>
__device__ __forceinline__ void run_product(const ApplyProduct& P, int row_tiles, int nrows,
                                            float* part, int rank, float* smem,
                                            const LikeArgs* like, cg::grid_group& grid,
                                            bool reduce = true) {
  // a member's tiles, and all members'
  const int per = row_tiles * (P.seg[0].col_tiles + P.seg[1].col_tiles);
  const int tiles = kEpi == Epi::kGrad ? per * P.members : per;
  const int split = P.split, nk = (P.K + kBK - 1) / kBK;
  if (kEpi != Epi::kApply && P.local) {
    for (int tile = rank; tile < tiles; tile += gridDim.x) {
      const int m = kEpi == Epi::kGrad ? tile / per : 0;
      int row0, col0;
      const ApplySeg& s = tile_of(P, row_tiles, tile - m * per, row0, col0);
      apply_tile<Sum::kLocal, kStages, kEpi>(P, s, m, nrows, row0, col0, 0, nk, split,
                                             part + (size_t)blockIdx.x * kTile, smem, like);
    }
    return;
  }
  for (int item = rank; item < tiles * split; item += gridDim.x) {
    const int tile = item / split, range = item % split;
    const int m = kEpi == Epi::kGrad ? tile / per : 0;
    int row0, col0;
    const ApplySeg& s = tile_of(P, row_tiles, tile - m * per, row0, col0);
    apply_tile<Sum::kWhole, kStages, kEpi>(P, s, m, nrows, row0, col0, range * nk / split,
                                           (range + 1) * nk / split, split,
                                           split > 1 ? part + (size_t)item * kTile : nullptr,
                                           smem, like);
  }
  if (split == 1 || !reduce) return;
  grid.sync();
  for (int e = rank * kApplyThreads + threadIdx.x; e < tiles * kTile;
       e += gridDim.x * kApplyThreads) {
    const int tile = e / kTile, at = e % kTile;
    const size_t m = kEpi == Epi::kGrad ? tile / per : 0;
    int row0, col0;
    const ApplySeg& s = tile_of(P, row_tiles, tile - (int)m * per, row0, col0);
    const int r = row0 + at / kBN, c = col0 + at % kBN;
    if (r >= nrows || c >= s.n) continue;
    const float* sums = part + (size_t)tile * split * kTile + at;
    float v = 0.f;
#pragma unroll 4
    for (int q = 0; q < split; ++q) v = __fadd_rn(v, __ldcg(sums + (size_t)q * kTile));
    const size_t at_out = m * s.out_ms + (size_t)r * s.ld + c;
    float* dst = s.out + at_out;
    const float bias = s.bias != nullptr ? __ldg(s.bias + m * s.b_ms + c) : 0.f;
    const float mask = kEpi == Epi::kGrad && s.mask != nullptr ? __ldcg(s.mask + at_out) : 1.f;
    *dst = epilogue<kEpi>(s, like, v, bias, s.accum ? __ldcg(dst) : 0.f, c, mask);
  }
}

// The trunk on nrows rows (ApplyPlan: make_apply_plan, plan_apply), a grid
// barrier after each product.  4 blocks an SM (at most 128 registers a
// thread, ~100 bytes spilled) ran faster at 4096 rows than 3 blocks without
// the spill.
__global__ void __launch_bounds__(kApplyThreads, kApplyBlocksPerSM)
fused_apply_kernel(const __grid_constant__ ApplyPlan plan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  // the first work item of this block (plan_apply: a product with few
  // items spreads them over many SMs)
  const int rank = (int)((long long)blockIdx.x * plan.deal % gridDim.x);
#pragma unroll 1
  for (int p = 0; p < kApplyProducts; ++p) {
    run_product<kApplyStages, Epi::kApply>(plan.prod[p], plan.row_tiles, plan.nrows, plan.part, rank,
                                     smem, nullptr, grid);
    if (p + 1 < kApplyProducts) grid.sync();
  }
}

// ------------------------------------------------------- fused_log_prob

// One launch of fused_log_prob_kernel (make_like_plan, from the host's plan).
struct LikePlan {
  ApplyProduct prod[kLikeProducts];
  LikeArgs a;
  const float* x;     // [nrows, D], the whitened walkers
  float* xin;         // [nrows, ldx]: layer 1's input
  const float* delta; // [nrows, ld]: layer 8's output
  const float* cd;    // [nrows, ld]: C^-1 delta
  float* lp;          // [nrows]
  float* part;        // the split products' partial tiles, [tile][range][kBM][kBN], or the
                      // local products' slabs, [block][kBM][kBN]
  int nrows, row_tiles, deal, ld, ldx, D, N;
};

// The walker log-posterior on nrows rows: layer 1's input (the prior
// transform of the whitened walkers, log10 lanes, standardized) by all
// threads of the grid, then the products as in fused_apply_kernel, a grid
// barrier after each.  The chi^2 product's partial tiles are summed in the
// last pass, one block a row: C^-1 delta column by column (in the order of
// run_product's sum, or from A where the product is not split over
// blocks), its dot with delta, the prior and the bad-row flag, then lp.
__global__ void __launch_bounds__(kApplyThreads, kLikeBlocksPerSM)
fused_log_prob_kernel(const __grid_constant__ LikePlan plan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int rank = (int)((long long)blockIdx.x * plan.deal % gridDim.x);
  for (int i = blockIdx.x * kApplyThreads + threadIdx.x; i < plan.nrows * plan.D;
       i += gridDim.x * kApplyThreads) {
    const int r = i / plan.D, k = i % plan.D;
    plan.xin[(size_t)r * plan.ldx + k] = standardized(plan.a, __ldg(plan.x + i), k);
  }
  grid.sync();
#pragma unroll 1
  for (int p = 0; p < kLikeProducts; ++p) {
    run_product<kLikeStages, Epi::kLike>(plan.prod[p], plan.row_tiles, plan.nrows, plan.part, rank,
                                   smem, &plan.a, grid, p + 1 < kLikeProducts);
    grid.sync();
  }
  const ApplyProduct& C = plan.prod[kLikeProducts - 1];
  const int parts = C.split > 1 && !C.local ? C.split : 0;
  __shared__ float sums[2][kApplyThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = blockIdx.x; r < plan.nrows; r += gridDim.x) {
    const float* dr = plan.delta + (size_t)r * plan.ld;
    // row r's partial sums of column c: tile (c / kBN, r / kBM), element
    // (r % kBM, c % kBN) of each part (run_product's layout)
    const float* pr = plan.part + (size_t)(r / kBM) * parts * kTile + (r % kBM) * kBN;
    float chi2 = 0.f, xx = 0.f;
#pragma unroll 2
    for (int c = threadIdx.x; c < plan.N; c += kApplyThreads) {
      float y;
      if (parts) {
        const float* at = pr + (size_t)(c / kBN) * plan.row_tiles * parts * kTile + c % kBN;
        float v = 0.f;
#pragma unroll 4
        for (int q = 0; q < parts; ++q) v = __fadd_rn(v, __ldcg(at + (size_t)q * kTile));
        y = epilogue<Epi::kLike>(C.seg[0], &plan.a, v, 0.f, 0.f, c);
      } else {
        y = __ldcg(plan.cd + (size_t)r * plan.ld + c);
      }
      chi2 = fmaf(__ldcg(dr + c), y, chi2);
    }
    int bad = 0;
    for (int k = threadIdx.x; k < plan.D; k += kApplyThreads) {
      const float xw = __ldg(plan.x + (size_t)r * plan.D + k);
      xx = fmaf(xw, xw, xx);
      if (plan.a.x_log10[k] && physical(plan.a, xw, k) <= 0.f) bad = 1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      chi2 += __shfl_xor_sync(0xffffffffu, chi2, off);
      xx += __shfl_xor_sync(0xffffffffu, xx, off);
    }
    if (lane == 0) {
      sums[0][warp] = chi2;
      sums[1][warp] = xx;
    }
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
      chi2 = xx = 0.f;
      for (int w = 0; w < kApplyThreads / 32; ++w) {
        chi2 = __fadd_rn(chi2, sums[0][w]);
        xx = __fadd_rn(xx, sums[1][w]);
      }
      const float v = __fadd_rn(__fmul_rn(__fmul_rn(-0.5f, chi2), 1.f / __ldg(plan.a.temperature)),
                                __fmul_rn(-0.5f, xx));
      plan.lp[r] = (isnan(v) || bad) ? -INFINITY : v;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------ composition_grad
//
// composition_grad_kernel: the value and the input gradient of the Gaussian
// K-member composition (likelihood.py make_log_prob; ops/composition.py),
// for the gradient samplers.  It replaces no TPU kernel: the JAX package
// leaves the composition and its vmapped gradient to XLA, and PyTorch's
// autograd runs it as about 30 f32 cuBLAS products with 32 x 32 tiles and
// about 60 elementwise launches a call at NUTS's 256 rows.
//
// What bounds it: per row and member 2.52 MFLOP of the trunk forward, 0.84
// MFLOP of the [C | C^T] product and 2.52 MFLOP of the backward's products
// at the DES width (27 -> 457, 1,258,500 weights), 3.0 GFLOP at 256 rows
// and K = 2: 0.018 ms at the 3xTF32 tensor-core rate, 0.045 ms at the f32
// CUDA cores'.  Each launch reads 2 x 10.1 MB of weights and their
// transposed copies from L2.  At the sampler's rows it is bound, as
// fused_log_prob_kernel is, by its chain of products: 21 of them, each a
// few rounds of L2 latency and one or two grid barriers.
//
// The design is fused_log_prob_kernel's: one cooperative launch of 64 x 64
// 3xTF32 tiles (apply_tile, run_product), each product's k split planned on
// the host from the widths and K alone (ops/composition.py, plan), so a
// row's value and gradient do not depend on the rows launched beside it.
// A product runs for every member at once: its work items are the members'
// tiles (x its k ranges), member m reading its weights, input and output
// through the member strides; layer 1 reads the one standardized input all
// members share.  The forward's 11 products (layer 1; lin1 | skip and lin2
// of each residual block; layers 6, 7 and 8, whose epilogue gives delta;
// delta @ [C | C^T]) keep every activation in the scratch.  One pass, a
// block a row, then takes each member's chi^2 = delta . delta C, the
// tempered log-likelihood -0.5 (mean_k chi2_k + k_std std_k chi2_k) / T
// (-0.5 chi2 / T for one member) and w_k = d lp / d chi2_k, and writes the
// gradient at layer 8's output, w_k (delta C + delta C^T) dm/dy.  The
// backward's 10 products walk the layers in reverse over the transposed
// weights (copies made once by the host): each epilogue masks by the ReLU
// of the forward output it lands on (ApplySeg::mask); a residual block is
// [skip^T | lin2^T] (lin2^T scaled by 0.1 and masked by lin1's output),
// then lin1^T added to the skip's part; layer 1's transposed weights are
// stacked over the members, so the last product sums the members' input
// gradients in its k loop.

// The scratch buffers, in the plan's order: the forward's outputs (layer
// 1, each residual block's lin1 and output, layers 6 and 7, delta, delta C,
// delta C^T), then the backward's (the gradient at layer 8's output, at
// layers 7 and 6, at each residual block's output and lin1).  Row r of
// member m of a buffer starts at r * members * ms + m * ms, ms the
// buffer's width rounded up to 4, or the width itself for layer 1's two
// (kS1, kGS1), so that a row of the layer-1 gradient is one row of
// members x h for the last product.
enum GradBuf {
  kS1, kH1, kS2, kH2, kS3, kH3, kS4, kS6, kS7, kDelta, kR1, kR2,
  kGY, kG7, kG6, kG4, kGS3, kGH3, kGS2, kGH2, kGS1, kGH1, kGradBuffers
};
constexpr int kGradForward = 11;   // the forward's products
constexpr int kGradProducts = 21;  // and the backward's 10
constexpr int kMaxMembers = 32;

// One launch of composition_grad_kernel (make_grad_plan, from the host's plan).
struct GradPlan {
  ApplyProduct prod[kGradProducts];
  LikeArgs a;            // the y transform, sigma, data, temperature, ypositive
  const float* k_std;    // f32[1]
  const float* delta;    // kDelta, kR1, kR2: the chi^2's operands
  const float* r1;
  const float* r2;
  float* gy;             // kGY
  float* lp;             // [nrows]
  float* part;
  int nrows, row_tiles, deal, members, N;
  int ld, ms;            // row and member stride of the N-wide buffers
};
// a kernel's parameters must fit in 4 KB on every CUDA 12 toolkit
static_assert(sizeof(GradPlan) <= 4096, "composition_grad's plan passes the kernel-parameter limit");

// The pass between the forward and the backward, one block a row: each
// member's chi^2 (its own order: a thread's columns, the warps' sums, the
// warps in order), the log-likelihood into lp and w_k into shared memory,
// then the gradient at layer 8's output.  A member's std weight is 0 where
// the members' chi^2 are all equal (std 0): a subgradient, where torch's
// std backward gives NaN.
__device__ __forceinline__ void grad_combine(const GradPlan& P) {
  __shared__ float sums[kApplyThreads / 32];
  __shared__ float w[kMaxMembers];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, K = P.members;
  for (int r = blockIdx.x; r < P.nrows; r += gridDim.x) {
    const size_t row = (size_t)r * P.ld;
    for (int m = 0; m < K; ++m) {
      const float* d = P.delta + row + (size_t)m * P.ms;
      const float* q = P.r1 + row + (size_t)m * P.ms;
      float chi2 = 0.f;
      for (int c = threadIdx.x; c < P.N; c += kApplyThreads) {
        chi2 = fmaf(__ldcg(d + c), __ldcg(q + c), chi2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) chi2 += __shfl_xor_sync(0xffffffffu, chi2, off);
      if (lane == 0) sums[warp] = chi2;
      __syncthreads();
      if (threadIdx.x == 0) {
        chi2 = 0.f;
        for (int i = 0; i < kApplyThreads / 32; ++i) chi2 = __fadd_rn(chi2, sums[i]);
        w[m] = chi2;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float t = __ldg(P.a.temperature), scale = __fdiv_rn(-0.5f, t);
      if (K == 1) {
        P.lp[r] = __fdiv_rn(__fmul_rn(-0.5f, w[0]), t);
        w[0] = scale;
      } else {
        float mean = 0.f, var = 0.f;
        for (int m = 0; m < K; ++m) mean = __fadd_rn(mean, w[m]);
        mean = __fdiv_rn(mean, (float)K);
        for (int m = 0; m < K; ++m) {
          const float e = __fsub_rn(w[m], mean);
          var = __fmaf_rn(e, e, var);
        }
        const float sd = __fsqrt_rn(__fdiv_rn(var, (float)K)), ks = __ldg(P.k_std);
        P.lp[r] = __fdiv_rn(__fmul_rn(-0.5f, __fadd_rn(mean, __fmul_rn(ks, sd))), t);
        // d std / d chi2_m = (chi2_m - mean) / (K std)
        const float per_sd = ks != 0.f && sd > 0.f ? __fdiv_rn(ks, __fmul_rn((float)K, sd)) : 0.f;
        const float per_mean = __fdiv_rn(1.f, (float)K);
        for (int m = 0; m < K; ++m) {
          w[m] = __fmul_rn(scale, __fmaf_rn(per_sd, __fsub_rn(w[m], mean), per_mean));
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < K * P.N; i += kApplyThreads) {
      const int m = i / P.N, c = i % P.N;
      const size_t at = row + (size_t)m * P.ms + c;
      const float g = __fmul_rn(w[m], __fadd_rn(__ldcg(P.r1 + at), __ldcg(P.r2 + at)));
      // dm/dy: y_std sigma, or y_std m = y_std (delta + data) when ypositive
      const float dm = P.a.ypositive ? __fadd_rn(__ldcg(P.delta + at), __ldg(P.a.data + c))
                                     : __ldg(P.a.sigma + c);
      P.gy[at] = __fmul_rn(__fmul_rn(g, __ldg(P.a.y_std + c)), dm);
    }
    __syncthreads();  // w and sums are the next row's
  }
}

// The forward's products, the combining pass, the backward's products, a
// grid barrier between any two.
__global__ void __launch_bounds__(kApplyThreads, kLikeBlocksPerSM)
composition_grad_kernel(const __grid_constant__ GradPlan plan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int rank = (int)((long long)blockIdx.x * plan.deal % gridDim.x);
#pragma unroll 1
  for (int p = 0; p < kGradProducts; ++p) {
    run_product<kLikeStages, Epi::kGrad>(plan.prod[p], plan.row_tiles, plan.nrows, plan.part,
                                         rank, smem, &plan.a, grid);
    if (p + 1 == kGradProducts) break;
    grid.sync();
    if (p + 1 == kGradForward) {
      grad_combine(plan);
      grid.sync();
    }
  }
}

// ------------------------------------- fused_log_prob on clusters (narrow models)
//
// fused_log_prob_cluster_kernel: thread-block clusters of 8 blocks (the portable
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
// which rank 0 sums in a fixed order.  Every sum a row's value takes (each
// product's k ranges, their partials in order, the chi^2 partials) follows
// the model's width alone, never R: the k split is planned for the most
// walkers a cluster can take at that width, so a row's value does not
// depend on the rows launched beside it.
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
// the most that fit a block's shared memory, in more than one wave (the
// LSST width: 8, so the host takes the tiled design there).

constexpr int kThreads = 512;  // threads per block of fused_log_prob_cluster_kernel
constexpr int kCluster = 8;    // blocks per cluster of fused_log_prob_cluster_kernel
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

// Rs: the most walkers a cluster takes at this width (ClusterLaunch), which
// the k split is planned for, so that it is the same at every R <= Rs.
__device__ void plan_product(Product& P, int R, int Rs, int rank) {
  const int n = P.s0.n + P.s1.n;
  P.c0 = slice_edge(n, rank);
  P.ncols = slice_edge(n, rank + 1) - P.c0;
  P.ngc = (P.ncols + kColTile - 1) / kColTile;
  P.tiles = P.ngc * (R / kRowTile);
  // as many k ranges as the threads allow at Rs walkers (ngc * Rs / 8 <=
  // kThreads: fits_block), but none shorter than 4
  const int most = P.ngc * (Rs / kRowTile);
  P.split = most == 0 ? 0 : min(kThreads / most, (P.K + 3) / 4);
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
fused_log_prob_cluster_kernel(const float* __restrict__ x, int nrows, int R, int Rs, TrunkWeights w,
                      TrunkDims d, LikeArgs a, float* __restrict__ lp) {
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
      plan_product(P, R, Rs, rank);
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
    if (a.x_log10[k] && physical(a, xw, k) <= 0.f) atomicOr(&bad[r], 1);
    A[r * la + k] = standardized(a, xw, k);
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

LikeArgs make_like(const void* const* like, int ypositive) {
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
  return a;
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
                   bool relu, bool accum, bool delta = false) {
  ApplySeg s{};
  s.W = W;
  s.bias = bias;
  s.out = out;
  s.ld = ld;
  s.n = n;
  s.col_tiles = (n + kBN - 1) / kBN;
  s.alpha = alpha;
  s.relu = relu;
  s.accum = accum;
  s.vec = rows_aligned16(W, n);
  s.delta = delta;
  return s;
}

ApplyProduct apply_product(const float* in, int ld, int K, ApplySeg s0,
                           ApplySeg s1 = ApplySeg{}) {
  ApplyProduct P{};
  P.in = in;
  P.ld = ld;
  P.K = K;
  P.split = 1;
  P.members = 1;
  P.vec = rows_aligned16(in, ld);
  P.seg[0] = s0;
  P.seg[1] = s1;
  return P;
}

// The trunk's products on nrows rows of `in` (ld `ld_in`), through the
// activation buffers A, B (row stride d.width) and H: layer1 (in -> B),
// residual blocks (B -> A, A -> B, B -> A; lin1 into H and skip as one
// product, then lin2 adds to the skip's output), layers 6 (A -> B), 7
// (B -> A) and 8 (A -> out, row stride ld_out).  Returns the count (10).
int trunk_products(ApplyProduct* prod, const float* in, int ld_in, const TrunkWeights& w,
                   const TrunkDims& d, float* A, float* B, float* H, float* out, int ld_out,
                   bool delta) {
  const int ld = d.width;
  int p = 0;
  prod[p++] = apply_product(in, ld_in, d.in, apply_seg(w.w[0], w.w[1], B, ld, d.h, 1.f, true, false));
  const int in_w[3] = {d.h, d.h2, d.h4};
  const int ch[3] = {d.c1, d.c2, d.c3};
  const int out_w[3] = {d.h2, d.h4, d.h8};
  float* src = B;
  float* dst = A;
  for (int i = 0; i < 3; ++i) {
    const float* const* q = w.w + 2 + 5 * i;  // lin1 w, lin1 b, lin2 w, lin2 b, skip w
    prod[p++] = apply_product(src, ld, in_w[i],
                              apply_seg(q[0], q[1], H, d.hmax, ch[i], 1.f, true, false),
                              apply_seg(q[4], nullptr, dst, ld, out_w[i], 1.f, false, false));
    prod[p++] = apply_product(H, d.hmax, ch[i],
                              apply_seg(q[2], q[3], dst, ld, out_w[i], 0.1f, true, true));
    float* t = src;
    src = dst;
    dst = t;
  }
  // after three blocks the activation is in A (src)
  prod[p++] = apply_product(A, ld, d.h8, apply_seg(w.w[17], w.w[18], B, ld, d.l6, 1.f, true, false));
  prod[p++] = apply_product(B, ld, d.l6, apply_seg(w.w[19], w.w[20], A, ld, d.out, 1.f, true, false));
  prod[p++] = apply_product(A, ld, d.out,
                            apply_seg(w.w[21], w.w[22], out, ld_out, d.out, 1.f, false, false, delta));
  return p;
}

// The 10 products of the trunk on nrows rows of x, through the scratch.
ApplyPlan make_apply_plan(const float* x, int nrows, const TrunkWeights& w, const TrunkDims& d,
                          float* out, float* scratch) {
  ApplyPlan P{};
  P.nrows = nrows;
  P.row_tiles = (nrows + kBM - 1) / kBM;
  float* A = scratch;
  float* B = A + (size_t)nrows * d.width;
  float* H = B + (size_t)nrows * d.width;
  trunk_products(P.prod, x, d.in, w, d, A, B, H, out, d.out, false);
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

// A cooperative launch of `grid` blocks of kApplyThreads on the stream.
void cooperative(cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg, int grid, size_t smem,
                 cudaStream_t stream) {
  attr->id = cudaLaunchAttributeCooperative;
  attr->val.cooperative = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(kApplyThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The card's SMs and the blocks of `kernel` (`smem` bytes of dynamic shared
// memory a block) one SM holds at once; sets the kernel's dynamic
// shared-memory limit.
template <typename Kernel>
cudaError_t capacity(Kernel kernel, size_t smem, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = prepare(kernel, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kApplyThreads, smem);
  }
  return err;
}

// Sets the kernel's dynamic shared-memory limit, sizes the grid (every
// block the card holds at once: a cooperative launch may have no more) and
// splits the k-chunks of each product whose tiles are fewer than the
// blocks, into as many ranges of at least kMinSplitChunks chunks as keep
// its work items within the grid.  At the sampler's 128-256 rows a product
// has 4-64 tiles, and one block walks a tile's k-chunks in sequence.
cudaError_t plan_apply(ApplyPlan& P, cudaStream_t stream, ApplyLaunch* L) {
  const cudaError_t err = capacity(fused_apply_kernel, kApplySmem, &L->sms, &L->per_sm);
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
  cooperative(&L->attr, &L->cfg, grid, kApplySmem, stream);
  // Work item i goes to block i * 37 mod grid (deal is 37's inverse mod
  // grid; 37 is prime, and a grid that 37 divides keeps items in block
  // order).  The card places consecutive blocks on the few SMs of one GPC
  // before the next, so blocks 0..31 of a 4-per-SM grid share 8 SMs; a
  // stride of 37 blocks spreads a product's first items over the GPCs.
  P.deal = 1;
  if (grid % 37 != 0) {
    while ((long long)P.deal * 37 % grid != 1) ++P.deal;
  }
  return cudaSuccess;
}

// The host's plan of one fused_log_prob launch (ops/fused.py,
// log_prob_plan): kPlanHead values, then kPlanProduct for each product.
constexpr int kPlanHead = 11;
constexpr int kPlanProduct = 5;
constexpr int kPlanLength = kPlanHead + kPlanProduct * kLikeProducts;

// The 11 products of fused_log_prob over the scratch as the plan lays it
// out: layer 1 (the whitened walkers -> B, staged through the prior
// transform), the residual blocks and layers 6 and 7 as in the trunk,
// layer 8 (A -> B, delta) and the chi^2 product (B -> A, with C^-1 as its
// weights).  Checks the plan against the widths and the scratch; false
// where they differ.
bool make_like_plan(LikePlan& L, const float* x, int nrows, const TrunkWeights& w,
                    const TrunkDims& d, const LikeArgs& a, const long long* plan, float* scratch,
                    long long scratch_floats, float* lp) {
  L = LikePlan{};
  const long long row_tiles = plan[0], grid = plan[1], deal = plan[2], width = plan[3];
  const long long hmax = plan[4], ldx = plan[5], off_a = plan[6], off_b = plan[7];
  const long long off_h = plan[8], off_x = plan[9], off_part = plan[10];
  if (row_tiles != (nrows + kBM - 1) / kBM || grid < 1 || deal < 0 || width != d.width ||
      hmax != d.hmax || ldx != d.ldx) {
    return false;
  }
  const long long act = (long long)nrows * d.width;
  if (off_a < 0 || off_a + act > off_b || off_b + act > off_h ||
      off_h + (long long)nrows * d.hmax > off_x || off_x + (long long)nrows * ldx > off_part ||
      off_a % 4 || off_b % 4 || off_h % 4 || off_x % 4 || off_part % 4) {
    return false;
  }
  float* A = scratch + off_a;
  float* B = scratch + off_b;
  float* H = scratch + off_h;
  float* X = scratch + off_x;
  trunk_products(L.prod, X, (int)ldx, w, d, A, B, H, B, d.width, true);
  L.prod[10] = apply_product(B, d.width, d.out,
                             apply_seg(a.inv_cov, nullptr, A, d.width, d.out, 1.f, false, false));
  L.a = a;
  L.x = x;
  L.xin = X;
  L.delta = B;
  L.cd = A;
  L.lp = lp;
  L.part = scratch + off_part;
  L.nrows = nrows;
  L.row_tiles = (int)row_tiles;
  L.deal = (int)deal;
  L.ld = d.width;
  L.ldx = (int)ldx;
  L.D = d.in;
  L.N = d.out;
  long long part_end = off_part;
  for (int p = 0; p < kLikeProducts; ++p) {
    const long long* q = plan + kPlanHead + kPlanProduct * p;
    ApplyProduct& P = L.prod[p];
    const long long nk = (P.K + kBK - 1) / kBK;
    const long long tiles = row_tiles * (P.seg[0].col_tiles + P.seg[1].col_tiles);
    const long long split = q[3];
    if (q[0] != P.K || q[1] != P.seg[0].col_tiles || q[2] != P.seg[1].col_tiles || split < 1 ||
        (split > 1 && split > nk / kMinSplitChunks)) {
      return false;
    }
    P.split = (int)split;
    P.local = split > 1 && q[4] != 0;
    if (split > 1) part_end = std::max(part_end, off_part + (P.local ? grid : tiles * split) * kTile);
  }
  return part_end <= scratch_floats;
}

// The host's plan of one composition_grad launch (ops/composition.py,
// plan): kGradHead values (row tiles, blocks, deal, members, each buffer's
// offset in the scratch, the partial tiles' offset), then kGradProduct for
// each product (K, the two segments' column tiles, members, split, local).
constexpr int kGradHead = 5 + kGradBuffers;
constexpr int kGradProduct = 6;
constexpr int kGradPlanLength = kGradHead + kGradProduct * kGradProducts;
// the transposed weights: layers 8, 7, 6; rb3, rb2, rb1 (skip, lin2,
// lin1 each); layer 1 stacked over the members; C^T
constexpr int kGradTransposed = 14;

// Each buffer's width (GradBuf order).
void grad_widths(const TrunkDims& d, int* w) {
  const int v[kGradBuffers] = {d.h,   d.c1,  d.h2,  d.c2,  d.h4,  d.c3, d.h8, d.l6,
                               d.out, d.out, d.out, d.out, d.out, d.out, d.l6, d.h8,
                               d.h4,  d.c3,  d.h2,  d.c2,  d.h,   d.c1};
  for (int b = 0; b < kGradBuffers; ++b) w[b] = v[b];
}

// The 21 products of composition_grad over the scratch as the plan lays it
// out (the kernel's comment); checks the plan against the widths, the
// members and the scratch, false where they differ.  weights: the forward's
// 23, stacked over the members (member strides: a weight's size, a bias's
// width); t: the kGradTransposed copies.
bool make_grad_plan(GradPlan& G, const float* x, int nrows, int members, const TrunkWeights& w,
                    const float* const* t, const TrunkDims& d, const LikeArgs& a,
                    const float* k_std, const long long* plan, float* scratch,
                    long long scratch_floats, float* lp, float* grad) {
  G = GradPlan{};
  const long long row_tiles = plan[0], grid = plan[1], deal = plan[2], off_part = plan[4 + kGradBuffers];
  if (plan[3] != members || members < 1 || members > kMaxMembers ||
      row_tiles != (nrows + kBM - 1) / kBM || grid < 1 || deal < 0 || off_part % 4) {
    return false;
  }
  int width[kGradBuffers], ms[kGradBuffers], ld[kGradBuffers];
  float* buf[kGradBuffers];
  grad_widths(d, width);
  long long end = 0;
  for (int b = 0; b < kGradBuffers; ++b) {
    ms[b] = b == kS1 || b == kGS1 ? width[b] : round4(width[b]);
    ld[b] = members * ms[b];
    const long long off = plan[4 + b];
    if (off < end || off % 4) return false;
    end = off + (long long)nrows * ld[b];
    buf[b] = scratch + off;
  }
  if (end > off_part) return false;

  auto seg = [&](const float* W, int w_ms, const float* bias, int b_ms, int out, int n, float alpha,
                 bool relu, bool accum, int mask, bool delta = false) {
    ApplySeg s = apply_seg(W, bias, buf[out], ld[out], n, alpha, relu, accum, delta);
    s.w_ms = w_ms;
    s.b_ms = b_ms;
    s.out_ms = ms[out];
    s.mask = mask >= 0 ? buf[mask] : nullptr;
    s.vec = s.vec && w_ms % 4 == 0;
    return s;
  };
  auto product = [&](const float* in, int ld_in, int in_ms, int K, ApplySeg s0,
                     ApplySeg s1 = ApplySeg{}) {
    ApplyProduct P = apply_product(in, ld_in, K, s0, s1);
    P.members = members;
    P.in_ms = in_ms;
    P.vec = P.vec && in_ms % 4 == 0;
    return P;
  };
  auto from = [&](int b, int K, ApplySeg s0, ApplySeg s1 = ApplySeg{}) {
    return product(buf[b], ld[b], ms[b], K, s0, s1);
  };
  const float* const* q = w.w;
  const int fin[3] = {d.h, d.h2, d.h4}, ch[3] = {d.c1, d.c2, d.c3}, fout[3] = {d.h2, d.h4, d.h8};
  const int sb[4] = {kS1, kS2, kS3, kS4}, hb[3] = {kH1, kH2, kH3};
  const int gs[4] = {kGS1, kGS2, kGS3, kG4}, gh[3] = {kGH1, kGH2, kGH3};
  int p = 0;
  // the forward: every member reads the one input x
  G.prod[p++] = product(x, d.in, 0, d.in, seg(q[0], d.in * d.h, q[1], d.h, kS1, d.h, 1.f, true, false, -1));
  for (int i = 0; i < 3; ++i) {
    const float* const* r = q + 2 + 5 * i;  // lin1 w, lin1 b, lin2 w, lin2 b, skip w
    G.prod[p++] = from(sb[i], fin[i],
                       seg(r[0], fin[i] * ch[i], r[1], ch[i], hb[i], ch[i], 1.f, true, false, -1),
                       seg(r[4], fin[i] * fout[i], nullptr, 0, sb[i + 1], fout[i], 1.f, false, false, -1));
    G.prod[p++] = from(hb[i], ch[i],
                       seg(r[2], ch[i] * fout[i], r[3], fout[i], sb[i + 1], fout[i], 0.1f, true, true, -1));
  }
  G.prod[p++] = from(kS4, d.h8, seg(q[17], d.h8 * d.l6, q[18], d.l6, kS6, d.l6, 1.f, true, false, -1));
  G.prod[p++] = from(kS6, d.l6, seg(q[19], d.l6 * d.out, q[20], d.out, kS7, d.out, 1.f, true, false, -1));
  G.prod[p++] = from(kS7, d.out,
                     seg(q[21], d.out * d.out, q[22], d.out, kDelta, d.out, 1.f, false, false, -1, true));
  G.prod[p++] = from(kDelta, d.out, seg(a.inv_cov, 0, nullptr, 0, kR1, d.out, 1.f, false, false, -1),
                     seg(t[13], 0, nullptr, 0, kR2, d.out, 1.f, false, false, -1));
  // the backward, each product masked by the ReLU of the layer it lands on
  G.prod[p++] = from(kGY, d.out, seg(t[0], d.out * d.out, nullptr, 0, kG7, d.out, 1.f, false, false, kS7));
  G.prod[p++] = from(kG7, d.out, seg(t[1], d.out * d.l6, nullptr, 0, kG6, d.l6, 1.f, false, false, kS6));
  G.prod[p++] = from(kG6, d.l6, seg(t[2], d.l6 * d.h8, nullptr, 0, kG4, d.h8, 1.f, false, false, kS4));
  for (int j = 0; j < 3; ++j) {
    const int i = 2 - j;
    const float* const* r = t + 3 + 3 * j;  // skip^T, lin2^T, lin1^T
    G.prod[p++] = from(gs[i + 1], fout[i],
                       seg(r[0], fout[i] * fin[i], nullptr, 0, gs[i], fin[i], 1.f, false, false, -1),
                       seg(r[1], fout[i] * ch[i], nullptr, 0, gh[i], ch[i], 0.1f, false, false, hb[i]));
    G.prod[p++] = from(gh[i], ch[i],
                       seg(r[2], ch[i] * fin[i], nullptr, 0, gs[i], fin[i], 1.f, false, true, sb[i]));
  }
  // layer 1: the members' gradients side by side, summed in the k loop
  G.prod[p] = apply_product(buf[kGS1], ld[kGS1], members * d.h,
                            apply_seg(t[12], nullptr, grad, d.in, d.in, 1.f, false, false));

  G.a = a;
  G.k_std = k_std;
  G.delta = buf[kDelta];
  G.r1 = buf[kR1];
  G.r2 = buf[kR2];
  G.gy = buf[kGY];
  G.lp = lp;
  G.part = scratch + off_part;
  G.nrows = nrows;
  G.row_tiles = (int)row_tiles;
  G.deal = (int)deal;
  G.members = members;
  G.N = d.out;
  G.ld = ld[kDelta];
  G.ms = ms[kDelta];
  long long part_end = off_part;
  for (int i = 0; i < kGradProducts; ++i) {
    const long long* e = plan + kGradHead + kGradProduct * i;
    ApplyProduct& P = G.prod[i];
    const long long nk = (P.K + kBK - 1) / kBK;
    const long long items = row_tiles * (P.seg[0].col_tiles + P.seg[1].col_tiles) * P.members;
    const long long split = e[4];
    if (e[0] != P.K || e[1] != P.seg[0].col_tiles || e[2] != P.seg[1].col_tiles ||
        e[3] != P.members || split < 1 || (split > 1 && split > nk / kMinSplitChunks)) {
      return false;
    }
    P.split = (int)split;
    P.local = split > 1 && e[5] != 0;
    if (split > 1) part_end = std::max(part_end, off_part + (P.local ? grid : items * split) * kTile);
  }
  return part_end <= scratch_floats;
}

// The launch of fused_log_prob_cluster_kernel over nrows walkers, groups x 8 of
// them per cluster.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  int walkers;       // per cluster
  int split_walkers; // the most walkers per cluster at this width (the k split's)
  int max_clusters;  // the most clusters of this shape the card holds at once
};

// Sets the kernel's dynamic shared-memory limit to the launch's and asks how
// many clusters of the launch's shape the card holds at once.
cudaError_t prepare_cluster(ClusterLaunch* L) {
  const cudaError_t err = prepare(fused_log_prob_cluster_kernel, L->cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(&L->max_clusters, (const void*)fused_log_prob_cluster_kernel,
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
int plan_cluster(int nrows, const TrunkDims& d, cudaStream_t stream, ClusterLaunch* L) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (!fits_block(d, kRowTile, smem_max)) return kTooWide;
  L->split_walkers = kRowTile;
  while (L->split_walkers < kMaxGroups * kRowTile &&
         fits_block(d, L->split_walkers + kRowTile, smem_max)) {
    L->split_walkers += kRowTile;
  }
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
// data, inv_cov, temperature (12 device pointers).  plan: the host's plan
// of the launch (kPlanLength values, ops/fused.py log_prob_plan); scratch:
// scratch_floats floats, 16-byte aligned.  Returns a cudaError_t, or
// kBadPlan when the plan does not match the widths or the scratch
// (linna_error_string says which); the launch does not synchronise.
int linna_fused_log_prob(const float* x, int nrows, const void* const* weights, const int* dims,
                         const void* const* like, int ypositive, const long long* plan,
                         float* scratch, long long scratch_floats, float* lp, void* stream) {
  if (nrows <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0) return cudaErrorMisalignedAddress;
  const TrunkDims d = make_dims(dims);
  const LikeArgs a = make_like(like, ypositive);
  LikePlan L;
  if (!make_like_plan(L, x, nrows, make_weights(weights), d, a, plan, scratch, scratch_floats,
                      lp)) {
    return kBadPlan;
  }
  cudaError_t err = prepare(fused_log_prob_kernel, kLikeSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cooperative(&attr, &cfg, (int)plan[1], kLikeSmem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, fused_log_prob_kernel, L);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster design of fused_log_prob (narrow models: ops/fused.py,
// log_prob_design), with linna_fused_log_prob's arguments but the plan and
// the scratch.  Returns a cudaError_t, or kNoCluster / kTooWide when no
// cluster of the launch's shape fits on the card or the model is too wide
// for the kernel (linna_error_string says which); the launch does not
// synchronise.
int linna_fused_log_prob_cluster(const float* x, int nrows, const void* const* weights,
                                 const int* dims, const void* const* like, int ypositive,
                                 float* lp, void* stream) {
  if (nrows <= 0) return 0;
  const TrunkDims d = make_dims(dims);
  const TrunkWeights w = make_weights(weights);
  const LikeArgs a = make_like(like, ypositive);
  ClusterLaunch L;
  const int planned = plan_cluster(nrows, d, static_cast<cudaStream_t>(stream), &L);
  if (planned != 0) return planned;
  if (L.max_clusters < 1) return kNoCluster;
  const cudaError_t err =
      cudaLaunchKernelEx(&L.cfg, fused_log_prob_cluster_kernel, x, nrows, L.walkers,
                         L.split_walkers, w, d, a, lp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster design's launch shape over nrows walkers, for the record;
// smem: dynamic shared memory per block.  shape (6 ints): walkers per
// cluster, blocks per cluster, blocks, threads per block, the most clusters
// the card holds at once, the walkers per cluster the k split is planned
// for.  Returns a cudaError_t, or kTooWide.
int linna_cluster_launch_shape(int nrows, const int* dims, int* shape, long long* smem) {
  ClusterLaunch L;
  const int err = plan_cluster(nrows, make_dims(dims), 0, &L);
  if (err != 0) return err;
  const int v[6] = {L.walkers, kCluster, (int)L.cfg.gridDim.x, kThreads, L.max_clusters,
                    L.split_walkers};
  for (int i = 0; i < 6; ++i) shape[i] = v[i];
  *smem = (long long)L.cfg.dynamicSmemBytes;
  return 0;
}

// The most walkers a cluster of the cluster design takes at these widths on
// the current card (a block's shared memory and threads bound it; 0 where
// not even one row group of 8 fits), or minus a cudaError_t.
int linna_cluster_walkers(const int* dims) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -(int)err;
  const TrunkDims d = make_dims(dims);
  int walkers = 0;
  while (walkers < kMaxGroups * kRowTile && fits_block(d, walkers + kRowTile, smem_max)) {
    walkers += kRowTile;
  }
  return walkers;
}

// What the current device holds of fused_log_prob_kernel at once: its SMs
// and the blocks an SM holds; smem: dynamic shared memory per block.
// Returns a cudaError_t.
int linna_log_prob_capacity(int* sms, int* per_sm, long long* smem) {
  *smem = (long long)kLikeSmem;
  return capacity(fused_log_prob_kernel, kLikeSmem, sms, per_sm);
}

// fused_apply's launch shape over nrows rows, for the record; smem: dynamic
// shared memory per block.  shape (9 + 10 ints): tile rows, tile columns,
// blocks, threads per block, blocks per SM, SMs, tile k, stages, the most
// work items of a product, then each product's k split.  Returns a
// cudaError_t.
int linna_apply_launch_shape(int nrows, const int* dims, int* shape, long long* smem) {
  const TrunkDims d = make_dims(dims);
  ApplyPlan P = make_apply_plan(nullptr, nrows, TrunkWeights{}, d, nullptr, nullptr);
  ApplyLaunch L{};
  const cudaError_t err = plan_apply(P, 0, &L);
  const int v[9] = {kBM, kBN, (int)L.cfg.gridDim.x, kApplyThreads, L.per_sm, L.sms, kBK,
                    kApplyStages, L.max_items};
  for (int i = 0; i < 9; ++i) shape[i] = v[i];
  for (int p = 0; p < kApplyProducts; ++p) shape[9 + p] = P.prod[p].split;
  *smem = (long long)kApplySmem;
  return err;
}

// composition_grad: the tempered log-likelihood lp (nrows) of the Gaussian
// composition of `members` stacked members at the standardized inputs x
// (nrows x dims[0], shared by the members) and its gradient with respect
// to x, grad (nrows x dims[0]).  weights: the forward's 23 device pointers
// in ops/fused.py's flatten_params order, each stacked over the members; transposed:
// kGradTransposed pointers (make_grad_plan); like: as linna_fused_log_prob's
// (the y transform, sigma, data, inv_cov and temperature are read); k_std:
// f32[1].  plan: kGradPlanLength values (ops/composition.py, plan);
// scratch: scratch_floats floats, 16-byte aligned.  Returns a cudaError_t,
// or kBadPlan when the plan does not match; the launch does not
// synchronise.
int linna_composition_grad(const float* x, int nrows, int members, const void* const* weights,
                           const void* const* transposed, const int* dims,
                           const void* const* like, int ypositive, const float* k_std,
                           const long long* plan, float* scratch, long long scratch_floats,
                           float* lp, float* grad, void* stream) {
  if (nrows <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0) return cudaErrorMisalignedAddress;
  const float* t[kGradTransposed];
  for (int i = 0; i < kGradTransposed; ++i) t[i] = static_cast<const float*>(transposed[i]);
  GradPlan G;
  if (!make_grad_plan(G, x, nrows, members, make_weights(weights), t, make_dims(dims),
                      make_like(like, ypositive), k_std, plan, scratch, scratch_floats, lp, grad)) {
    return kBadPlan;
  }
  cudaError_t err = prepare(composition_grad_kernel, kLikeSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cooperative(&attr, &cfg, (int)plan[1], kLikeSmem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, composition_grad_kernel, G);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the current device holds of composition_grad_kernel at once: its
// SMs and the blocks an SM holds; smem: dynamic shared memory per block.
// Returns a cudaError_t.
int linna_composition_grad_capacity(int* sms, int* per_sm, long long* smem) {
  *smem = (long long)kLikeSmem;
  return capacity(composition_grad_kernel, kLikeSmem, sms, per_sm);
}

// The length of linna_composition_grad's plan.
int linna_composition_grad_plan_length() { return kGradPlanLength; }

// The length of linna_fused_log_prob's plan.
int linna_log_prob_plan_length() { return kPlanLength; }

const char* linna_error_string(int err) {
  if (err == kBadPlan) {
    return "the launch plan does not match the model's widths or the scratch "
           "(ops/fused.py log_prob_plan, ops/composition.py plan)";
  }
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
