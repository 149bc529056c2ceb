// Fused emulator kernels for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces the two Pallas TPU kernels of linna_tpu/ops/fused.py:
//   linna_fused_apply     <- _apply_impl     (the ChtoModelv2 trunk, one launch)
//   linna_fused_log_prob  <- _log_prob_impl  (whitened walker -> one log-posterior f32)
//
// What bounds them: per walker 2.52 MFLOP for the trunk (+0.42 MFLOP for the
// 457x457 chi^2 product) against 5.03 MB (+0.84 MB) of weights per launch at
// the DES width (27 -> 457, hidden 1000), so the card's f32 rate bounds the
// work (~11 us at 256 walkers).  On the TPU every weight sits in VMEM for the
// whole launch.  Here the weights are far above one SM's 227 KB of shared
// memory, so they stream from global memory (they stay resident in the 50 MB
// L2 across blocks and launches) and blocks keep only activations on chip.
//
// fused_apply_kernel: each block takes ROWS walkers and walks all 14 layers
// for them (`trunk`), keeping two ping-pong buffers of the widest
// activation, one for the residual blocks' narrow inner channels and a
// split-K scratch.  A thread owns one output column at a time with one
// accumulator per walker in registers, reads activations from shared memory
// as broadcast float4 loads and keeps 16 weight loads in flight; products
// narrower than the block split their reduction over its threads.  Every
// block re-reads every weight from L2, and every FMA needs its own
// activation word from shared memory, whose path to the registers moves 32
// words a clock per SM against 128 FMAs.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // threads per block
constexpr int kUnroll = 16;    // weight loads in flight per thread (a multiple of 4)
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

// out[r, c] = epilogue(sum_k in[r, k] * W[k, c]) for r < ROWS, c < N.
// epilogue: (+ bias[c]) * alpha (+ out[r, c] when accum) (relu when relu).
// `in` and `out` are shared-memory row blocks with strides ld_in / ld_out.
template <int ROWS>
__device__ void linear(const float* __restrict__ W, const float* __restrict__ bias,
                       const float* in, int ld_in, int K, float* out, int ld_out, int N,
                       float alpha, bool accum, bool relu, float* red) {
  const int T = blockDim.x;
  const int split = N >= T ? 1 : T / N;
  const int kchunk = (((K + split - 1) / split) + 3) & ~3;
  for (int task = threadIdx.x; task < N * split; task += T) {
    const int col = task % N;
    const int part = task / N;
    const int k0 = part * kchunk;
    const int k1 = min(K, k0 + kchunk);
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    int k = k0;
    // kUnroll weight loads in flight per thread: the long reductions wait
    // on L2, not on the FMA rate
    for (; k + kUnroll <= k1; k += kUnroll) {
      float wv[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) wv[j] = __ldg(W + (size_t)(k + j) * N + col);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int j = 0; j < kUnroll; j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(in + r * ld_in + k + j);
          acc[r] = fmaf(a.x, wv[j + 0], acc[r]);
          acc[r] = fmaf(a.y, wv[j + 1], acc[r]);
          acc[r] = fmaf(a.z, wv[j + 2], acc[r]);
          acc[r] = fmaf(a.w, wv[j + 3], acc[r]);
        }
      }
    }
    for (; k + 4 <= k1; k += 4) {
      const float w0 = __ldg(W + (size_t)(k + 0) * N + col);
      const float w1 = __ldg(W + (size_t)(k + 1) * N + col);
      const float w2 = __ldg(W + (size_t)(k + 2) * N + col);
      const float w3 = __ldg(W + (size_t)(k + 3) * N + col);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(in + r * ld_in + k);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
    for (; k < k1; ++k) {
      const float w0 = __ldg(W + (size_t)k * N + col);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(in[r * ld_in + k], w0, acc[r]);
    }
    if (split == 1) {
      const float b = bias ? __ldg(bias + col) : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float y = (acc[r] + b) * alpha;
        if (accum) y += out[r * ld_out + col];
        out[r * ld_out + col] = relu ? fmaxf(y, 0.f) : y;
      }
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) red[(part * ROWS + r) * N + col] = acc[r];
    }
  }
  if (split > 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < ROWS * N; idx += T) {
      const int r = idx / N;
      const int col = idx % N;
      float s = 0.f;
      for (int p = 0; p < split; ++p) s += red[(p * ROWS + r) * N + col];
      float y = (s + (bias ? __ldg(bias + col) : 0.f)) * alpha;
      if (accum) y += out[r * ld_out + col];
      out[r * ld_out + col] = relu ? fmaxf(y, 0.f) : y;
    }
  }
  __syncthreads();
}

// The ChtoModelv2 trunk on ROWS rows: input in A[:, :in], output in B[:, :out].
// relu(x@W1+b1) -> 3x relu(0.1*(relu(s@L1+b)@L2+b) + s@Skip) -> relu(L6) -> relu(L7) -> L8
template <int ROWS>
__device__ void trunk(const TrunkWeights& w, const TrunkDims& d, float* A, float* B, float* H,
                      float* red) {
  const int ld = d.width;
  linear<ROWS>(w.w[0], w.w[1], A, ld, d.in, B, ld, d.h, 1.f, false, true, red);
  // residual blocks: (lin1 w, lin1 b, lin2 w, lin2 b, skip w) at 2 + 5*i
  const int in_w[3] = {d.h, d.h2, d.h4};
  const int ch[3] = {d.c1, d.c2, d.c3};
  const int out_w[3] = {d.h2, d.h4, d.h8};
  float* src = B;
  float* dst = A;
  for (int i = 0; i < 3; ++i) {
    const float* const* p = w.w + 2 + 5 * i;
    linear<ROWS>(p[0], p[1], src, ld, in_w[i], H, d.hmax, ch[i], 1.f, false, true, red);
    linear<ROWS>(p[4], nullptr, src, ld, in_w[i], dst, ld, out_w[i], 1.f, false, false, red);
    linear<ROWS>(p[2], p[3], H, d.hmax, ch[i], dst, ld, out_w[i], 0.1f, true, true, red);
    float* t = src;
    src = dst;
    dst = t;
  }
  // after three blocks the activation is in A (src)
  linear<ROWS>(w.w[17], w.w[18], A, ld, d.h8, B, ld, d.l6, 1.f, false, true, red);
  linear<ROWS>(w.w[19], w.w[20], B, ld, d.l6, A, ld, d.out, 1.f, false, true, red);
  linear<ROWS>(w.w[21], w.w[22], A, ld, d.out, B, ld, d.out, 1.f, false, false, red);
}

struct Smem {
  float* A;
  float* B;
  float* H;
  float* red;
  float* X;
};

template <int ROWS>
__device__ Smem carve(float* smem, const TrunkDims& d) {
  Smem s;
  s.A = smem;
  s.B = s.A + ROWS * d.width;
  s.H = s.B + ROWS * d.width;
  s.red = s.H + ROWS * d.hmax;
  s.X = s.red + kThreads * ROWS;
  return s;
}

template <int ROWS>
size_t smem_bytes(const TrunkDims& d) {
  return sizeof(float) * ((size_t)ROWS * (2 * d.width + d.hmax + kThreads + d.ldx + 2));
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
fused_apply_kernel(const float* __restrict__ x, int nrows, TrunkWeights w, TrunkDims d,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  Smem s = carve<ROWS>(reinterpret_cast<float*>(smem4), d);
  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < ROWS * d.in; i += blockDim.x) {
    const int r = i / d.in, k = i % d.in;
    s.A[r * d.width + k] = row0 + r < nrows ? x[(size_t)(row0 + r) * d.in + k] : 0.f;
  }
  __syncthreads();
  trunk<ROWS>(w, d, s.A, s.B, s.H, s.red);
  for (int i = threadIdx.x; i < ROWS * d.out; i += blockDim.x) {
    const int r = i / d.out, c = i % d.out;
    if (row0 + r < nrows) out[(size_t)(row0 + r) * d.out + c] = s.B[r * d.width + c];
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

// fused_apply: walkers per block, as few as keep a launch near one wave of
// blocks on the 132 SMs (a block's serial walk over the layers sets a small
// launch's time), more for large batches, where each weight read is reused
// over more rows.  From a sweep of block shapes at the DES width (PERF.md).
int rows_for(int nrows) { return nrows <= 256 ? 2 : nrows <= 512 ? 4 : 8; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int ROWS>
cudaError_t launch_apply(const float* x, int nrows, const TrunkWeights& w, const TrunkDims& d,
                         float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<ROWS>(d);
  cudaError_t err = prepare(fused_apply_kernel<ROWS>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (nrows + ROWS - 1) / ROWS;
  fused_apply_kernel<ROWS><<<grid, kThreads, smem, stream>>>(x, nrows, w, d, out);
  return cudaGetLastError();
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
// Returns a cudaError_t (0 on success); the launch does not synchronise.
int linna_fused_apply(const float* x, int nrows, const void* const* weights, const int* dims,
                      float* out, void* stream) {
  if (nrows <= 0) return 0;
  const TrunkDims d = make_dims(dims);
  const TrunkWeights w = make_weights(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_for(nrows)) {
    case 2: return launch_apply<2>(x, nrows, w, d, out, st);
    case 4: return launch_apply<4>(x, nrows, w, d, out, st);
    default: return launch_apply<8>(x, nrows, w, d, out, st);
  }
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
// nrows walkers, for the record.  shape: walkers per block (per cluster for
// fused_log_prob), blocks per cluster, blocks, threads per block, and the
// most clusters the card holds at once (-1 for fused_apply); smem: dynamic
// shared memory per block.  Returns a cudaError_t.
int linna_launch_shape(int kernel, int nrows, const int* dims, int* shape, long long* smem) {
  const TrunkDims d = make_dims(dims);
  shape[3] = kThreads;
  if (kernel == 0) {
    const int rows = rows_for(nrows);
    shape[0] = rows;
    shape[1] = 1;
    shape[2] = (nrows + rows - 1) / rows;
    shape[4] = -1;
    *smem = (long long)(rows == 2   ? smem_bytes<2>(d)
                        : rows == 4 ? smem_bytes<4>(d)
                                    : smem_bytes<8>(d));
    return 0;
  }
  ClusterLaunch L;
  const int err = plan_log_prob(nrows, d, 0, &L);
  shape[0] = L.walkers;
  shape[1] = kCluster;
  shape[2] = (int)L.cfg.gridDim.x;
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
