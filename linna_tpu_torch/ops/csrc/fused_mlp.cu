// Fused emulator kernels for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces the two Pallas TPU kernels of linna_tpu/ops/fused.py:
//   linna_fused_apply     <- _apply_impl     (the ChtoModelv2 trunk, one launch)
//   linna_fused_log_prob  <- _log_prob_impl  (whitened walker -> one log-posterior f32)
// Both share the device-side trunk routine `trunk` below.
//
// Design.  On the TPU every weight sits in VMEM for the whole launch.  Here
// the DES-width weights (27 -> 457, hidden 1000: 1,258,500 floats, 5.03 MB)
// are far above one SM's 227 KB of shared memory, so the weights stream from
// global memory (they stay resident in the 50 MB L2 across blocks and
// launches) and each block keeps only its ROWS walkers' activations on chip:
// two ping-pong buffers of the widest activation, one buffer for the residual
// blocks' narrow inner channels, and a split-K reduction scratch.  Each
// thread owns one output column at a time and keeps ROWS accumulators in
// registers, so every weight read from L2 is used ROWS times; activations are
// read from shared memory as broadcast float4 loads.  512 threads give the
// 500-wide layers one column pass, and each thread keeps 16 weight loads in
// flight.  Narrow layers (the 16-64 channel inner linears) split their
// reduction over the threads of the block and reduce through shared memory.
//
// What bounds it: per walker 2.52 MFLOP for the trunk (+0.42 MFLOP for the
// 457x457 chi^2 product) against 5.03 MB (+0.84 MB) of weights per launch,
// so the card's f32 rate bounds the work (~11 us at 256 walkers).  This
// design is far from that: every block walks all 14 layers for its own
// walkers, re-reading every weight from L2, and at the sampler's 128-256
// walkers that serial walk (one L2 round trip per 16 weights per thread,
// a block barrier per layer) sets the launch time.  The host picks few
// walkers per block so that a launch fills about one wave of blocks.
// Splitting each layer's columns over all SMs, and wgmma/TMA/TF32, are
// later work.
//
// Semantics kept from the TPU kernels: f32 accumulation; log10 lanes take
// log10(max(x, 1e-30)) and flag the row when any masked physical value is
// <= 0; such a row, or a NaN log-posterior, gives -inf.  Rows past the batch
// are computed on zeros and never stored (no padding by repeating row 0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // threads per block
constexpr int kUnroll = 16;    // weight loads in flight per thread (a multiple of 4)
constexpr int kWeights = 23;  // layer1 (2) + 3 resblocks (5 each) + layers 6/7/8 (2 each)

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

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
fused_log_prob_kernel(const float* __restrict__ x, int nrows, TrunkWeights w, TrunkDims d,
                      LikeArgs a, float* __restrict__ lp) {
  extern __shared__ float4 smem4[];
  Smem s = carve<ROWS>(reinterpret_cast<float*>(smem4), d);
  float* lnprior = s.X + ROWS * d.ldx;
  int* bad = reinterpret_cast<int*>(lnprior + ROWS);
  const int row0 = blockIdx.x * ROWS;
  const int D = d.in;
  const int N = d.out;
  if (threadIdx.x < ROWS) bad[threadIdx.x] = 0;
  __syncthreads();

  // 1-3: prior transform, log10 lanes (with the bad-row flag), standardize
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, k = i % D;
    const float xw = row0 + r < nrows ? x[(size_t)(row0 + r) * D + k] : 0.f;
    s.X[r * d.ldx + k] = xw;
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
    s.A[r * d.width + k] = (xin - a.x_mean[k]) / a.x_std[k];
  }
  __syncthreads();
  if (threadIdx.x < ROWS) {
    float q = 0.f;
    for (int k = 0; k < D; ++k) q += s.X[threadIdx.x * d.ldx + k] * s.X[threadIdx.x * d.ldx + k];
    lnprior[threadIdx.x] = -0.5f * q;
  }

  // 4: the trunk (prediction in B)
  trunk<ROWS>(w, d, s.A, s.B, s.H, s.red);

  // 5: destandardize -> exp when ypositive -> sigma scale; delta = m - data (in B)
  for (int i = threadIdx.x; i < ROWS * N; i += blockDim.x) {
    const int r = i / N, c = i % N;
    float m = s.B[r * d.width + c] * a.y_std[c] + a.y_mean[c];
    if (a.ypositive) m = expf(m);
    s.B[r * d.width + c] = m * a.sigma[c] - a.data[c];
  }
  __syncthreads();

  // 6: C^-1 delta (in A), then chi^2 = delta . (C^-1 delta), one warp per row
  linear<ROWS>(a.inv_cov, nullptr, s.B, d.width, N, s.A, d.width, N, 1.f, false, false, s.red);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_t = 1.f / a.temperature[0];
  for (int r = warp; r < ROWS; r += blockDim.x / 32) {
    float q = 0.f;
    for (int c = lane; c < N; c += 32) q += s.B[r * d.width + c] * s.A[r * d.width + c];
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
    // 7: tempered likelihood + unit-normal prior; NaN or a bad row -> -inf
    if (lane == 0 && row0 + r < nrows) {
      float v = -0.5f * q * inv_t + lnprior[r];
      lp[row0 + r] = (isnan(v) || bad[r]) ? -INFINITY : v;
    }
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

// Walkers per block: as few as keep a launch near one wave of blocks on the
// 132 SMs (a block's serial walk over the layers sets a small launch's
// time), more for large batches, where each weight read is reused over
// more rows.  From a sweep of block shapes at the DES width (PERF.md).
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

template <int ROWS>
cudaError_t launch_log_prob(const float* x, int nrows, const TrunkWeights& w, const TrunkDims& d,
                            const LikeArgs& a, float* lp, cudaStream_t stream) {
  const size_t smem = smem_bytes<ROWS>(d);
  cudaError_t err = prepare(fused_log_prob_kernel<ROWS>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (nrows + ROWS - 1) / ROWS;
  fused_log_prob_kernel<ROWS><<<grid, kThreads, smem, stream>>>(x, nrows, w, d, a, lp);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_for(nrows)) {
    case 2: return launch_log_prob<2>(x, nrows, w, d, a, lp, st);
    case 4: return launch_log_prob<4>(x, nrows, w, d, a, lp, st);
    default: return launch_log_prob<8>(x, nrows, w, d, a, lp, st);
  }
}

// Rows and threads per block and dynamic shared memory of a launch, for the record.
int linna_launch_shape(int nrows, const int* dims, int* rows, int* threads, long long* smem) {
  const TrunkDims d = make_dims(dims);
  *rows = rows_for(nrows);
  *threads = kThreads;
  *smem = (long long)(*rows == 2 ? smem_bytes<2>(d) : *rows == 4 ? smem_bytes<4>(d) : smem_bytes<8>(d));
  return 0;
}

const char* linna_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
