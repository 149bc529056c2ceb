// The trainer's AdamW step for Hopper (sm_90a): one launch a minibatch step.
//
// Replaces no Pallas kernel.  The JAX package leaves AdamW to optax inside
// the jitted training step, and XLA fuses its elementwise ops with the
// concatenation of the gradient.  The port ran the same arithmetic as about
// twenty PyTorch elementwise launches over the (K, P) parameters, plus the
// concatenation of the leaves' gradients and its cast to float32
// (linna_tpu_torch/train.py, adamw_step_; ops/adamw.py, adamw_plain_).
//
// What bounds it: device memory.  Per element it reads the float32
// parameter, the gradient (bfloat16 or float32), the first moment (its
// storage type) and the float32 second moment, and writes the parameter and
// both moments back: 22 bytes with a bfloat16 gradient and first moment, 28
// in float32, for about 15 floating-point operations.  At the DES width
// (K = 2 members of P = 1,258,500) that is 55.4 MB a step, 16.5 us at
// 3.35 TB/s.  Nothing is reused, so the design only keeps every byte moving
// once: each thread takes kPerThread elements a block-width apart (the
// loads of a warp coalesce), issues all of their loads before any
// arithmetic, and stores in place.
//
// The gradient is read where autograd left it.  A table of segments, one a
// leaf, comes by value in the launch's parameters (a __grid_constant__
// struct, indexed without a local copy): the leaf's gradient pointer, its
// first element in a member's row of P, its length a member and the
// elements between members.  Grid x walks every segment's blocks in order,
// grid y the members; a block finds its segment by a uniform scan of the
// table's first blocks.  A (K, P) gradient (a data group's all-reduced
// one) is the table of one segment.
//
// The arithmetic is adamw_plain_'s, op for op: each product, sum, quotient
// and root rounds once (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no
// contracted multiply-adds, no approximate division or root), the first
// moment is updated in float32 and only its stored copy is rounded to its
// type (round to nearest even), and the update uses the float32 moment.
// The bias corrections 1 - b^count come in as (K,) float32 tensors that
// PyTorch computed, so the kernel takes no power of its own.  So the kernel
// and the PyTorch ops give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegments = 32;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

// storage types, as the Python wrapper names them
constexpr int kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2;

struct Segment {
  const void* grad;       // member 0's first gradient element of the leaf
  long long offset;       // the leaf's first element in a member's row of P
  long long length;       // the leaf's elements a member
  long long row_stride;   // elements between members in the gradient
  long long first_block;  // the segment's first block along grid x
};

struct Table {
  Segment seg[kMaxSegments];
  int n;
};

struct Hyper {
  const float* lr;  // member k's learning rate at lr[k * lr_stride]
  long long lr_stride;
  const float* wd;
  long long wd_stride;
  const float* bc1;  // 1 - b1^count, (K,) contiguous
  const float* bc2;  // 1 - b2^count
  float b1, c1, b2, c2, eps;  // c = 1 - b, rounded to float32 as optax's
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename M> __device__ __forceinline__ M narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

template <typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ flat, M* __restrict__ mu, float* __restrict__ nu, long long P,
             const __grid_constant__ Table table, const __grid_constant__ Hyper h) {
  const long long b = blockIdx.x;
  int s = 0;
  while (s + 1 < table.n && table.seg[s + 1].first_block <= b) ++s;
  const Segment& seg = table.seg[s];
  const long long k = blockIdx.y;
  const G* __restrict__ g = static_cast<const G*>(seg.grad) + k * seg.row_stride;
  const long long row = k * P + seg.offset;
  const long long first = (b - seg.first_block) * kPerBlock + threadIdx.x;
  const float lr = h.lr[k * h.lr_stride], wd = h.wd[k * h.wd_stride];
  const float bc1 = h.bc1[k], bc2 = h.bc2[k];

  float gv[kPerThread], pv[kPerThread], mv[kPerThread], vv[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = first + j * kThreads;
    if (i < seg.length) {
      gv[j] = widen(g[i]);
      pv[j] = flat[row + i];
      mv[j] = widen(mu[row + i]);
      vv[j] = nu[row + i];
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = first + j * kThreads;
    if (i < seg.length) {
      const float gj = gv[j];
      const float m = __fadd_rn(__fmul_rn(mv[j], h.b1), __fmul_rn(h.c1, gj));
      const float v = __fadd_rn(__fmul_rn(vv[j], h.b2), __fmul_rn(h.c2, __fmul_rn(gj, gj)));
      const float m_hat = __fdiv_rn(m, bc1);
      const float v_hat = __fdiv_rn(v, bc2);
      const float step = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), h.eps));
      const float update = __fadd_rn(step, __fmul_rn(wd, pv[j]));
      flat[row + i] = __fadd_rn(pv[j], __fmul_rn(update, -lr));
      mu[row + i] = narrow<M>(m);
      nu[row + i] = v;
    }
  }
}

template <typename G, typename M>
cudaError_t launch(float* flat, void* mu, float* nu, int K, long long P, const Table& table,
                   long long blocks, const Hyper& h, cudaStream_t stream) {
  adamw_kernel<G, M><<<dim3(static_cast<unsigned>(blocks), K), kThreads, 0, stream>>>(
      flat, static_cast<M*>(mu), nu, P, table, h);
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_mu(int mu_type, float* flat, void* mu, float* nu, int K, long long P,
                      const Table& table, long long blocks, const Hyper& h,
                      cudaStream_t stream) {
  switch (mu_type) {
    case kFloat32: return launch<G, float>(flat, mu, nu, K, P, table, blocks, h, stream);
    case kBFloat16: return launch<G, __nv_bfloat16>(flat, mu, nu, K, P, table, blocks, h, stream);
    case kFloat16: return launch<G, __half>(flat, mu, nu, K, P, table, blocks, h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int linna_adamw_max_segments() { return kMaxSegments; }

// One AdamW step of the (K, P) parameters ``flat``, first moment ``mu``
// (storage type ``mu_type``) and second moment ``nu``, all contiguous and
// updated in place, from the gradient given as ``n_seg`` segments of type
// ``grad_type`` that tile a member's row [0, P) in order.  ``consts``: b1,
// 1 - b1, b2, 1 - b2, eps.  Returns 0 or the CUDA error of the launch
// (linna_adamw_error_string says which); the launch does not synchronise.
int linna_adamw_step(float* flat, void* mu, int mu_type, float* nu, int K, long long P,
                     int n_seg, const void* const* seg_grad, const long long* seg_offset,
                     const long long* seg_length, const long long* seg_stride, int grad_type,
                     const float* lr, long long lr_stride, const float* wd, long long wd_stride,
                     const float* bc1, const float* bc2, const float* consts, void* stream) {
  if (n_seg < 0 || n_seg > kMaxSegments || K < 0 || K > 65535) return cudaErrorInvalidValue;
  Table table;
  long long blocks = 0, covered = 0;
  for (int s = 0; s < n_seg; ++s) {
    if (seg_offset[s] != covered || seg_length[s] < 0) return cudaErrorInvalidValue;
    table.seg[s] = {seg_grad[s], seg_offset[s], seg_length[s], seg_stride[s], blocks};
    blocks += (seg_length[s] + kPerBlock - 1) / kPerBlock;
    covered += seg_length[s];
  }
  table.n = n_seg;
  if (covered != P || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (K == 0 || blocks == 0) return 0;
  const Hyper h = {lr, lr_stride, wd, wd_stride, bc1, bc2,
                   consts[0], consts[1], consts[2], consts[3], consts[4]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (grad_type) {
    case kFloat32: return launch_mu<float>(mu_type, flat, mu, nu, K, P, table, blocks, h, st);
    case kBFloat16:
      return launch_mu<__nv_bfloat16>(mu_type, flat, mu, nu, K, P, table, blocks, h, st);
    case kFloat16: return launch_mu<__half>(mu_type, flat, mu, nu, K, P, table, blocks, h, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* linna_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
