// While loops of CUDA graphs that the card ends, for the graphed zeus sampler
// (sm_90a, CUDA 12.3 or later).
//
// Replaces no Pallas kernel.  The JAX package runs the slice move's
// stepping-out and shrink loops as lax.while_loops inside one compiled
// program, so the TPU itself decides when each loop ends.  The port's graphed
// zeus runner (samplers/graphs.py) replayed one loop iteration as a CUDA graph
// and read the loop's condition on the host after each replay: a copy to
// pinned memory, an event wait, a decision in Python and the next launch,
// with nothing queued on the card meanwhile, about 20 times a step.
//
// Here each loop is a conditional node of type cudaGraphCondTypeWhile.  Its
// body is the iteration's graph, as a child graph node, followed by
// loop_condition_kernel: one thread that counts the iteration and sets the
// node's handle to `more && iterations < max_steps`, `more` being the bool
// the iteration wrote.  The handle is set to 1 at every launch of the graph
// (cudaGraphCondAssignDefault), so the body runs once before the first
// test, as the host loop's first condition holds.  The same iterations run,
// with the same kernels on the same inputs, as under the host's reads.
//
// What bounds it: launch latency, not arithmetic.  Each iteration adds one
// one-thread kernel to the card's work, a few microseconds, in place of a
// round trip through the host.
//
// One loops graph holds n loops run one after another: a kernel that zeroes
// every loop's iteration count of this launch, then the n while nodes in a
// chain.  total[i] adds every iteration of loop i over all launches, so the
// host can count the bodies' replays with one read of it now and then.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12030
#error "conditional graph nodes need CUDA 12.3 or later"
#endif

namespace {

constexpr int kMaxLoops = 8;

__global__ void loops_reset_kernel(int* iters, int n) {
  for (int i = 0; i < n; ++i) iters[i] = 0;
}

__global__ void loop_condition_kernel(cudaGraphConditionalHandle handle, const bool* more,
                                      int* iters, long long* total, int max_steps) {
  const int it = *iters + 1;
  *iters = it;
  *total += 1;
  cudaGraphSetConditional(handle, (*more && it < max_steps) ? 1u : 0u);
}

struct Loops {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

#define LOOPS_CHECK(call)                    \
  do {                                       \
    const cudaError_t err_ = (call);         \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

// one thread, the kernel's arguments copied into the node
cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                       size_t n_deps, void* func, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

cudaError_t build(Loops* loops, int n, void* const* bodies, const bool* more, int* iters,
                  long long* total, int max_steps) {
  LOOPS_CHECK(cudaGraphCreate(&loops->graph, 0));
  cudaGraphNode_t prev;
  void* reset_args[] = {&iters, &n};
  LOOPS_CHECK(add_kernel(&prev, loops->graph, nullptr, 0,
                         reinterpret_cast<void*>(loops_reset_kernel), reset_args));
  for (int i = 0; i < n; ++i) {
    cudaGraphConditionalHandle handle;
    LOOPS_CHECK(cudaGraphConditionalHandleCreate(&handle, loops->graph, 1,
                                                 cudaGraphCondAssignDefault));
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    cudaGraphNode_t loop;
    LOOPS_CHECK(cudaGraphAddNode(&loop, loops->graph, &prev, 1, &params));
    cudaGraph_t body = params.conditional.phGraph_out[0];
    cudaGraphNode_t iteration, condition;
    // the child graph node holds a copy of the iteration's graph
    LOOPS_CHECK(cudaGraphAddChildGraphNode(&iteration, body, nullptr, 0,
                                           static_cast<cudaGraph_t>(bodies[i])));
    int* loop_iters = iters + i;
    long long* loop_total = total + i;
    void* args[] = {&handle, &more, &loop_iters, &loop_total, &max_steps};
    LOOPS_CHECK(add_kernel(&condition, body, &iteration, 1,
                           reinterpret_cast<void*>(loop_condition_kernel), args));
    prev = loop;
  }
  LOOPS_CHECK(cudaGraphInstantiate(&loops->exec, loops->graph, 0));
  return cudaSuccess;
}

void destroy(Loops* loops) {
  if (loops->exec != nullptr) cudaGraphExecDestroy(loops->exec);
  if (loops->graph != nullptr) cudaGraphDestroy(loops->graph);
  delete loops;
}

}  // namespace

extern "C" {

int linna_loops_max_loops() { return kMaxLoops; }

// A loops graph of the n graphs `bodies` (cudaGraph_t), each run as a while
// loop of at most max_steps iterations that goes on while the device bool
// `more` holds after an iteration; `iters` (n int32) and `total` (n int64)
// are device counters the graph writes.  The graph is instantiated here;
// *out receives it.  Returns 0 or the CUDA error (linna_loops_error_string
// says which); nothing is left allocated on an error.
int linna_loops_create(int n, void* const* bodies, const void* more, int* iters,
                       long long* total, int max_steps, void** out) {
  if (n < 1 || n > kMaxLoops || max_steps < 1) return cudaErrorInvalidValue;
  Loops* loops = new Loops;
  const cudaError_t err = build(loops, n, bodies, static_cast<const bool*>(more), iters, total,
                                max_steps);
  if (err != cudaSuccess) {
    destroy(loops);
    return err;
  }
  *out = loops;
  return 0;
}

// One launch of the loops graph on `stream`; it does not synchronise.
int linna_loops_launch(void* loops, void* stream) {
  return cudaGraphLaunch(static_cast<Loops*>(loops)->exec, static_cast<cudaStream_t>(stream));
}

void linna_loops_destroy(void* loops) { destroy(static_cast<Loops*>(loops)); }

const char* linna_loops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
