// The loop exit of a fused dispatch on the card, hand-written for Hopper
// (sm_90a): the counterpart of the cond of the JAX package's while_loop,
// (steps_done < max_steps) & jnp.any(c.lane_active)
// (lara_tpu/solver/device_solver.py:629-633), evaluated on the card.
//
// lara_loop_graph builds the graph of one dispatch around a captured
// iteration (the body, a graph that torch captured):
//
//   loop_exit_kernel -> WHILE node { child graph: the body }
//
// The kernel sets the WHILE node's condition for the first trip.  The body
// ends in KI-tail (csrc/iteration.cu), which does the kernel's work for
// every later trip: the copy of KI-tail in the WHILE node gets the node's
// condition and the counters (lara_iteration_tail_fold); each of its CTAs
// takes a ticket that carries the lanes it left active, and the last one
// sets the condition for the next trip, so no second kernel runs in the
// loop.  Torch's capture itself, and every launch of KI-tail outside the
// loop, set no condition.  A body without exactly one KI-tail is refused.
//
// counters[0] holds the iterations the dispatch may still run (the host
// sets it to max_steps before each launch) and counters[1] the bodies run;
// counters[2] and [3] are KI-tail's ticket, a 64-bit word (the host zeroes
// counters[1] to [3] before each launch, and KI-tail's last CTA the ticket
// after each trip).  The kernel reduces lane_active (KI-tail counts it in
// the tickets) and sets the WHILE node's condition to
// counters[0] > 0 && any lane active; where it is set, it takes one from
// counters[0] and adds one to counters[1].  So the body runs exactly as
// often as the JAX loop's body, and a dispatch after the last lane is done
// runs the kernel once and no body.  The host reads counters[1] when the
// dispatch is done (the launch counts of the body's kernels follow it).
// The condition is reset to 0 at every launch (cudaGraphCondAssignDefault).
// What bounds the kernel: one byte per lane read once; it runs on one CTA
// and is all latency.
//
// The body graph is cloned into the WHILE node when the graph is built;
// its memory stays with the torch graph that captured it, which the
// caller keeps alive as long as this graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
loop_exit_kernel(cudaGraphConditionalHandle handle,
                 const bool* __restrict__ lane_active, int lanes,
                 int* __restrict__ counters) {
  int mine = 0;
  for (int i = threadIdx.x; i < lanes; i += kThreads) {
    mine |= lane_active[i] ? 1 : 0;
  }
  const int any = __syncthreads_or(mine);
  if (threadIdx.x == 0) {
    const bool run = any && counters[0] > 0;
    cudaGraphSetConditional(handle, run ? 1u : 0u);
    if (run) {
      counters[0] -= 1;
      counters[1] += 1;
    }
  }
}

cudaError_t add_exit_kernel(cudaGraphNode_t* node, cudaGraph_t graph,
                            const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphConditionalHandle handle,
                            const bool* active, int lanes, int* counters) {
  void* args[] = {&handle, &active, &lanes, &counters};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(loop_exit_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(kThreads);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

}  // namespace

extern "C" {

// In csrc/iteration.cu, built into the same library: the body's KI-tail
// is what evaluates the exit inside the loop, so this graph depends on
// KI-tail's launch arguments through it.
int lara_iteration_tail_fold(void* graph, cudaGraphConditionalHandle handle,
                             int* loop);

// Build and instantiate the graph of one dispatch: *graph_out and
// *exec_out get its graph and executable graph (free both with
// lara_loop_graph_free).  lane_active is [lanes] bool and counters four
// int32 (the last two zero), both on the card, at addresses that stay
// valid for the life of the graph.  The body's KI-tail evaluates the exit
// after every trip: an error (cudaErrorSymbolNotFound) unless the body
// holds exactly one KI-tail.
int lara_loop_graph(void* body, const void* lane_active, int lanes,
                    void* counters, void** graph_out, void** exec_out) {
  *graph_out = nullptr;
  *exec_out = nullptr;
  const bool* active = static_cast<const bool*>(lane_active);
  int* count = static_cast<int*>(counters);
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  cudaGraphNode_t first = nullptr;
  if (err == cudaSuccess) {
    err = add_exit_kernel(&first, graph, nullptr, 0, handle, active, lanes,
                          count);
  }
  cudaGraphNode_t loop = nullptr;
  cudaGraphNodeParams cp = {};
  if (err == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&loop, graph, &first, 1, &cp);
  }
  cudaGraphNode_t child = nullptr;
  cudaGraph_t inner = nullptr;
  if (err == cudaSuccess) {
    inner = cp.conditional.phGraph_out[0];
    err = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
  }
  cudaGraph_t cloned = nullptr;
  if (err == cudaSuccess) {
    err = cudaGraphChildGraphNodeGetGraph(child, &cloned);
  }
  if (err == cudaSuccess) {
    err = static_cast<cudaError_t>(
        lara_iteration_tail_fold(cloned, handle, count));
  }
  if (err == cudaSuccess) {
    err = cudaGraphInstantiate(&exec, graph, 0);
  }
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    (void)cudaGetLastError();  // not left for the next launch to report
    return static_cast<int>(err);
  }
  *graph_out = graph;
  *exec_out = exec;
  return 0;
}

// One dispatch on stream.
int lara_loop_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

int lara_loop_graph_free(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) {
    err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  }
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) {
      err = e2;
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
