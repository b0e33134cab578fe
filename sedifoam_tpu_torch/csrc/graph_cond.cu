// Conditional nodes of a CUDA graph: the port's lax.cond and
// lax.while_loop (sedifoam_tpu_torch/graphs.py).
//
// The reference compiles its control flow into one XLA program
// (sedifoam_tpu/linsolve.py's while_loops, dem/integrate.py's and
// dem/inject.py's conds). Here a stream that PyTorch is capturing into a
// CUDA graph gets a conditional node of type IF or WHILE (CUDA 12.4+,
// driver 550+): the graph reads the predicate on the device when it
// reaches the node and runs the node's body graph or skips it, without
// coming back to the host.
//
//   graph_cond_handle  a new conditional handle in the graph that a
//                      stream is capturing
//   graph_cond_set     a one-thread kernel that copies a bool on the
//                      device into the handle: before the node, and at
//                      the end of a WHILE body (the loop runs again while
//                      the bool is true)
//   graph_cond_node    the conditional node after what the stream has
//                      captured so far, its body a child graph node made
//                      of a captured graph (the body, captured by PyTorch
//                      on a side stream into a memory pool of the graph's);
//                      the stream's capture continues after it
//
// Bound: one thread, one byte read; the node itself is the graph's work.
// Every function returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

int graph_cond_runtime_version() { return CUDART_VERSION; }

const char* graph_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int graph_cond_set(void* stream, const void* pred,
                   unsigned long long handle) {
  set_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(pred));
  return cudaGetLastError();
}

int graph_cond_handle(void* stream, unsigned long long* handle) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream),
                                             &status, nullptr, &graph);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (err != cudaSuccess) return err;
  *handle = h;
  return cudaSuccess;
}

int graph_cond_node(void* stream, unsigned long long handle, int is_while,
                    void* child) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, nullptr, &n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNode_t body_node;
  err = cudaGraphAddChildGraphNode(&body_node, params.conditional.phGraph_out[0],
                                   nullptr, 0, static_cast<cudaGraph_t>(child));
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                             cudaStreamSetCaptureDependencies);
#endif
}

}  // extern "C"
