// IF nodes in a CUDA graph under stream capture, for the trials of a captured
// L-BFGS step (neuralpde_tpu_torch/kernels/graph_if.py).
//
// The JAX package's line search is a lax.while_loop that XLA compiles into
// the jitted step (neuralpde_tpu/train.py:86-96).  Under PyTorch a step is
// captured as a CUDA graph, and a trial that the search may skip becomes a
// conditional node of that graph: graph_if_begin adds, at the capture point
// of the capturing stream, a kernel that copies a device flag into a new
// conditional handle and an IF node on that handle, moves the capture past
// the node, and starts capturing the node's body graph on a second stream;
// graph_if_end ends the body's capture.  At replay the body runs only when
// the flag was set when the node was reached.  (torch 2.11, which the port
// runs on the card, exposes no IF nodes of its own.)
//
// The flag kernel is one thread; its cost is a launch inside the graph.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const bool* __restrict__ flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t capture_point(cudaStream_t stream, cudaGraph_t* graph,
                          const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
    return cudaErrorStreamCaptureImplicit;
  }
  return err;
}

}  // namespace

extern "C" {

int graph_if_begin(void* capturing, const void* flag, void* body_stream) {
  cudaStream_t stream = static_cast<cudaStream_t>(capturing);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_point(stream, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_point(stream, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

int graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

}  // extern "C"
