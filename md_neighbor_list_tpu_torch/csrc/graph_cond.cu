// Conditional nodes of a captured CUDA graph: the device-side branch of the
// chunk runner (utils/graphs.py), the port's counterpart of the JAX engines'
// `lax.cond` inside `lax.scan`. Not a port of a TPU kernel: the JAX package
// leaves the branch to XLA, which compiles it into its program.
//
// mdnl_graph_if, called while `stream` captures a graph, appends to that
// graph a one-thread kernel that reads the 0-d bool `pred` and sets a
// conditional handle from it, then an "if" conditional node on that handle.
// It returns the node's body graph, empty, through `body_out`, and makes the
// node the dependency of the work captured next. The body is filled after the
// capture by mdnl_graph_body with a graph captured on its own (PyTorch cannot
// capture a graph while another capture is under way), as a child graph
// node. At each launch the body runs when *pred is true and is skipped
// otherwise; the host reads nothing.
//
// A child graph placed in a conditional body may not itself hold conditional
// nodes, so branches do not nest: the runner refuses a branch inside a body.

#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int mdnl_graph_if(const void* pred, void** body_out, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_if<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the node follows the kernel just captured
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  *body_out = static_cast<void*>(params.conditional.phGraph_out[0]);
  return cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                             cudaStreamSetCaptureDependencies);
}

extern "C" int mdnl_graph_body(void* body, void* child) {
  cudaGraphNode_t node;
  return cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(body),
                                    nullptr, 0, static_cast<cudaGraph_t>(child));
}
