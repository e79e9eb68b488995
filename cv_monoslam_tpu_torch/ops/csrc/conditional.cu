// IF conditional nodes in a CUDA graph being captured by PyTorch: the
// device side of cv_monoslam_tpu_torch/ops/control.py (the port's
// lax.cond). Plain C interface, loaded with ctypes by ops/_build.py.
//
// PyTorch 2.11, the version the card runs, has no Python API for
// conditional nodes, so this file builds them with the CUDA runtime's graph
// API (CUDA >= 12.4), the way later PyTorch versions do inside
// CUDAGraph::begin_capture_to_if_node:
//
//   cvms_if_begin(parent, pred, body):
//     1. a conditional handle in the graph the parent stream is capturing;
//     2. a one-thread kernel, captured on the parent stream, that sets the
//        handle from the device bool *pred when the graph runs;
//     3. an IF node after it, and the parent's capture continues after the
//        node;
//     4. the body stream starts capturing into the node's body graph.
//   cvms_if_end(body): the body stream's capture ends.
//
// Work captured on the body stream in between runs only when *pred was
// true at that point of the graph's execution. Bodies nest (a body stream
// that is itself capturing a body can be the parent of another).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t, or -1 when the parent stream is not capturing.
int cvms_if_begin(void* parent_stream, const void* pred, void* body_stream) {
  cudaStream_t parent = (cudaStream_t)parent_stream;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, &id, &graph,
                                             &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return -1;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_conditional_kernel<<<1, 1, 0, parent>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the node depends on what the parent captured last: the kernel above
  err = cudaStreamGetCaptureInfo(parent, &status, &id, &graph, &deps,
                                 &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

int cvms_if_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

}  // extern "C"
