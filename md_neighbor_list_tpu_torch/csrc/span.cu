// Device spans: empty kernels whose names mark the edges of a stretch of
// device work in a profiler trace (utils/trace.py::device_span). Not a port
// of a TPU kernel. A pair launched into a captured graph's conditional body
// before and after the body's work brackets that work on the device's own
// timeline, which a host-side range cannot do for a graph replay: the trace
// shows `mdnl::span_begin_<span>()`, the span's kernels, then
// `mdnl::span_end_<span>()`, one after the other on the stream.
//
// Each launch costs one empty kernel (a few microseconds of device time). The
// launches are not counted in the port's kernel launch counters.

#include <cuda_runtime.h>

namespace mdnl {

__global__ void span_begin_rebuild() {}
__global__ void span_end_rebuild() {}
// the step's half list inside a rebuild (K2, the list's count, starts and
// pack); no span's name may contain another's `span_begin_<name>`
__global__ void span_begin_halflist() {}
__global__ void span_end_halflist() {}
// the incremental rebuild's own work inside a rebuild (wrap, keys, mover sort
// and expand, window predicate, K8)
__global__ void span_begin_increment() {}
__global__ void span_end_increment() {}

}  // namespace mdnl

extern "C" int mdnl_span_begin_rebuild(void* stream) {
  mdnl::span_begin_rebuild<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" int mdnl_span_end_rebuild(void* stream) {
  mdnl::span_end_rebuild<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" int mdnl_span_begin_halflist(void* stream) {
  mdnl::span_begin_halflist<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" int mdnl_span_end_halflist(void* stream) {
  mdnl::span_end_halflist<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" int mdnl_span_begin_increment(void* stream) {
  mdnl::span_begin_increment<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" int mdnl_span_end_increment(void* stream) {
  mdnl::span_end_increment<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
