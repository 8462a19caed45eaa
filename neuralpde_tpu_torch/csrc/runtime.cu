// Library-wide helpers for the kernels' ctypes bindings.

#include <cuda_runtime.h>

extern "C" const char* neuralpde_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// An empty kernel: its launch is the least time any kernel launch takes,
// the floor of a kernel bound by launch latency (chip_smoke.py times it).
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int neuralpde_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
