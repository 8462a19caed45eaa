// Library-wide helpers for the kernels' ctypes bindings.

#include <cuda_runtime.h>

extern "C" const char* neuralpde_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
