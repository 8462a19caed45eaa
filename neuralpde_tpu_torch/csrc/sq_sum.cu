// sq_sum: the sum of squares of a float32 or float64 tensor, in float64.
//
// Replaces: no TPU kernel.  The JAX package leaves a separable residual's
// mean square, mean(r * r) in neuralpde_tpu/strategies.py::_msq, to XLA's
// fused reduction.  The port's factored mean-square route
// (compile/separable.py::factored_msq) writes the grid's residual once, by
// one matrix product, and this kernel is its only other pass over the grid.
//
// Bound on the card: device-memory bytes.  It reads each element once and
// writes one partial sum a block: at 16384^2 float32 that is 1.074 GB, 0.32
// ms at 3.35 TB/s.  The arithmetic (one float64 fused multiply-add an
// element) is a few percent of the card's float64 rate at that speed.
// Design:
// - pass 1: a grid-stride loop of 16-byte loads (float4 or double2), four
//   independent loads in flight a thread before their squares are added;
//   the elements before the first 16-byte boundary and after the last whole
//   vector are taken one by one.  Squares are accumulated in float64 in
//   each thread, then summed over the warp (shuffles) and the block (shared
//   memory) in float64, and each block writes its partial sum;
// - pass 2: one block sums the partials in a fixed order.
// No atomics: for a given launch (blocks from the size and the card's SM
// count) the order of every addition is fixed, so the result is the same
// from run to run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;
constexpr int kUnroll = 4;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
};

__device__ __forceinline__ void accumulate(double& acc, float v) {
  const double d = v;
  acc = fma(d, d, acc);
}
__device__ __forceinline__ void accumulate(double& acc, double v) {
  acc = fma(v, v, acc);
}
__device__ __forceinline__ void accumulate(double& acc, float4 v) {
  accumulate(acc, v.x);
  accumulate(acc, v.y);
  accumulate(acc, v.z);
  accumulate(acc, v.w);
}
__device__ __forceinline__ void accumulate(double& acc, double2 v) {
  accumulate(acc, v.x);
  accumulate(acc, v.y);
}

// The block's sum of v, valid in thread 0 (blockDim.x a multiple of 32, at
// most 1024).
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[32];
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < (blockDim.x >> 5)) v = warp_sums[lane];
    for (int offset = 16; offset > 0; offset >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, offset);
    }
  }
  return v;
}

// ``head``: elements before the first 16-byte-aligned address (fewer than a
// vector); the last ``n - tail`` elements follow the last whole vector.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sq_sum_partial_kernel(const T* __restrict__ x, int64_t n, int64_t head,
                          double* __restrict__ partials) {
  using V = typename Vec<T>::type;
  constexpr int kWidth = Vec<T>::width;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t nvec = (n - head) / kWidth;
  const int64_t tail = head + nvec * kWidth;
  double acc = 0.0;
  if (tid < head) accumulate(acc, x[tid]);
  if (tid < n - tail) accumulate(acc, x[tail + tid]);
  const V* v = reinterpret_cast<const V*>(x + head);
  int64_t i = tid;
  for (; i + (kUnroll - 1) * nthreads < nvec; i += kUnroll * nthreads) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) buf[u] = __ldg(v + i + u * nthreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(acc, buf[u]);
  }
  for (; i < nvec; i += nthreads) accumulate(acc, __ldg(v + i));
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinalThreads)
    sq_sum_final_kernel(const double* __restrict__ partials, int64_t blocks,
                        double* __restrict__ out) {
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < blocks; i += blockDim.x) {
    acc += partials[i];
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

template <typename T>
int launch(const void* x, int64_t n, void* partials, int64_t blocks,
           void* out, void* stream) {
  if (blocks < 1 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xs = static_cast<const T*>(x);
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(xs) % 16;
  int64_t head = static_cast<int64_t>(
      ((16 - misaligned) % 16) / sizeof(T));
  if (head > n) head = n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* parts = static_cast<double*>(partials);
  sq_sum_partial_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      xs, n, head, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sq_sum_final_kernel<<<1, kFinalThreads, 0, s>>>(
      parts, blocks, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``x``: n contiguous elements; ``partials``: ``blocks`` doubles of scratch;
// ``out``: one double.  Returns a cudaError_t (0 on success).
extern "C" int sq_sum_f32(const void* x, int64_t n, void* partials,
                          int64_t blocks, void* out, void* stream) {
  return launch<float>(x, n, partials, blocks, out, stream);
}

extern "C" int sq_sum_f64(const void* x, int64_t n, void* partials,
                          int64_t blocks, void* out, void* stream) {
  return launch<double>(x, n, partials, blocks, out, stream);
}

// The elements one block takes in one iteration of its main loop, per
// element type: the wrapper sizes the grid from them.
extern "C" int64_t sq_sum_block_items(int itemsize) {
  return static_cast<int64_t>(kThreads) * kUnroll * (16 / itemsize);
}
