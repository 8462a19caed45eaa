// tanh_jet2: the order-2 Taylor-mode rule of tanh: forward, backward and
// forward-mode (jvp).
//
// Replaces: the tanh rule that jax.experimental.jet applies inside
// neuralpde_tpu/ops/derivatives.py::jet_derivative (:84-97), at every hidden
// Dense layer of neuralpde_tpu/nn/core.py::Dense.apply (:119-123).  The JAX
// package leaves it to XLA fusion; it has no Pallas kernel for it.
//
// Derivative-convention series (as jax.experimental.jet uses), with
// a = tanh z and s = 1 - a^2:
//   a1 = s z1
//   a2 = s z2 - 2 a s z1^2
// Backward, given the cotangents (ga, ga1, ga2):
//   gz  = ga s - 2 a s z1 ga1 - (2 a s z2 + 2 s (1 - 3 a^2) z1^2) ga2
//   gz1 = s ga1 - 4 a s z1 ga2
//   gz2 = s ga2
// Forward mode, given the tangents (tz, tz1, tz2), with the same 3x3
// per-element Jacobian that the backward applies transposed:
//   ta  = s tz
//   ta1 = -2 a s z1 tz + s tz1
//   ta2 = c tz - 4 a s z1 tz1 + s tz2,   c = -2 a s z2 - 2 s (1 - 3 a^2) z1^2
// The jvp launches where the forward is differentiated in forward mode:
// Jacobian-vector products in the parameters (Gauss-Newton's J v) and
// residual gradients in the coordinates (gradient-enhanced rows).
//
// Bound on the card: device-memory bytes.  Forward reads 3 tensors and
// writes 3; backward reads 6 and writes 3 (it recomputes tanh from z instead
// of storing a); the jvp reads 6 and writes 3, like the backward.  At the
// main path's shape, 64 x 32768 in float32 (8 MiB a
// tensor), the forward moves 48 MiB and the backward 72 MiB, each in one pass.
// The plain PyTorch version runs each product and sum as its own pointwise
// kernel, each reading and writing whole tensors, and moves several times that.
// Design: one grid-stride loop over the H*N elements, each element read and
// written once, coalesced; no shared memory, nothing kept between elements.
// Products and differences are rounded one at a time in the plain version's
// order (no fused multiply-add): with the same tanh the two agree to the
// bit, and the arithmetic is free beside the memory traffic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;

__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_(double x) { return tanh(x); }

// Each product and difference is rounded on its own (the _rn intrinsics are
// never contracted into a fused multiply-add), in the order the plain
// PyTorch version evaluates them, so kernel and plain version round alike.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void tanh_jet2_forward_kernel(const T* __restrict__ z,
                                         const T* __restrict__ z1,
                                         const T* __restrict__ z2,
                                         T* __restrict__ a,
                                         T* __restrict__ a1,
                                         T* __restrict__ a2, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T t = tanh_(z[i]);
    const T s = sub(T(1), mul(t, t));
    const T d1 = z1[i];
    a[i] = t;
    a1[i] = mul(s, d1);
    // s z2 - ((((2 t) s) z1) z1)
    a2[i] = sub(mul(s, z2[i]), mul(mul(mul(mul(T(2), t), s), d1), d1));
  }
}

template <typename T>
__global__ void tanh_jet2_backward_kernel(
    const T* __restrict__ z, const T* __restrict__ z1,
    const T* __restrict__ z2, const T* __restrict__ ga,
    const T* __restrict__ ga1, const T* __restrict__ ga2, T* __restrict__ gz,
    T* __restrict__ gz1, T* __restrict__ gz2, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T t = tanh_(z[i]);
    const T s = sub(T(1), mul(t, t));
    const T d1 = z1[i];
    const T g1 = ga1[i];
    const T g2 = ga2[i];
    const T asd1 = mul(mul(t, s), d1);
    // ((2 t) s) z2 + ((((2 s) (1 - (3 t) t)) z1) z1)
    const T c2 = add(mul(mul(mul(T(2), t), s), z2[i]),
                     mul(mul(mul(mul(T(2), s), sub(T(1), mul(mul(T(3), t), t))),
                             d1), d1));
    gz[i] = sub(sub(mul(ga[i], s), mul(mul(T(2), asd1), g1)), mul(c2, g2));
    gz1[i] = sub(mul(s, g1), mul(mul(T(4), asd1), g2));
    gz2[i] = mul(s, g2);
  }
}

template <typename T>
__global__ void tanh_jet2_jvp_kernel(
    const T* __restrict__ z, const T* __restrict__ z1,
    const T* __restrict__ z2, const T* __restrict__ tz,
    const T* __restrict__ tz1, const T* __restrict__ tz2, T* __restrict__ ta,
    T* __restrict__ ta1, T* __restrict__ ta2, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T t = tanh_(z[i]);
    const T s = sub(T(1), mul(t, t));
    const T d1 = z1[i];
    const T u = tz[i];
    const T u1 = tz1[i];
    const T asd1 = mul(mul(t, s), d1);
    // -(((2 t) s) z2 + ((((2 s) (1 - (3 t) t)) z1) z1))
    const T c = -add(mul(mul(mul(T(2), t), s), z2[i]),
                     mul(mul(mul(mul(T(2), s), sub(T(1), mul(mul(T(3), t), t))),
                             d1), d1));
    ta[i] = mul(s, u);
    ta1[i] = sub(mul(s, u1), mul(mul(T(2), asd1), u));
    ta2[i] = add(sub(mul(c, u), mul(mul(T(4), asd1), u1)), mul(s, tz2[i]));
  }
}

dim3 blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks));
}

template <typename T>
int forward(const void* z, const void* z1, const void* z2, void* a, void* a1,
            void* a2, int64_t n, void* stream) {
  if (n <= 0) return 0;
  tanh_jet2_forward_kernel<T>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(z), static_cast<const T*>(z1),
          static_cast<const T*>(z2), static_cast<T*>(a), static_cast<T*>(a1),
          static_cast<T*>(a2), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* z, const void* z1, const void* z2, const void* ga,
             const void* ga1, const void* ga2, void* gz, void* gz1, void* gz2,
             int64_t n, void* stream) {
  if (n <= 0) return 0;
  tanh_jet2_backward_kernel<T>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(z), static_cast<const T*>(z1),
          static_cast<const T*>(z2), static_cast<const T*>(ga),
          static_cast<const T*>(ga1), static_cast<const T*>(ga2),
          static_cast<T*>(gz), static_cast<T*>(gz1), static_cast<T*>(gz2), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int jvp(const void* z, const void* z1, const void* z2, const void* tz,
        const void* tz1, const void* tz2, void* ta, void* ta1, void* ta2,
        int64_t n, void* stream) {
  if (n <= 0) return 0;
  tanh_jet2_jvp_kernel<T>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(z), static_cast<const T*>(z1),
          static_cast<const T*>(z2), static_cast<const T*>(tz),
          static_cast<const T*>(tz1), static_cast<const T*>(tz2),
          static_cast<T*>(ta), static_cast<T*>(ta1), static_cast<T*>(ta2), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers, bound with ctypes.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" {

int tanh_jet2_forward_f32(const void* z, const void* z1, const void* z2,
                          void* a, void* a1, void* a2, int64_t n,
                          void* stream) {
  return forward<float>(z, z1, z2, a, a1, a2, n, stream);
}

int tanh_jet2_forward_f64(const void* z, const void* z1, const void* z2,
                          void* a, void* a1, void* a2, int64_t n,
                          void* stream) {
  return forward<double>(z, z1, z2, a, a1, a2, n, stream);
}

int tanh_jet2_backward_f32(const void* z, const void* z1, const void* z2,
                           const void* ga, const void* ga1, const void* ga2,
                           void* gz, void* gz1, void* gz2, int64_t n,
                           void* stream) {
  return backward<float>(z, z1, z2, ga, ga1, ga2, gz, gz1, gz2, n, stream);
}

int tanh_jet2_backward_f64(const void* z, const void* z1, const void* z2,
                           const void* ga, const void* ga1, const void* ga2,
                           void* gz, void* gz1, void* gz2, int64_t n,
                           void* stream) {
  return backward<double>(z, z1, z2, ga, ga1, ga2, gz, gz1, gz2, n, stream);
}

int tanh_jet2_jvp_f32(const void* z, const void* z1, const void* z2,
                      const void* tz, const void* tz1, const void* tz2,
                      void* ta, void* ta1, void* ta2, int64_t n,
                      void* stream) {
  return jvp<float>(z, z1, z2, tz, tz1, tz2, ta, ta1, ta2, n, stream);
}

int tanh_jet2_jvp_f64(const void* z, const void* z1, const void* z2,
                      const void* tz, const void* tz1, const void* tz2,
                      void* ta, void* ta1, void* ta2, int64_t n,
                      void* stream) {
  return jvp<double>(z, z1, z2, tz, tz1, tz2, ta, ta1, ta2, n, stream);
}

}  // extern "C"
