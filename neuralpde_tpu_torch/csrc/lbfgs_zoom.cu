// zoom_step: one step of optax's zoom line search (scale_by_zoom_linesearch,
// max_linesearch_steps=20, initial_guess_strategy="one") on a packed state
// in device memory.
//
// Replaces: the body of the lax.while_loop that optax.lbfgs() runs inside the
// JAX package's jitted step (neuralpde_tpu/train.py:86-96, under
// jax.jit(lax.scan(...)) at :165-179), where XLA keeps the search's state on
// the device.  The JAX package has no Pallas kernel for it.
//
// The state is the layout of neuralpde_tpu_torch/kernels/lbfgs_zoom.py (22
// values of the parameters' real dtype); the trial's value and slope are
// device scalars.  One launch applies one zoom_transition in place: the
// interval phase or the zoom phase (with _cubicmin/_quadmin), then the next
// trial stepsize and the `searching` flag that guards the next trial's
// CUDA-graph IF body; once the search ends it writes optax's info
// (stepsize, steps, decrease and curvature errors).
//
// Bound on the card: launch latency.  It reads and writes ~100 bytes with
// one thread and some 60 floating-point operations, nothing beside the
// launch.  Design: one thread, the plain version's scalar code line for
// line, so that a step of L-BFGS needs no host read.
//
// It computes what numpy computes on the plain version's scalars, to the
// bit: every constant is cast to T before use (NumPy 2's rule for a Python
// float against a float32 scalar), every product, sum, quotient and root is
// rounded on its own (the _rn intrinsics are never contracted into a fused
// multiply-add), and maximum/minimum are numpy's on scalars: NaN when the
// first operand is NaN, else the first when larger (smaller), else the
// second (fmax/fmin would drop a NaN that the plain version turns into an
// infinite error).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 20;

enum Field {
  kCount, kIntervalFound, kDone, kFailed, kStepsize, kLow, kHigh, kCubicRef,
  kSafeStepsize, kValue, kValueLow, kValueHigh, kValueCubicRef, kSafeValue,
  kValueInit, kSlope, kSlopeLow, kSlopeHigh, kSlopeInit, kDecErr, kCurvErr,
  kNext, kStateSize
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float divide(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double divide(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return (a < b || isnan(a)) ? a : b;
}

template <typename T>
__device__ T cubicmin(T a, T fa, T fpa, T b, T fb, T c, T fc) {
  const T C = fpa;
  const T db = sub(b, a), dc = sub(c, a);
  const T dbdc = mul(db, dc);
  const T denom = mul(mul(dbdc, dbdc), sub(db, dc));
  const T v0 = sub(sub(fb, fa), mul(C, db));
  const T v1 = sub(sub(fc, fa), mul(C, dc));
  const T A = divide(add(mul(mul(dc, dc), v0), mul(-mul(db, db), v1)), denom);
  const T B = divide(add(mul(-mul(dc, mul(dc, dc)), v0),
                      mul(mul(db, mul(db, db)), v1)), denom);
  const T radical = sub(mul(B, B), mul(mul(T(3.0), A), C));
  return add(a, divide(add(-B, sqrt_(radical)), mul(T(3.0), A)));
}

template <typename T>
__device__ T quadmin(T a, T fa, T fpa, T b, T fb) {
  const T db = sub(b, a);
  const T B = divide(sub(sub(fb, fa), mul(fpa, db)), mul(db, db));
  return sub(a, divide(fpa, mul(T(2.0), B)));
}

template <typename T>
__global__ void zoom_step_kernel(T* __restrict__ st, const T* __restrict__ value,
                                 const T* __restrict__ slope,
                                 bool* __restrict__ searching,
                                 T* __restrict__ learning_rate,
                                 int64_t* __restrict__ num_steps,
                                 T* __restrict__ decrease_error,
                                 T* __restrict__ curvature_error) {
  const T zero = T(0.0), inf = T(INFINITY);
  const int count = static_cast<int>(st[kCount]);
  bool interval_found = st[kIntervalFound] != zero;
  bool done = st[kDone] != zero, failed = false;
  T stepsize = st[kStepsize], low = st[kLow], high = st[kHigh];
  T cubic_ref = st[kCubicRef], safe_stepsize = st[kSafeStepsize];
  T value_prev = st[kValue], value_low = st[kValueLow];
  T value_high = st[kValueHigh], value_cubic_ref = st[kValueCubicRef];
  T safe_value = st[kSafeValue];
  const T value_init = st[kValueInit], slope_init = st[kSlopeInit];
  T slope_prev = st[kSlope], slope_low = st[kSlopeLow];
  T slope_high = st[kSlopeHigh];
  T dec_err, curv_err;
  const T fresh = st[kNext];
  const T v = *value, s = *slope;

  // errors(fresh, v, s)
  {
    T dec = sub(sub(v, value_init), mul(mul(T(1e-4), fresh), slope_init));
    const T approx = sub(s, mul(T(2 * 1e-4 - 1.0), slope_init));
    const T delta = sub(sub(v, value_init), mul(T(1e-6), fabs(value_init)));
    dec = maximum(minimum(maximum(approx, delta), dec), zero);
    const T curv = maximum(sub(fabs(s), mul(T(0.9), fabs(slope_init))), zero);
    dec_err = isnan(dec) ? inf : dec;
    curv_err = isnan(curv) ? inf : curv;
  }
  // Python's max(dec_err, curv_err) <= 0 (neither is NaN)
  const bool met = (curv_err > dec_err ? curv_err : dec_err) <= zero;

  if (!interval_found) {
    if (dec_err <= zero) {
      safe_stepsize = fresh;
      safe_value = v;
    }
    const bool set_high = dec_err > zero || (v >= value_prev && count > 0);
    const bool set_low = s >= zero && !set_high;
    if (set_low) {
      high = stepsize; value_high = value_prev; slope_high = slope_prev;
      low = fresh; value_low = v; slope_low = s;
    } else {
      low = stepsize; value_low = value_prev; slope_low = slope_prev;
      high = fresh; value_high = v; slope_high = s;
    }
    done = met;
    interval_found = set_high || set_low || done;
    failed = count + 1 >= kSteps && !done;
    cubic_ref = low;
    value_cubic_ref = value_low;
  } else {
    const bool too_small = fabs(sub(high, low)) <= T(1e-5);
    if (dec_err <= zero && v < safe_value) {
      safe_stepsize = fresh;
      safe_value = v;
    }
    done = met;
    const bool high_to_new = dec_err > zero || v >= value_low;
    const bool high_to_low = mul(s, sub(high, low)) >= zero && !high_to_new;
    if (high_to_new || high_to_low) {
      cubic_ref = high; value_cubic_ref = value_high;
    } else {
      cubic_ref = low; value_cubic_ref = value_low;
    }
    if (high_to_new) {
      high = fresh; value_high = v; slope_high = s;
    } else if (high_to_low) {
      high = low; value_high = value_low; slope_high = slope_low;
    }
    if (!high_to_new) {
      low = fresh; value_low = v; slope_low = s;
    }
    failed = (count + 1 >= kSteps || (too_small && safe_stepsize > zero)) &&
             !done;
  }
  stepsize = fresh;
  value_prev = v;
  slope_prev = s;
  if (failed && (safe_stepsize > zero || isinf(dec_err))) {
    stepsize = safe_stepsize;
    value_prev = safe_value;
  }
  const bool go = !(done || failed);
  T next = stepsize;
  if (go) {
    if (!interval_found) {
      next = mul(T(2.0), stepsize);
    } else {
      const T delta = fabs(sub(high, low));
      const T left = minimum(high, low), right = maximum(high, low);
      const T cubic = cubicmin(low, value_low, slope_low, high, value_high,
                               cubic_ref, value_cubic_ref);
      const T quad = quadmin(low, value_low, slope_low, high, value_high);
      if (add(left, mul(T(0.2), delta)) < cubic &&
          cubic < sub(right, mul(T(0.2), delta))) {
        next = cubic;
      } else if (add(left, mul(T(0.1), delta)) < quad &&
                 quad < sub(right, mul(T(0.1), delta))) {
        next = quad;
      } else {
        next = divide(add(low, high), T(2.0));
      }
    }
  }

  st[kCount] = T(count + 1);
  st[kIntervalFound] = interval_found ? T(1) : zero;
  st[kDone] = done ? T(1) : zero;
  st[kFailed] = failed ? T(1) : zero;
  st[kStepsize] = stepsize;
  st[kLow] = low;
  st[kHigh] = high;
  st[kCubicRef] = cubic_ref;
  st[kSafeStepsize] = safe_stepsize;
  st[kValue] = value_prev;
  st[kValueLow] = value_low;
  st[kValueHigh] = value_high;
  st[kValueCubicRef] = value_cubic_ref;
  st[kSafeValue] = safe_value;
  st[kSlope] = slope_prev;
  st[kSlopeLow] = slope_low;
  st[kSlopeHigh] = slope_high;
  st[kDecErr] = dec_err;
  st[kCurvErr] = curv_err;
  st[kNext] = next;
  *searching = go;
  if (!go) {
    *learning_rate = stepsize;
    *num_steps = count + 1;
    *decrease_error = dec_err;
    *curvature_error = curv_err;
  }
}

template <typename T>
int launch(void* state, const void* value, const void* slope, void* searching,
           void* learning_rate, void* num_steps, void* decrease_error,
           void* curvature_error, void* stream) {
  zoom_step_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(state), static_cast<const T*>(value),
      static_cast<const T*>(slope), static_cast<bool*>(searching),
      static_cast<T*>(learning_rate), static_cast<int64_t*>(num_steps),
      static_cast<T*>(decrease_error), static_cast<T*>(curvature_error));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int zoom_step_f32(void* state, const void* value, const void* slope,
                  void* searching, void* learning_rate, void* num_steps,
                  void* decrease_error, void* curvature_error, void* stream) {
  return launch<float>(state, value, slope, searching, learning_rate,
                       num_steps, decrease_error, curvature_error, stream);
}

int zoom_step_f64(void* state, const void* value, const void* slope,
                  void* searching, void* learning_rate, void* num_steps,
                  void* decrease_error, void* curvature_error, void* stream) {
  return launch<double>(state, value, slope, searching, learning_rate,
                        num_steps, decrease_error, curvature_error, stream);
}

}  // extern "C"
