// torch's float32 operations as the kernels of this directory must round and
// select them to equal the plain PyTorch versions bit for bit: torch's
// NaN-propagating minimum, maximum and clamp, the folds of amax and amin,
// ops/intersect.py::_safe_div, and the 3-vector products in torch's order
// of operations (each product and sum its own rounding under -fmad=false).
// fminf and fmaxf drop a NaN, so none is used bare. Included by
// prim_kernel.cu and cluster_glue.cu; one copy, so a fix here holds for
// both.

#pragma once

#include <cuda_runtime.h>

namespace {

// _safe_div's eps as torch rounds the Python float 1e-12 to float32.
constexpr float kEps12 = static_cast<float>(1e-12);

// torch.minimum / torch.maximum (NaN if either is, a first).
__device__ __forceinline__ float tmin2(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax2(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// clamp(min=), clamp(max=) and clamp(min, max), NaN kept.
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
// amax / amin's fold: the accumulator kept where it is NaN or strictly
// beyond the next value.
__device__ __forceinline__ float amax_step(float acc, float x) {
  return (acc != acc || acc > x) ? acc : x;
}
__device__ __forceinline__ float amin_step(float acc, float x) {
  return (acc != acc || acc < x) ? acc : x;
}
// _safe_div(num, den) with eps 1e-12.
__device__ __forceinline__ float safe_div(float num, float den) {
  const float s = fabsf(den) < kEps12 ? (den < 0.0f ? -kEps12 : kEps12)
                                      : den;
  return num / s;
}
// ops/intersect.py's dot3 and cross3.
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
__device__ __forceinline__ void cross3(float* out, const float* a,
                                       const float* b) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

}  // namespace
