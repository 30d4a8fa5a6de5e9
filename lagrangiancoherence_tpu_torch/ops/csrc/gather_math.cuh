// Per-parcel arithmetic shared by the gather kernels (spline_gather.cu,
// window_gather.cu): the scipy mode='wrap' fold, tap indices and B-spline
// weights, each operation through a round-to-nearest intrinsic so that nvcc
// cannot contract a multiply and an add into an FMA.  The plain PyTorch
// versions (ops/interp.py, ops/window_interp.py) run the same operations in
// the same order, which is what makes the kernels agree with them bit for
// bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lcs {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T> __device__ __forceinline__ T nan_value();
template <> __device__ __forceinline__ float nan_value<float>() { return __int_as_float(0x7fffffff); }
template <> __device__ __forceinline__ double nan_value<double>() { return __longlong_as_double(0x7fffffffffffffffLL); }

constexpr double kIndexLimit = 1073741824.0;  // 2**30, as ops/interp.py

// scipy mode='wrap' fold with period n-1 (ops/interp.py _fold_coord_wrap)
template <typename T>
__device__ __forceinline__ T fold_wrap(T x, int n) {
  const T sz = static_cast<T>(n - 1);
  if (x < T(0)) return add_rn(x, mul_rn(sz, add_rn(floor(div_rn(-x, sz)), T(1))));
  if (x > sz) return sub_rn(x, mul_rn(sz, floor(div_rn(x, sz))));
  return x;  // in range, or NaN
}

// int index of a floor() result: NaN -> 0, clamped to +-2**30
template <typename T>
__device__ __forceinline__ int to_index(T fl) {
  if (isnan(fl)) return 0;
  const T lim = static_cast<T>(kIndexLimit);
  return static_cast<int>(fmin(fmax(fl, -lim), lim));
}

__device__ __forceinline__ int mirror_tap(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return i;
}

// B-spline weights of the taps at offsets (-1, 0, 1, 2) (order 3) or
// (0, 1) (order 1) from floor(x), at fraction t = x - floor(x)
template <typename T, int ORDER>
__device__ __forceinline__ void bspline_weights(T t, T* w) {
  if constexpr (ORDER == 1) {
    w[0] = sub_rn(T(1), t);
    w[1] = t;
  } else {
    const T one_t = sub_rn(T(1), t);
    const T two_thirds = static_cast<T>(2.0 / 3.0);
    const T half = static_cast<T>(0.5);
    const T six = static_cast<T>(6.0);
    w[0] = div_rn(mul_rn(mul_rn(one_t, one_t), one_t), six);
    w[1] = add_rn(sub_rn(two_thirds, mul_rn(t, t)),
                  mul_rn(mul_rn(mul_rn(half, t), t), t));
    w[2] = add_rn(sub_rn(two_thirds, mul_rn(one_t, one_t)),
                  mul_rn(mul_rn(mul_rn(half, one_t), one_t), one_t));
    w[3] = div_rn(mul_rn(mul_rn(t, t), t), six);
  }
}

// mirrored tap indices and weights of one axis at folded coordinate f
template <typename T, int ORDER>
__device__ __forceinline__ void axis_taps(T f, int n, int* idx, T* w) {
  const T fl = floor(f);
  const int i0 = to_index(fl);
#pragma unroll
  for (int k = 0; k < ORDER + 1; ++k) idx[k] = mirror_tap(i0 + k - ORDER / 2, n);
  bspline_weights<T, ORDER>(sub_rn(f, fl), w);
}

}  // namespace lcs
