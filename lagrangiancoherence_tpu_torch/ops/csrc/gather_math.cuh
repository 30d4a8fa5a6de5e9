// Per-parcel arithmetic shared by the gather kernels (spline_gather.cu,
// settls_step.cu, window_gather.cu): the scipy mode='wrap' fold, tap
// indices and B-spline weights, and the whole per-parcel gather body
// (gather_parcel), each operation through a round-to-nearest intrinsic so
// that nvcc cannot contract a multiply and an add into an FMA.  The plain
// PyTorch versions (ops/interp.py, ops/window_interp.py) run the same
// operations in the same order, which is what makes the kernels agree with
// them bit for bit.
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

// Tap layouts: how gather_parcel reads NF prefiltered coefficients at one
// linear grid position `at`.
//
// PlanarTaps: NF (ny, nx) planes `plane` elements apart, K1's
// (fields, ny, nx) stack: one 4- or 8-byte load per field.
template <typename T, int NF>
struct PlanarTaps {
  const T* base;    // field 0
  int64_t plane;
  __device__ __forceinline__ void load(int64_t at, T* v) const {
#pragma unroll
    for (int f = 0; f < NF; ++f) v[f] = __ldg(base + f * plane + at);
  }
};

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// InterleavedTaps: (levels, ny, nx, 2) (u, v) pairs, one 8- (float) or
// 16-byte (double) load per level; field 2l + c is component c of level l.
// `base` is aligned to the pair.
template <typename T, int NF>
struct InterleavedTaps {
  static_assert(NF % 2 == 0, "interleaved taps come in (u, v) pairs");
  const T* base;    // level 0
  int64_t level;    // elements between levels: 2 * ny * nx
  __device__ __forceinline__ void load(int64_t at, T* v) const {
    using P = typename Pair<T>::type;
#pragma unroll
    for (int l = 0; l < NF / 2; ++l) {
      const P w = __ldg(reinterpret_cast<const P*>(base + l * level) + at);
      v[2 * l] = w.x;
      v[2 * l + 1] = w.y;
    }
  }
};

// Raw layouts: where gather_parcel's pole-home bilinear finds raw field f.
//
// PlanarRaw: (fields, ny, nx) planes `plane` elements apart, K1's stack.
template <typename T>
struct PlanarRaw {
  const T* base;    // field 0
  int64_t plane;
  __device__ __forceinline__ const T* field(int f) const {
    return base + f * plane;
  }
};

// SplitRaw: separate (levels, ny, nx) u and v stacks; field 2l + c is
// component c of level l, as in the interleaved coefficients.
template <typename T>
struct SplitRaw {
  const T* u;       // level 0
  const T* v;
  int64_t plane;
  __device__ __forceinline__ const T* field(int f) const {
    return ((f & 1) ? v : u) + (f >> 1) * plane;
  }
};

// One parcel's values of NF fields at position (px, py), the numerics of
// ops/interp.py interp_at_parcels_multi op for op:
//   * Q4 scaling `n * (p - min) / (max - min)`;
//   * a pole-home row (`home < ORDER` or `home >= ny - ORDER`) takes the
//     order-1 'constant' bilinear on the raw fields that `raw` locates: 0
//     outside [0, n-1] or for NaN;
//   * any other row takes the period-(n-1) wrap fold, mirror-edge taps and
//     B-spline weights on the prefiltered coefficients that `taps` reads,
//     y taps outer, x taps inner, weight wy[j] * wx[k] first; a NaN floor
//     indexes tap 0 and a tap outside the field reads NaN, as `jnp.take`
//     does in fill mode.
template <typename T, int ORDER, int NF, class Raw, class Taps>
__device__ __forceinline__ void gather_parcel(
    const Raw& raw, int64_t plane, const Taps& taps, T px, T py, int home,
    int ny, int nx, T x_min, T x_den, T y_min, T y_den, T* acc) {
  constexpr int NT = ORDER + 1;
  const T xs = div_rn(mul_rn(static_cast<T>(nx), sub_rn(px, x_min)), x_den);
  const T ys = div_rn(mul_rn(static_cast<T>(ny), sub_rn(py, y_min)), y_den);
  if (home < ORDER || home >= ny - ORDER) {
    const bool in_range = ys >= T(0) && ys <= static_cast<T>(ny - 1) &&
                          xs >= T(0) && xs <= static_cast<T>(nx - 1);
    if (!in_range) {
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[f] = T(0);
      return;
    }
    const T y0 = fmin(floor(ys), static_cast<T>(ny - 2));
    const T x0 = fmin(floor(xs), static_cast<T>(nx - 2));
    const T ty = sub_rn(ys, y0);
    const T tx = sub_rn(xs, x0);
    const T one_ty = sub_rn(T(1), ty);
    const T one_tx = sub_rn(T(1), tx);
    const T w00 = mul_rn(one_ty, one_tx);
    const T w01 = mul_rn(one_ty, tx);
    const T w10 = mul_rn(ty, one_tx);
    const T w11 = mul_rn(ty, tx);
    const int64_t base =
        static_cast<int64_t>(y0) * nx + static_cast<int64_t>(x0);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const T* r = raw.field(f) + base;
      acc[f] = add_rn(add_rn(add_rn(mul_rn(r[0], w00), mul_rn(r[1], w01)),
                             mul_rn(r[nx], w10)),
                      mul_rn(r[nx + 1], w11));
    }
    return;
  }
  int yi[NT], xi[NT];
  T wy[NT], wx[NT];
  axis_taps<T, ORDER>(fold_wrap(ys, ny), ny, yi, wy);
  axis_taps<T, ORDER>(fold_wrap(xs, nx), nx, xi, wx);
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = T(0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int64_t row_base = static_cast<int64_t>(yi[j]) * nx;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int64_t lin = row_base + xi[k];
      const bool ok = lin >= 0 && lin < plane;
      const T w = mul_rn(wy[j], wx[k]);
      T v[NF];
      taps.load(ok ? lin : 0, v);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f] = add_rn(acc[f], mul_rn(w, ok ? v[f] : nan_value<T>()));
    }
  }
}

}  // namespace lcs
