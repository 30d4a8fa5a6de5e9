// ftle_stencil: the flow map's deformation gradient and its FTLE norm, one
// kernel each.
//
// Replaces no Pallas kernel.  The JAX package leaves both stages to XLA
// (lagrangiancoherence_tpu/models/ftle.py, ops/stencil.py), and the port's
// plain PyTorch path (models/ftle.py, ops/stencil.py) runs them as ~60
// small launches a field: the sphere map, four `roll`s and their arithmetic
// for each of six derivatives, the metric divisions, a stack, then the
// norm's ~20 elementwise ops.  Each longitude derivative also uploaded the
// latitudes from the host, a pageable copy that makes the host wait for the
// card.  Here:
//
// * `ftle_gradient_kernel` maps the departure points to the sphere
//   (X, Y, Z) once per point into shared memory, as float32 (quirk Q6), and
//   writes the (9, ny, nx) stack [dXdx, dXdy, dYdx, dYdy, dZdx, dZdy, 0, 0,
//   0] in the reference's order (LagrangianCoherence LCS/LCS.py:171-225).
//   A block stages a 36 x 36 tile (its 32 x 32 outputs and a 2-point halo,
//   the longitudes cyclic, the rows outside the grid left out: the edge
//   rules never read them), so the map costs 1.27 evaluations a point and
//   never reaches device memory.  The row scale `dx` (R cos(lat) dlon) is a
//   tensor the caller keeps on the card (ops/stencil.py `row_scale`).
// * `ftle_norm_kernel` reads the nine rows of a stack and writes the
//   largest singular value of the 2x3 block (models/ftle.py
//   `_sigma_max_2xk`), NaN where any of the nine is NaN.
//
// Both repeat the plain path's operations in its order, each through a
// round-to-nearest intrinsic so that nvcc cannot contract a multiply and an
// add, with IEEE division and square root and the library's sin/cos: on the
// card they give the plain path's values bit for bit (chip_smoke.py phase
// 3e).  Torch divides by a Python scalar as a multiply by its reciprocal;
// the stencil's divisors (2 and 4) have exact reciprocals, so the kernel
// multiplies by them too.
//
// What bounds them: bytes.  At the flagship (721 x 1440, float32) the
// gradient reads the departure points (8.3 MB) and writes the stack (37.4
// MB); the norm reads the stack and writes the field (41.5 MB): 87.2 MB,
// 26.0 us at 3.35 TB/s.  Their arithmetic (four sin/cos a staged point,
// six stencils, a 2x2 eigenvalue) is a few hundred operations a point.
// Measured there (NVIDIA H100 80GB HBM3, 700 W; torch.profiler over 50
// calls): 23.0 us the gradient, 11.8 us the norm (its stack still in L2),
// against ~0.57 ms of device time for the PyTorch path's launches.
#include <cstdint>

#include <cuda_runtime.h>

#include "gather_math.cuh"

namespace {

using lcs::add_rn;
using lcs::div_rn;
using lcs::mul_rn;
using lcs::sub_rn;

constexpr int kTileX = 32;                        // output columns a block
constexpr int kThreadsY = 8;                      // warps a block
constexpr int kRowsPerThread = 4;
constexpr int kTileY = kThreadsY * kRowsPerThread;  // output rows a block
constexpr int kHalo = 2;                          // the stencil's reach
constexpr int kStageX = kTileX + 2 * kHalo;
constexpr int kStageY = kTileY + 2 * kHalo;
constexpr int kNormThreads = 256;

constexpr double kDeg = 3.141592653589793 / 180.0;  // np.pi / 180.0
constexpr double kEarthRadius = 6371000.0;           // grid.EARTH_RADIUS

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

// the NaN that torch.full((), float("nan")) holds
template <typename T> __device__ __forceinline__ T full_nan();
template <> __device__ __forceinline__ float full_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double full_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// 4th-order centred difference (ops/stencil.py `_centered`):
// (4/3) (p1 - m1) / 2 - (1/3) (p2 - m2) / 4
__device__ __forceinline__ float centred(float m2, float m1, float p1,
                                         float p2) {
  const float a = mul_rn(mul_rn(static_cast<float>(4.0 / 3.0),
                                sub_rn(p1, m1)), 0.5f);
  const float b = mul_rn(mul_rn(static_cast<float>(1.0 / 3.0),
                                sub_rn(p2, m2)), 0.25f);
  return sub_rn(a, b);
}

// latitude derivative at stage row r, grid row gi: one-sided within two
// rows of each edge, the backward rule last (fourth_order_derivative, dim 0)
__device__ __forceinline__ float lat_stencil(const float (*s)[kStageX],
                                             int r, int c, int gi, int ny) {
  if (gi >= ny - 2) return mul_rn(sub_rn(s[r][c], s[r - 1][c]), 0.5f);
  if (gi < 2) return mul_rn(sub_rn(s[r + 1][c], s[r][c]), 0.5f);
  return centred(s[r - 2][c], s[r - 1][c], s[r + 1][c], s[r + 2][c]);
}

// longitude derivative: cyclic, centred everywhere (isglobal=True)
__device__ __forceinline__ float lon_stencil(const float (*s)[kStageX],
                                             int r, int c) {
  return centred(s[r][c - 2], s[r][c - 1], s[r][c + 1], s[r][c + 2]);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kTileX * kThreadsY)
ftle_gradient_kernel(const Tin* __restrict__ x, const Tin* __restrict__ y,
                     const Tout* __restrict__ dx, Tout* __restrict__ out,
                     int ny, int nx, Tin dy) {
  __shared__ float sx[kStageY][kStageX];
  __shared__ float sy[kStageY][kStageX];
  __shared__ float sz[kStageY][kStageX];
  const int c0 = blockIdx.x * kTileX;
  const int r0 = blockIdx.y * kTileY;

  // the sphere map (models/ftle.py `flowmap_gradient`) in the input's
  // dtype, then the cast to float32 for the stencil
  const Tin deg = static_cast<Tin>(kDeg);
  const Tin radius = static_cast<Tin>(kEarthRadius);
  for (int q = threadIdx.y * kTileX + threadIdx.x; q < kStageY * kStageX;
       q += kTileX * kThreadsY) {
    const int lr = q / kStageX, lc = q % kStageX;
    const int gr = r0 - kHalo + lr;
    if (gr < 0 || gr >= ny) continue;
    int gc = (c0 - kHalo + lc) % nx;
    if (gc < 0) gc += nx;
    const int64_t at = static_cast<int64_t>(gr) * nx + gc;
    const Tin lon = mul_rn(x[at], deg);
    const Tin colat = mul_rn(sub_rn(y[at], static_cast<Tin>(90.0)), deg);
    const Tin rs = mul_rn(radius, sin_(colat));
    sx[lr][lc] = static_cast<float>(mul_rn(rs, cos_(lon)));
    sy[lr][lc] = static_cast<float>(mul_rn(rs, sin_(lon)));
    sz[lr][lc] = static_cast<float>(mul_rn(radius, cos_(colat)));
  }
  __syncthreads();

  const int gj = c0 + threadIdx.x;
  if (gj >= nx) return;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int c = threadIdx.x + kHalo;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int lr = threadIdx.y + k * kThreadsY;
    const int gi = r0 + lr;
    if (gi >= ny) break;
    const int r = lr + kHalo;
    const Tout dxr = dx[gi];
    // longitude: the float32 stencil cast back, over the row scale in the
    // wider type; latitude: over dy in the input's type
    const float lon[3] = {lon_stencil(sx, r, c), lon_stencil(sy, r, c),
                          lon_stencil(sz, r, c)};
    const float lat[3] = {lat_stencil(sx, r, c, gi, ny),
                          lat_stencil(sy, r, c, gi, ny),
                          lat_stencil(sz, r, c, gi, ny)};
    Tout* o = out + static_cast<int64_t>(gi) * nx + gj;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      o[(2 * f) * plane] =
          div_rn(static_cast<Tout>(static_cast<Tin>(lon[f])), dxr);
      o[(2 * f + 1) * plane] =
          static_cast<Tout>(div_rn(static_cast<Tin>(lat[f]), dy));
    }
    o[6 * plane] = Tout(0);
    o[7 * plane] = Tout(0);
    o[8 * plane] = Tout(0);
  }
}

// largest singular value of the 2x3 block (rows a, b) through the 2x2 Gram
// eigenvalue, each sum from 0 as Python's sum() takes it
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
ftle_norm_kernel(const T* __restrict__ t, T* __restrict__ out, int64_t n,
                 int compat) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kNormThreads
                    + threadIdx.x;
  if (p >= n) return;
  T v[9];
  bool bad = false;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    v[k] = t[k * n + p];
    bad |= isnan(v[k]);
  }
  if (bad) {
    out[p] = full_nan<T>();
    return;
  }
  // compat (quirk Q1): rows (0, 1, 2) and (3, 4, 5); else the Jacobian's
  // columns (0, 2, 4) and (1, 3, 5)
  const T a[3] = {v[0], compat ? v[1] : v[2], compat ? v[2] : v[4]};
  const T b[3] = {compat ? v[3] : v[1], compat ? v[4] : v[3], v[5]};
  T g11 = T(0), g22 = T(0), g12 = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g11 = add_rn(g11, mul_rn(a[k], a[k]));
    g22 = add_rn(g22, mul_rn(b[k], b[k]));
    g12 = add_rn(g12, mul_rn(a[k], b[k]));
  }
  const T tr = add_rn(g11, g22);
  const T d = sub_rn(g11, g22);
  T q = add_rn(mul_rn(d, d), mul_rn(mul_rn(T(4), g12), g12));
  q = q < T(0) ? T(0) : q;            // clamp(min=0), NaN passes
  T lam = mul_rn(T(0.5), add_rn(tr, sqrt_rn(q)));
  lam = lam < T(0) ? T(0) : lam;
  out[p] = sqrt_rn(lam);
}

template <typename Tin, typename Tout>
int launch_gradient(const void* x, const void* y, const void* dx, void* out,
                    int ny, int nx, double dy, void* stream) {
  const dim3 block(kTileX, kThreadsY);
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY);
  // dy cast from the double the caller holds, as torch casts a Python
  // scalar
  ftle_gradient_kernel<Tin, Tout><<<grid, block, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(y),
      static_cast<const Tout*>(dx), static_cast<Tout*>(out), ny, nx,
      static_cast<Tin>(dy));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_norm(const void* stack, void* out, long long n, int compat,
                void* stream) {
  const long long blocks = (n + kNormThreads - 1) / kNormThreads;
  ftle_norm_kernel<T><<<static_cast<unsigned>(blocks), kNormThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(stack), static_cast<T*>(out), n, compat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (ny, nx) departure lon/lat; dx: (ny,) row scale in the stack's
// dtype; out: (9, ny, nx), float64 when out_f64, else the input's dtype
extern "C" int ftle_gradient_f32(const void* x, const void* y,
                                 const void* dx, void* out, int ny, int nx,
                                 double dy, int out_f64, void* stream) {
  if (out_f64)
    return launch_gradient<float, double>(x, y, dx, out, ny, nx, dy, stream);
  return launch_gradient<float, float>(x, y, dx, out, ny, nx, dy, stream);
}

extern "C" int ftle_gradient_f64(const void* x, const void* y,
                                 const void* dx, void* out, int ny, int nx,
                                 double dy, int out_f64, void* stream) {
  if (!out_f64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gradient<double, double>(x, y, dx, out, ny, nx, dy, stream);
}

// stack: (9, n) contiguous; out: (n,)
extern "C" int ftle_norm_f32(const void* stack, void* out, long long n,
                             int compat, void* stream) {
  return launch_norm<float>(stack, out, n, compat, stream);
}

extern "C" int ftle_norm_f64(const void* stack, void* out, long long n,
                             int compat, void* stream) {
  return launch_norm<double>(stack, out, n, compat, stream);
}
