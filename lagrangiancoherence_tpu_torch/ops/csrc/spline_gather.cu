// K1 spline_gather: F stacked fields evaluated at parcel positions, one
// gather group of lagrangiancoherence_tpu_torch's SETTLS loop per launch.
//
// Replaces the Pallas TPU kernel `_engine_kernel`
// (lagrangiancoherence_tpu/ops/pallas_interp.py:793) and its tile bodies.
// The TPU has no vector gather, so that kernel routes (8, 128) parcel tiles
// to windows of a lane-shifted padded copy of the coefficients and
// contracts one-hot bases on the MXU.  Hopper gathers from device memory
// directly, so here one thread evaluates one parcel, reading its taps
// straight from the resident (T, 2, ny, nx) stacks: no windows, no padded
// copies, no sorting, and no window overflow (the flag stays 0).
//
// What bounds it: gather latency and bytes.  At the flagship
// (1440 x 721 parcels, order 3) each parcel reads 16 taps x F fields from 4
// rows of 4 neighbouring columns; neighbouring threads take neighbouring
// parcels, whose taps mostly share cache lines, so the loads are served by
// L1/L2 more than by device memory.  This first version stages nothing in
// shared memory and uses no TMA.
//
// Numerics follow the plain PyTorch version (ops/interp.py) op for op; the
// per-parcel body is gather_math.cuh's gather_parcel, which the fused
// SETTLS step (settls_step.cu) shares.  Every operation goes through a
// round-to-nearest intrinsic so that nvcc cannot contract a multiply and an
// add into an FMA (a one-ulp slip at the fold boundary moves a tap and the
// value by ~1e-2).  Pole-home rows (`row < order` or `row >= ny - order`)
// evaluate only the order-1 'constant' bilinear on the raw fields; a block
// covers a segment of one home row, so that branch is uniform across each
// warp.
//
// Since the fused step took over the main path, K1 runs where a caller
// gathers one group at a time (chip_smoke.py's per-group loop).
#include "gather_math.cuh"

namespace {

using namespace lcs;

constexpr int kBlock = 128;

template <typename T, int ORDER, int NF>
__global__ void __launch_bounds__(kBlock)
spline_gather_kernel(const T* __restrict__ raw, const T* __restrict__ coeffs,
                     const T* __restrict__ px, const T* __restrict__ py,
                     T* __restrict__ out, int ny, int nx, int rows, int cols,
                     int row_offset, T x_min, T x_den, T y_min, T y_den) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * kBlock + threadIdx.x;
  if (col >= cols) return;
  const int64_t p = static_cast<int64_t>(row) * cols + col;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t out_plane = static_cast<int64_t>(rows) * cols;
  T acc[NF];
  gather_parcel<T, ORDER, NF>(PlanarRaw<T>{raw, plane}, plane,
                              PlanarTaps<T, NF>{coeffs, plane}, px[p], py[p],
                              row + row_offset, ny, nx, x_min, x_den, y_min,
                              y_den, acc);
#pragma unroll
  for (int f = 0; f < NF; ++f) out[f * out_plane + p] = acc[f];
}

template <typename T, int ORDER, int NF>
cudaError_t launch(const void* raw, const void* coeffs, const void* px,
                   const void* py, void* out, int ny, int nx, int rows,
                   int cols, int row_offset, double x_min, double x_den,
                   double y_min, double y_den, cudaStream_t stream) {
  const dim3 grid((cols + kBlock - 1) / kBlock, rows);
  spline_gather_kernel<T, ORDER, NF><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(raw), static_cast<const T*>(coeffs),
      static_cast<const T*>(px), static_cast<const T*>(py),
      static_cast<T*>(out), ny, nx, rows, cols, row_offset,
      static_cast<T>(x_min), static_cast<T>(x_den),
      static_cast<T>(y_min), static_cast<T>(y_den));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* raw, const void* coeffs, const void* px,
             const void* py, void* out, int ny, int nx, int rows, int cols,
             int row_offset, int order, int nf, long long f0, double x_min,
             double x_den, double y_min, double y_den, void* stream) {
  const int64_t offset = static_cast<int64_t>(f0) * ny * nx;
  const T* r = static_cast<const T*>(raw) + offset;
  const T* c = static_cast<const T*>(coeffs) + offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPLINE_GATHER_CASE(O, F)                                            \
  if (order == O && nf == F)                                                \
    return static_cast<int>(launch<T, O, F>(r, c, px, py, out, ny, nx,     \
                                            rows, cols, row_offset, x_min, \
                                            x_den, y_min, y_den, s));
  SPLINE_GATHER_CASE(3, 4)
  SPLINE_GATHER_CASE(3, 2)
  SPLINE_GATHER_CASE(1, 4)
  SPLINE_GATHER_CASE(1, 2)
#undef SPLINE_GATHER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points, bound with ctypes by ops/cuda_interp.py.  `raw`/`coeffs`
// point at the whole (fields, ny, nx) stacks; fields [f0, f0 + nf) are
// evaluated.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spline_gather_f32(const void* raw, const void* coeffs,
                                 const void* px, const void* py, void* out,
                                 int ny, int nx, int rows, int cols,
                                 int row_offset, int order, int nf,
                                 long long f0, double x_min, double x_den,
                                 double y_min, double y_den, void* stream) {
  return dispatch<float>(raw, coeffs, px, py, out, ny, nx, rows, cols,
                         row_offset, order, nf, f0, x_min, x_den, y_min,
                         y_den, stream);
}

extern "C" int spline_gather_f64(const void* raw, const void* coeffs,
                                 const void* px, const void* py, void* out,
                                 int ny, int nx, int rows, int cols,
                                 int row_offset, int order, int nf,
                                 long long f0, double x_min, double x_den,
                                 double y_min, double y_den, void* stream) {
  return dispatch<double>(raw, coeffs, px, py, out, ny, nx, rows, cols,
                          row_offset, order, nf, f0, x_min, x_den, y_min,
                          y_den, stream);
}
