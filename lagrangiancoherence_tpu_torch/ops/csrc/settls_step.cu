// settls_step: one whole SETTLS step of every parcel in one launch, the
// main path of lagrangiancoherence_tpu_torch (engine "auto" / "dma-all").
//
// Replaces, on that route, the Pallas TPU kernel `_engine_kernel`
// (lagrangiancoherence_tpu/ops/pallas_interp.py:793), which the JAX scan
// body launches once per gather group with the Euler and SETTLS updates
// and the Q5 clamp/wrap around it in XLA
// (lagrangiancoherence_tpu/models/settls.py:581-643).  Its first Hopper
// port, K1 (spline_gather.cu), kept that structure: five gather launches
// per step, each writing (F, ny, nx) values that ~30 elementwise torch
// kernels then read and write as whole planes.  A parcel's step reads only
// its own position, so here one thread carries its parcel through the
// whole step with the position in registers:
//
//   F=2 Euler gather at level t;  x += (dt*conv_x)*ua,  y += (dt*conv_y)*va;
//   clamp/wrap;  then settls_order times:  F=4 gather at levels (t, t+1);
//   x += ((0.5*dt)*conv_x)*((ua + 2*u_t) - u_t1), the same for y;
//   clamp/wrap.
//
// and writes the end position once.  Each thread reads and writes only its
// own parcel, so the output may alias the input (an in-place step).
//
// The positions may be a block of the grid: `rows` x `cols` parcels, parcel
// (row, col) at `row * cols + col`, while the winds and coefficients stay
// the whole (ny, nx) grid (the JAX package's shard_map block, whose gathers
// address the replicated winds globally, models/settls.py:288-303).
// `conv_x` then holds one value per block row.  The pole-row test keys on
// the parcel's global home row: `home_rows[row]` when given (a latitude
// block, whose last block may hold reflected pad rows), else the block row
// itself (the whole grid, or a block that starts at row 0).
//
// What bounds it: at the flagship (1440 x 721 parcels, order 3, float32)
// a step must read the positions (8.3 MB) and the two coefficient levels
// (16.6 MB) and write the positions (8.3 MB): 33.2 MB, 9.9 us at
// 3.35 TB/s.  Five gathers and the updates are ~950 flop per parcel,
// ~0.99 GFLOP, 14.7 us at 67 TFLOP/s: the step is bound by operations, and
// the IEEE divisions (eight per gather, kept for bit identity) cost more
// than one flop each.  The taps of a parcel's 4x4 stencil are shared with
// its neighbours', so loads hit L1/L2; what the design does about them:
//   * the prefiltered coefficients come as (T, ny, nx, 2) interleaved
//     (u, v) pairs, one 8-byte (16-byte in double) load per tap per level,
//     where K1 made one load per field from planes 4.15 MB apart;
//   * the raw winds, read only by the pole-home rows' bilinear, stay the
//     caller's planar (T, ny, nx) u and v stacks: nothing is copied for
//     them;
//   * the SM's unified memory is carved out for L1 (no shared memory is
//     used);
//   * blocks are 32 x 4 tiles: each warp is one row, so the pole-row branch
//     is uniform per warp, and a block's taps span fewer cache lines than a
//     128-wide row segment's;
//   * registers are bounded at 64 a thread (8 blocks of 128, half
//     occupancy).
// On an H100 (700 W), float32 order 3, the 128-wide row segment was
// 1.5-2.1% slower; a bound of 32 registers (full occupancy) spilled ~270
// bytes a thread and took 2.2x as long; the compiler's own count (122
// registers, a quarter occupancy) took 1.3-1.4x as long (PERF.md).  Nothing
// is staged in shared memory, and there is no TMA or persistent grid.
//
// Numerics: every operation goes through a round-to-nearest intrinsic in
// the order in which the plain step (ops/cuda_settls.py settls_step_torch)
// evaluates it in eager torch, so the two agree bit for bit.  The clamp
// follows torch.where's comparisons (a NaN latitude becomes y_min, a NaN
// longitude stays NaN) and the wrap torch.remainder on floats (fmod, then
// the sign fix-up), not a - b*floor(a/b).  Pole-home rows take the order-1
// 'constant' bilinear on the raw fields at every gather of the step.
// There is no window, so no overflow flag.
#include "gather_math.cuh"

namespace {

using namespace lcs;

constexpr int kTileX = 32;      // parcels along a row: one warp
constexpr int kTileY = 4;       // rows per block
constexpr int kMinBlocks = 8;   // resident blocks per SM: 64 registers

template <typename T>
struct StepParams {
  const T* u;         // raw (ny, nx) u planes from level t
  const T* v;         // raw (ny, nx) v planes from level t
  const T* coeffs;    // interleaved (ny, nx, 2) coefficient levels from t
  const T* px_in;
  const T* py_in;
  T* px_out;          // may alias px_in
  T* py_out;          // may alias py_in
  const T* conv_x;    // (rows,) deg/s per m/s on each home row
  const T* dt;        // 0-dim, on the card
  const int* home_rows;  // (rows,) global home rows, or null: the block row
  int ny, nx;         // the winds' grid
  int rows, cols;     // the positions' block
  int settls_order, cyclic;
  T conv_y, x_min, x_max, x_den, y_min, y_max, y_den;
};

// torch.remainder(a, b) on floats: fmod, then `mod += b` where mod is not 0
// and its sign differs from b's
template <typename T>
__device__ __forceinline__ T torch_remainder(T a, T b) {
  T mod = fmod(a, b);
  if (mod != T(0) && ((b < T(0)) != (mod < T(0)))) mod = add_rn(mod, b);
  return mod;
}

// Q5 (LagrangianCoherence LCS/trajectory.py:89-97) as ops/cuda_settls.py
// clamp_wrap evaluates it with torch.where
template <typename T>
__device__ __forceinline__ void clamp_wrap(T& x, T& y, const StepParams<T>& p) {
  y = (y > p.y_min) ? y : p.y_min;
  y = (y < p.y_max) ? y : p.y_max;
  if (p.cyclic) {
    x = (x > T(-180)) ? x : torch_remainder(x, T(180));
    x = (x < T(180)) ? x : add_rn(torch_remainder(x, T(180)), T(-180));
  } else {
    x = (x < p.x_min) ? p.x_min : x;
    x = (x > p.x_max) ? p.x_max : x;
  }
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(kTileX * kTileY, kMinBlocks)
settls_step_kernel(const StepParams<T> p) {
  const int col = blockIdx.x * kTileX + threadIdx.x;
  const int row = blockIdx.y * kTileY + threadIdx.y;
  if (col >= p.cols || row >= p.rows) return;
  const int64_t plane = static_cast<int64_t>(p.ny) * p.nx;
  const int64_t at = static_cast<int64_t>(row) * p.cols + col;
  const SplitRaw<T> raw{p.u, p.v, plane};
  T x = p.px_in[at];
  T y = p.py_in[at];
  const T dt = __ldg(p.dt);
  const T cx = __ldg(p.conv_x + row);
  const int home = p.home_rows ? __ldg(p.home_rows + row) : row;

  // Euler first guess (LagrangianCoherence LCS/trajectory.py:82-87)
  T w[2];
  gather_parcel<T, ORDER, 2>(raw, plane,
                             InterleavedTaps<T, 2>{p.coeffs, 2 * plane}, x, y,
                             home, p.ny, p.nx, p.x_min, p.x_den, p.y_min,
                             p.y_den, w);
  const T ua = w[0], va = w[1];
  x = add_rn(x, mul_rn(mul_rn(dt, cx), ua));
  y = add_rn(y, mul_rn(mul_rn(dt, p.conv_y), va));
  clamp_wrap(x, y, p);

  // SETTLS fixed-point iterations, cumulative form (Q3)
  // (LagrangianCoherence LCS/trajectory.py:100-124)
  const T half_dt = mul_rn(T(0.5), dt);
  const T kx = mul_rn(half_dt, cx);
  const T ky = mul_rn(half_dt, p.conv_y);
#pragma unroll 1
  for (int it = 0; it < p.settls_order; ++it) {
    T d[4];
    gather_parcel<T, ORDER, 4>(raw, plane,
                               InterleavedTaps<T, 4>{p.coeffs, 2 * plane}, x,
                               y, home, p.ny, p.nx, p.x_min, p.x_den, p.y_min,
                               p.y_den, d);
    x = add_rn(x, mul_rn(kx, sub_rn(add_rn(ua, mul_rn(T(2), d[0])), d[2])));
    y = add_rn(y, mul_rn(ky, sub_rn(add_rn(va, mul_rn(T(2), d[1])), d[3])));
    clamp_wrap(x, y, p);
  }
  p.px_out[at] = x;
  p.py_out[at] = y;
}

template <typename T, int ORDER>
cudaError_t launch(const StepParams<T>& p, cudaStream_t stream) {
  auto kernel = settls_step_kernel<T, ORDER>;
  static bool carved = false;   // once per instantiation
  if (!carved) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (e != cudaSuccess) return e;
    carved = true;
  }
  const dim3 grid((p.cols + kTileX - 1) / kTileX,
                  (p.rows + kTileY - 1) / kTileY);
  kernel<<<grid, dim3(kTileX, kTileY), 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* u, const void* v, const void* coeffs,
             const void* px_in, const void* py_in, void* px_out,
             void* py_out, const void* conv_x, const void* dt,
             const void* home_rows, int ny, int nx, int rows, int cols,
             long long t, int order, int settls_order, int cyclic,
             double conv_y, double x_min, double x_max, double y_min,
             double y_max, void* stream) {
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  StepParams<T> p;
  p.u = static_cast<const T*>(u) + t * plane;
  p.v = static_cast<const T*>(v) + t * plane;
  p.coeffs = static_cast<const T*>(coeffs) + 2 * t * plane;
  p.px_in = static_cast<const T*>(px_in);
  p.py_in = static_cast<const T*>(py_in);
  p.px_out = static_cast<T*>(px_out);
  p.py_out = static_cast<T*>(py_out);
  p.conv_x = static_cast<const T*>(conv_x);
  p.dt = static_cast<const T*>(dt);
  p.home_rows = static_cast<const int*>(home_rows);
  p.ny = ny;
  p.nx = nx;
  p.rows = rows;
  p.cols = cols;
  p.settls_order = settls_order;
  p.cyclic = cyclic;
  // each bound cast from the double the caller holds, as torch casts a
  // Python scalar; the Q4 denominators are (max - min) in double first
  p.conv_y = static_cast<T>(conv_y);
  p.x_min = static_cast<T>(x_min);
  p.x_max = static_cast<T>(x_max);
  p.x_den = static_cast<T>(x_max - x_min);
  p.y_min = static_cast<T>(y_min);
  p.y_max = static_cast<T>(y_max);
  p.y_den = static_cast<T>(y_max - y_min);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 3) return static_cast<int>(launch<T, 3>(p, s));
  if (order == 1) return static_cast<int>(launch<T, 1>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points, bound with ctypes by ops/cuda_settls.py.  `u` and `v` are
// the whole (T, ny, nx) planar raw stacks and `coeffs` the whole
// (T, ny, nx, 2) interleaved coefficient stack; step t reads levels t and
// t+1.  The positions and outputs are (rows, cols), `conv_x` and
// `home_rows` (null for the block rows themselves) hold `rows` values.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int settls_step_f32(const void* u, const void* v,
                               const void* coeffs, const void* px_in,
                               const void* py_in, void* px_out, void* py_out,
                               const void* conv_x, const void* dt,
                               const void* home_rows, int ny, int nx,
                               int rows, int cols, long long t, int order,
                               int settls_order, int cyclic, double conv_y,
                               double x_min, double x_max, double y_min,
                               double y_max, void* stream) {
  return dispatch<float>(u, v, coeffs, px_in, py_in, px_out, py_out, conv_x,
                         dt, home_rows, ny, nx, rows, cols, t, order,
                         settls_order, cyclic, conv_y, x_min, x_max, y_min,
                         y_max, stream);
}

extern "C" int settls_step_f64(const void* u, const void* v,
                               const void* coeffs, const void* px_in,
                               const void* py_in, void* px_out, void* py_out,
                               const void* conv_x, const void* dt,
                               const void* home_rows, int ny, int nx,
                               int rows, int cols, long long t, int order,
                               int settls_order, int cyclic, double conv_y,
                               double x_min, double x_max, double y_min,
                               double y_max, void* stream) {
  return dispatch<double>(u, v, coeffs, px_in, py_in, px_out, py_out, conv_x,
                          dt, home_rows, ny, nx, rows, cols, t, order,
                          settls_order, cyclic, conv_y, x_min, x_max, y_min,
                          y_max, stream);
}
