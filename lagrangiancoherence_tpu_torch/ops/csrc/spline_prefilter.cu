// spline_prefilter: the cubic spline prefilter of a (B, ny, nx) stack as a
// banded solve, along latitude and then along longitude, in one call.
//
// Replaces no Pallas kernel.  The JAX package's prefilter
// (lagrangiancoherence_tpu/ops/interp.py `prefilter`) multiplies by the
// dense inverse of scipy's mode='wrap' system and leaves that einsum to
// XLA; the port's dense path (ops/interp.py) does the same as two float32
// GEMMs, O(n^2) work a line.  The system itself is tridiagonal at order 3
// (1/6, 4/6, 1/6, the out-of-range taps mirrored, so 2/6 beside the edge
// rows), and every line of an axis is one independent system.  Here each
// line is solved by forward and back substitution with the LU factors of
// that band (ops/interp.py `spline_band_factors`, computed in float64 on
// the host, passed in the stack's dtype): the same linear system, solved
// exactly up to rounding, in float32 or float64 FMAs, with no TF32 and no
// truncated sums.
//
// What bounds it: bytes.  A substitution is ~2 FMAs an element, so the
// least the card can move is the stack read once and the coefficients
// written once.  The latitude sweep reads the input and writes `out`; the
// longitude sweep solves `out` in place, so no intermediate stack is
// allocated, and each element crosses device memory four times.
//
// The design problem is that each line is a serial recurrence of ny or nx
// steps.  Both sweeps cut a line into chunks that threads solve at once,
// and join them exactly: a first pass over a chunk gives the affine map
// from the value entering it to the value leaving it (the local solution
// from 0, and the product of the multipliers), the maps are composed in
// order to give every chunk the value entering it, and a second pass runs
// the plain recurrence from that value, writing each element.  Nothing is
// truncated: the carry enters every element through the recurrence itself.
//
// * Latitude: a block stages a tile of W whole columns of one level in
//   shared memory (W = 32 float32 or 16 float64 columns, 128-byte rows, so
//   loads and stores coalesce), and its 512 threads take W columns x
//   512 / W chunks; the chunks' maps are joined by one thread a column.
// * Longitude: a warp stages one whole row in shared memory and each lane
//   takes a chunk of an odd length C >= nx / 32 (stride C: no bank
//   conflicts); the maps are joined by a five-step shuffle scan.  The
//   factors of the row sit in shared memory beside the block's rows.
// * Both stage with asynchronous copies (cp.async, 16-byte pieces where
//   rows are 16-byte aligned), so every copy of a tile is in flight at
//   once; with plain loads a thread had one or two in flight.
//
// Chosen by measurement (NVIDIA H100 80GB HBM3, 700 W; one 33 x 721 x 1440
// float32 wind component; CUDA events, medians of 7 trials of 20 calls;
// the alternatives in one run each):
// * latitude: tiles of 32 columns 0.1376 ms, 16 columns 0.1587, 8 columns
//   0.2722; one thread a column sweeping device memory twice 0.4305;
// * longitude: a warp a row, 8 rows a block 0.0993 ms, 4 rows 0.0986,
//   2 rows 0.1040; a padded tile of 32 rows in shared memory with one
//   thread a row 1.4669 (32 threads an SM, each a 1440-step recurrence);
// * with plain loads instead of cp.async: 0.2347 and 0.1564 ms.
// A copy of the same stack (`copy_`, 274 MB each way) took 0.0966 ms: the
// longitude sweep runs at its speed, the latitude sweep at 0.70 of it.  The
// call took 0.2411 ms, 2.95x its bound (0.0818 ms: the stack read once and
// written once), against 3.29 ms for the dense float32 GEMMs.
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLatThreads = 512;
constexpr int kLatTileBytes = 96 * 1024;   // two blocks an SM
constexpr int kLonWarps = 8;
constexpr int kMaxSmem = 232448;           // 227 KB a block on sm_90
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
struct Vec16;   // 16 bytes of T
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// band: (3, n) factors, row 0 the multipliers l, row 1 the pivots'
// reciprocals r, row 2 the super-diagonal c:
//   y[i] = x[i] - l[i] y[i-1];   z[i] = (y[i] - c[i] z[i+1]) r[i]

template <typename T>
__global__ void __launch_bounds__(kLatThreads)
lat_sweep_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const T* __restrict__ band, int ny, int nx, int W,
                 int tiles_x, int vec) {
  using V = typename Vec16<T>::type;
  constexpr int E = 16 / sizeof(T);                  // elements a piece
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = blockDim.x / W;
  T* tile = reinterpret_cast<T*>(smem);              // [ny][W]
  T* map_a = tile + static_cast<int64_t>(ny) * W;    // [K][W]
  T* map_g = map_a + K * W;
  T* carry = map_g + K * W;
  const int w = threadIdx.x % W;
  const int k = threadIdx.x / W;
  const int col0 = (blockIdx.x % tiles_x) * W;
  const int64_t plane = static_cast<int64_t>(blockIdx.x / tiles_x) * ny * nx;
  const int P = W / E;                               // 16-byte pieces a row

  // stage the tile with asynchronous copies, every one in flight at once
  if (vec) {
    for (int q = threadIdx.x; q < ny * P; q += blockDim.x) {
      const int r = q / P, col = col0 + (q % P) * E;
      T* dst = tile + r * W + (q % P) * E;
      if (col < nx)
        __pipeline_memcpy_async(
            dst, in + plane + static_cast<int64_t>(r) * nx + col, 16);
      else
        *reinterpret_cast<V*>(dst) = V{};
    }
  } else {
    for (int r = k; r < ny; r += K) {
      T* dst = tile + r * W + w;
      if (col0 + w < nx)
        __pipeline_memcpy_async(
            dst, in + plane + static_cast<int64_t>(r) * nx + col0 + w,
            sizeof(T));
      else
        *dst = T(0);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const T* l = band;
  const T* rp = band + ny;
  const T* c = band + 2 * ny;
  const int chunk = (ny + K - 1) / K;
  const int r0 = min(k * chunk, ny);
  const int r1 = min(r0 + chunk, ny);
  const int at = k * W + w;

  // forward: the chunk's map y_out = a + g * y_in, then the joins
  T a = T(0), g = T(1);
  for (int i = r0; i < r1; ++i) {
    const T li = __ldg(l + i);
    a = fma_rn(-li, a, tile[i * W + w]);
    g = -li * g;
  }
  map_a[at] = a;
  map_g[at] = g;
  __syncthreads();
  if (k == 0) {
    T y = T(0);
    for (int j = 0; j < K; ++j) {
      carry[j * W + w] = y;
      y = fma_rn(map_g[j * W + w], y, map_a[j * W + w]);
    }
  }
  __syncthreads();
  T y = carry[at];
  for (int i = r0; i < r1; ++i) {
    y = fma_rn(-__ldg(l + i), y, tile[i * W + w]);
    tile[i * W + w] = y;
  }

  // back: the chunk's map z_first = a + g * z_after, then the joins
  a = T(0);
  g = T(1);
  for (int i = r1 - 1; i >= r0; --i) {
    const T ci = __ldg(c + i), ri = __ldg(rp + i);
    a = fma_rn(-ci, a, tile[i * W + w]) * ri;
    g = -ci * ri * g;
  }
  map_a[at] = a;
  map_g[at] = g;
  __syncthreads();
  if (k == 0) {
    T z = T(0);
    for (int j = K - 1; j >= 0; --j) {
      carry[j * W + w] = z;
      z = fma_rn(map_g[j * W + w], z, map_a[j * W + w]);
    }
  }
  __syncthreads();
  T z = carry[at];
  for (int i = r1 - 1; i >= r0; --i) {
    z = fma_rn(-__ldg(c + i), z, tile[i * W + w]) * __ldg(rp + i);
    tile[i * W + w] = z;
  }
  __syncthreads();
  if (vec) {
    for (int q = threadIdx.x; q < ny * P; q += blockDim.x) {
      const int r = q / P, col = col0 + (q % P) * E;
      if (col < nx)
        *reinterpret_cast<V*>(out + plane + static_cast<int64_t>(r) * nx +
                              col) =
            *reinterpret_cast<const V*>(tile + r * W + (q % P) * E);
    }
  } else if (col0 + w < nx) {
    for (int r = k; r < ny; r += K)
      out[plane + static_cast<int64_t>(r) * nx + col0 + w] = tile[r * W + w];
  }
}

// `in` and `out` may be the same stack: each row is read whole into shared
// memory before it is written.
template <typename T>
__global__ void __launch_bounds__(kLonWarps * 32)
lon_sweep_kernel(const T* in, T* out, const T* __restrict__ band, int nx,
                 int64_t lines, int chunk, int vec) {
  using V = typename Vec16<T>::type;
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* fac = reinterpret_cast<T*>(smem);               // [3][nx]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* s = fac + (3 + warp) * nx;                      // this warp's row
  const int64_t line =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  const T* src = in + line * nx;
  T* dst = out + line * nx;
  // the factors and the rows, with asynchronous copies all in flight
  if (vec) {
    for (int q = threadIdx.x; q < 3 * nx / E; q += blockDim.x)
      __pipeline_memcpy_async(fac + q * E, band + q * E, 16);
    if (line < lines)
      for (int q = lane; q < nx / E; q += 32)
        __pipeline_memcpy_async(s + q * E, src + q * E, 16);
  } else {
    for (int i = threadIdx.x; i < 3 * nx; i += blockDim.x)
      __pipeline_memcpy_async(fac + i, band + i, sizeof(T));
    if (line < lines)
      for (int j = lane; j < nx; j += 32)
        __pipeline_memcpy_async(s + j, src + j, sizeof(T));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (line >= lines) return;

  const T* l = fac;
  const T* rp = fac + nx;
  const T* c = fac + 2 * nx;
  const int j0 = min(lane * chunk, nx);
  const int j1 = min(j0 + chunk, nx);

  // forward: the lane's map, an inclusive scan of the maps, then the sweep
  T a = T(0), g = T(1);
  for (int j = j0; j < j1; ++j) {
    a = fma_rn(-l[j], a, s[j]);
    g = -l[j] * g;
  }
  for (int off = 1; off < 32; off <<= 1) {
    const T ap = __shfl_up_sync(kFull, a, off);
    const T gp = __shfl_up_sync(kFull, g, off);
    if (lane >= off) {
      a = fma_rn(g, ap, a);
      g = g * gp;
    }
  }
  T y = __shfl_up_sync(kFull, a, 1);
  if (lane == 0) y = T(0);
  for (int j = j0; j < j1; ++j) {
    y = fma_rn(-l[j], y, s[j]);
    s[j] = y;
  }

  // back: the same from the row's end
  a = T(0);
  g = T(1);
  for (int j = j1 - 1; j >= j0; --j) {
    a = fma_rn(-c[j], a, s[j]) * rp[j];
    g = -c[j] * rp[j] * g;
  }
  for (int off = 1; off < 32; off <<= 1) {
    const T ap = __shfl_down_sync(kFull, a, off);
    const T gp = __shfl_down_sync(kFull, g, off);
    if (lane + off < 32) {
      a = fma_rn(g, ap, a);
      g = g * gp;
    }
  }
  T z = __shfl_down_sync(kFull, a, 1);
  if (lane == 31) z = T(0);
  for (int j = j1 - 1; j >= j0; --j) {
    z = fma_rn(-c[j], z, s[j]) * rp[j];
    s[j] = z;
  }
  __syncwarp();
  if (vec) {
    for (int q = lane; q < nx / E; q += 32)
      reinterpret_cast<V*>(dst)[q] = reinterpret_cast<const V*>(s)[q];
  } else {
    for (int j = lane; j < nx; j += 32) dst[j] = s[j];
  }
}

template <typename T>
int dispatch(const void* in, void* out, const void* band_y,
             const void* band_x, long long batch, int ny, int nx,
             void* stream) {
  if (batch < 1 || ny < 1 || nx < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int size = static_cast<int>(sizeof(T));

  // latitude: W whole columns a block, 128-byte rows where they fit
  int W = 128 / size;
  while (W > 1 && static_cast<int64_t>(ny) * W * size > kLatTileBytes)
    W /= 2;
  const int K = kLatThreads / W;
  const int64_t lat_smem = (static_cast<int64_t>(ny) * W + 3 * K * W) * size;
  const int tiles_x = (nx + W - 1) / W;
  const int64_t lat_blocks = batch * tiles_x;
  // longitude: one row a warp, up to kLonWarps rows a block
  int warps = kLonWarps;
  while (warps > 1 && static_cast<int64_t>(3 + warps) * nx * size > kMaxSmem)
    --warps;
  const int64_t lon_smem = static_cast<int64_t>(3 + warps) * nx * size;
  const int64_t lines = batch * ny;
  const int64_t lon_blocks = (lines + warps - 1) / warps;
  int chunk = (nx + 31) / 32;
  chunk |= 1;   // odd: lanes at stride `chunk` hit distinct banks
  if (lat_smem > kMaxSmem || lon_smem > kMaxSmem ||
      lat_blocks > INT32_MAX || lon_blocks > INT32_MAX)
    return cudaErrorInvalidValue;

  // both sweeps take more than the default 48 KB of shared memory; the
  // limit belongs to the current device, so it is set on every call (a
  // process may launch on several cards)
  const auto smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaFuncSetAttribute(lat_sweep_kernel<T>, smem, kMaxSmem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(lon_sweep_kernel<T>, smem, kMaxSmem);
  if (e != cudaSuccess) return e;

  // 16-byte pieces where every row of what a sweep copies is 16-byte
  // aligned
  auto at16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool rows16 = (static_cast<int64_t>(nx) * size) % 16 == 0 &&
                      at16(out);
  lat_sweep_kernel<T><<<static_cast<unsigned>(lat_blocks), kLatThreads,
                        lat_smem, st>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<const T*>(band_y), ny, nx, W, tiles_x,
      rows16 && at16(in) && (W * size) % 16 == 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lon_sweep_kernel<T><<<static_cast<unsigned>(lon_blocks), warps * 32,
                        lon_smem, st>>>(
      static_cast<const T*>(out), static_cast<T*>(out),
      static_cast<const T*>(band_x), nx, lines, chunk,
      rows16 && at16(band_x));
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes by ops/cuda_prefilter.py.  `in` and
// `out` are (batch, ny, nx) contiguous stacks (not the same memory);
// `band_y` (3, ny) and `band_x` (3, nx) the factors, all on the current
// device.  Launches the latitude sweep and then the longitude sweep on
// `stream`; returns the first CUDA error (0 = both launched;
// cudaErrorInvalidValue for a grid whose lines do not fit in shared memory).
extern "C" int spline_prefilter_f32(const void* in, void* out,
                                    const void* band_y, const void* band_x,
                                    long long batch, int ny, int nx,
                                    void* stream) {
  return dispatch<float>(in, out, band_y, band_x, batch, ny, nx, stream);
}

extern "C" int spline_prefilter_f64(const void* in, void* out,
                                    const void* band_y, const void* band_x,
                                    long long batch, int ny, int nx,
                                    void* stream) {
  return dispatch<double>(in, out, band_y, band_x, batch, ny, nx, stream);
}
