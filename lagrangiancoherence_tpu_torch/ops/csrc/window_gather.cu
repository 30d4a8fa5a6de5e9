// K2 tile_window_gather, K3 sub_window_gather and the pole ladder
// pole_ladder_gather: the windowed gathers of the `blockspec` route of
// lagrangiancoherence_tpu_torch.
//
// Replace the Pallas TPU kernels of lagrangiancoherence_tpu/ops/
// pallas_interp.py:
//   K2 dense mode  <- `_grid_kernel` (:715, tier A), body `_spline_tile_body`
//   K2 list mode   <- `_list_kernel` (:772, the escalation ladder)
//   K3             <- `_sub_grid_kernel` (:648, tier A-sub), `_sub_tile_body`
//   pole ladder    <- `_pole_grid_kernel` (:738, pole level 1) and
//                     `_pole_list_kernel` (:755, pole levels 2 and 3), both
//                     with body `_pole_block_body` (:668): the three
//                     launches of `_pole_eval_block` (:1116-1341) in one
// Those contract one-hot bases on the MXU over a window of field cells that
// routing (ops/tiles.py, ops/pole.py) proved to hold each (8, 128) tile's
// taps.  Here one CTA evaluates one tile (K3: one 32-column quarter of a
// tile) and each thread gathers its parcels' taps directly, with K1's
// arithmetic (gather_math.cuh):
//   * tap offsets are taken relative to the window start exactly as
//     `_tap_offsets` (:268-299) takes them: the unwrapped floor is
//     floor(fold) + n*k with the integer period count k of `_unwrap_k`,
//     and the mirror-edge remaps are applied to the offsets;
//   * a live tile whose taps leave the window sets its flag and ORs its
//     overflow bit; the offsets are clipped into the window (the flag
//     contract of `_onehot_basis`, :375-391);
//   * a window cell maps to the resident (fields, ny, nx) stack by
//     period-n index arithmetic; full-longitude tiers use K1's mirrored
//     column taps, and the pole path reads raw rows directly;
//   * taps accumulate as in K1 (y outer, x inner, weight wy*wx first), so
//     an unflagged tile's values equal K1's bit for bit.
// Outputs are written in place into each tile's home block; a dead slot
// (dense: not routed here; list: at or past the device-side count) writes
// only its flag, 0.
//
// What bounds them: gather latency and bytes, as K1.  Windows of at most
// `stage_bytes` (chosen by the wrapper, ops/cuda_window.py) are first
// staged into shared memory by the whole CTA, so that each tap is a shared
// memory read; wider and full-longitude windows read the stack through L2.
//
// The pole ladder moves under half a megabyte, so a launch's latency bounds
// it, not bytes or operations.  The TPU split it into a dense launch and two
// compacted list launches because a Pallas grid has one window shape; here
// a CTA takes its slot's window from the slot's own keys, so one launch
// serves every level and routing compacts nothing.  One point a thread,
// its packed operand in one 16-byte load, the 4 * NF raw cells loaded
// together through the read-only path (the home rows sit in L2), no
// staging: 40 CTAs of 256 threads at the flagship's 2 x 5 slots.
#include "gather_math.cuh"

namespace {

using namespace lcs;

constexpr int kThreads = 256;
constexpr int kTileR = 8;
constexpr int kTileC = 128;
constexpr int kTile = kTileR * kTileC;
constexpr int kSubW = 32;
constexpr int kLadderThreads = 256;            // pole ladder: points per CTA
constexpr int kLadderParts = kTile / kLadderThreads;   // CTAs per slot
constexpr int kSmemLimit = 131072;   // dynamic shared memory opted into

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// torch.remainder / jnp.mod for floats: fmod, then the divisor's sign
template <typename T>
__device__ __forceinline__ T remainder_f(T a, T b) {
  T m = fmod(a, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = add_rn(m, b);
  return m;
}

// period count k with unwrap(f) = f + n*k, anchored at the tile's first
// fold (pallas_interp.py:240-256); NaN gives 0
template <typename T>
__device__ __forceinline__ int unwrap_k(T f, T anchor, int n) {
  const T nn = static_cast<T>(n);
  const T half = static_cast<T>(0.5 * n);
  const T u = sub_rn(add_rn(anchor, remainder_f(add_rn(sub_rn(f, anchor), half), nn)), half);
  return to_index(rint(div_rn(sub_rn(u, f), nn)));
}

// window-relative tap offsets with the exact mirror remaps, and weights
template <typename T, int ORDER>
__device__ __forceinline__ void window_taps(T f, int n, int k, int base,
                                            int* off, T* w) {
  const T fl = floor(f);
  const int i0 = to_index(fl);
  const int o0 = i0 + n * k - base;
  bspline_weights<T, ORDER>(sub_rn(f, fl), w);
  if constexpr (ORDER == 1) {
    off[0] = o0;
    off[1] = i0 >= n - 1 ? o0 - 1 : o0 + 1;
  } else {
    const bool hi1 = i0 >= n - 1;
    off[0] = f < T(1) ? o0 + 1 : o0 - 1;
    off[1] = o0;
    off[2] = hi1 ? o0 - 1 : o0 + 1;
    off[3] = hi1 ? o0 - 2 : (i0 == n - 2 ? o0 : o0 + 2);
  }
}

// clip offsets into [0, W); true if any was outside
template <int NT>
__device__ __forceinline__ bool clip_taps(int* off, int w) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    bad |= off[j] < 0 || off[j] >= w;
    off[j] = min(max(off[j], 0), w - 1);
  }
  return bad;
}

// cooperative copy of the (NF, wy, wx) window at (y0, x0) into shared memory
template <typename T, int NF>
__device__ __forceinline__ void stage_window(T* win, const T* coeffs, int ny,
                                             int nx, int y0, int x0, int wy,
                                             int wx) {
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int n = NF * wy * wx;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % wx;
    const int rf = e / wx;
    const int r = rf % wy;
    const int f = rf / wy;
    win[e] = coeffs[f * plane + static_cast<int64_t>(pmod(y0 + r, ny)) * nx +
                    pmod(x0 + c, nx)];
  }
  __syncthreads();
}

// One parcel of a windowed spline tier: taps relative to the (wy, wx)
// window at (y0, x0) (XFULL: mirrored columns, no x window).  Returns true
// if a tap left the window.
template <typename T, int ORDER, int NF, bool XFULL>
__device__ __forceinline__ bool window_parcel(
    const T* __restrict__ coeffs, const T* win, T yf, T xf, T ya, T xa,
    int ny, int nx, int y0, int x0, int wy, int wx, T* acc) {
  constexpr int NT = ORDER + 1;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  int oy[NT], ox[NT];
  T wyv[NT], wxv[NT];
  window_taps<T, ORDER>(yf, ny, unwrap_k(yf, ya, ny), y0, oy, wyv);
  bool bad = clip_taps<NT>(oy, wy);
  if constexpr (XFULL) {
    axis_taps<T, ORDER>(xf, nx, ox, wxv);
  } else {
    window_taps<T, ORDER>(xf, nx, unwrap_k(xf, xa, nx), x0, ox, wxv);
    bad |= clip_taps<NT>(ox, wx);
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = T(0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int64_t row = static_cast<int64_t>(pmod(y0 + oy[j], ny)) * nx;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const T w = mul_rn(wyv[j], wxv[k]);
      const int col = XFULL ? ox[k] : pmod(x0 + ox[k], nx);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const T v = win != nullptr ? win[(f * wy + oy[j]) * wx + ox[k]]
                                   : coeffs[f * plane + row + col];
        acc[f] = add_rn(acc[f], mul_rn(w, v));
      }
    }
  }
  return bad;
}

__device__ __forceinline__ void finish_flag(bool bad, int* flags, int slot,
                                            int* overflow, int bit) {
  const int any = __syncthreads_or(bad) != 0;
  if (threadIdx.x == 0) {
    flags[slot] = any;
    if (any && overflow != nullptr) atomicOr(overflow, 1 << bit);
  }
}

// K2: one CTA per tile slot.  Dense mode (sel == nullptr): slot = tile,
// gated by live[tile].  List mode: slot < *count runs tile sel[slot].
template <typename T, int ORDER, int NF, bool XFULL>
__global__ void __launch_bounds__(kThreads)
tile_window_kernel(const T* __restrict__ coeffs, const T* __restrict__ folds,
                   T* __restrict__ out, int* __restrict__ flags,
                   int* __restrict__ overflow, const int* __restrict__ y0map,
                   const int* __restrict__ x0map, const int* __restrict__ live,
                   const int* __restrict__ sel, const int* __restrict__ count,
                   int ny, int nx, int ny_t, int nx_t, int wy, int wx, int bit,
                   int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = blockIdx.x;
  int tile = slot;
  if (sel != nullptr) {
    if (slot >= *count) {
      if (threadIdx.x == 0) flags[slot] = 0;
      return;
    }
    tile = sel[slot];
  } else if (live[tile] == 0) {
    if (threadIdx.x == 0) flags[slot] = 0;
    return;
  }
  const int gx = nx_t / kTileC;
  const int iy = tile / gx;
  const int jx = tile - gx * iy;
  const int y0 = y0map[tile];
  const int x0 = XFULL ? 0 : x0map[tile];
  const int64_t tplane = static_cast<int64_t>(ny_t) * nx_t;
  const int64_t corner = static_cast<int64_t>(iy) * kTileR * nx_t +
                         static_cast<int64_t>(jx) * kTileC;
  T* win = nullptr;
  if (!XFULL && stage) {
    win = reinterpret_cast<T*>(smem);
    stage_window<T, NF>(win, coeffs, ny, nx, y0, x0, wy, wx);
  }
  const T ya = folds[corner];
  const T xa = folds[tplane + corner];
  bool bad = false;
  for (int p = threadIdx.x; p < kTile; p += kThreads) {
    const int64_t at = corner + static_cast<int64_t>(p / kTileC) * nx_t +
                       p % kTileC;
    T acc[NF];
    bad |= window_parcel<T, ORDER, NF, XFULL>(
        coeffs, win, folds[at], folds[tplane + at], ya, xa, ny, nx, y0, x0,
        wy, wx, acc);
#pragma unroll
    for (int f = 0; f < NF; ++f) out[f * tplane + at] = acc[f];
  }
  finish_flag(bad, flags, slot, overflow, bit);
}

// K3: one CTA per (tile, quarter), 8 x 32 threads; each quarter has its own
// (wy, 128) window at x0q[tile*4 + q], anchored at the quarter's first fold.
template <typename T, int ORDER, int NF>
__global__ void __launch_bounds__(kThreads)
sub_window_kernel(const T* __restrict__ coeffs, const T* __restrict__ folds,
                  T* __restrict__ out, int* __restrict__ flags,
                  int* __restrict__ overflow, const int* __restrict__ y0map,
                  const int* __restrict__ x0q, const int* __restrict__ live,
                  int ny, int nx, int ny_t, int nx_t, int wy, int bit,
                  int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = blockIdx.x;
  const int tile = slot / 4;
  const int q = slot % 4;
  if (live[tile] == 0) {
    if (threadIdx.x == 0) flags[slot] = 0;
    return;
  }
  const int gx = nx_t / kTileC;
  const int iy = tile / gx;
  const int jx = tile - gx * iy;
  const int y0 = y0map[tile];
  const int x0 = x0q[slot];
  const int64_t tplane = static_cast<int64_t>(ny_t) * nx_t;
  const int64_t corner = static_cast<int64_t>(iy) * kTileR * nx_t +
                         static_cast<int64_t>(jx) * kTileC;
  const int64_t corner_q = corner + q * kSubW;
  T* win = nullptr;
  if (stage) {
    win = reinterpret_cast<T*>(smem);
    stage_window<T, NF>(win, coeffs, ny, nx, y0, x0, wy, kTileC);
  }
  const int64_t at = corner_q + static_cast<int64_t>(threadIdx.x / kSubW) * nx_t +
                     threadIdx.x % kSubW;
  T acc[NF];
  const bool bad = window_parcel<T, ORDER, NF, false>(
      coeffs, win, folds[at], folds[tplane + at], folds[corner],
      folds[tplane + corner_q], ny, nx, y0, x0, wy, kTileC, acc);
#pragma unroll
  for (int f = 0; f < NF; ++f) out[f * tplane + at] = acc[f];
  finish_flag(bad, flags, slot, overflow, bit);
}

// A kernel that returns at once: what a launch on this path costs when the
// device has nothing to do (ops/cuda_window.py empty_launch).
__global__ void empty_kernel() {}

// The packed pole operand [yc, xc, vmask, mask] of point `at`: one 16-byte
// load in float, two in double.
__device__ __forceinline__ void load_pack(const float* pack, int64_t at,
                                          float* q) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(pack) + at);
  q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
}
__device__ __forceinline__ void load_pack(const double* pack, int64_t at,
                                          double* q) {
  const double2* p = reinterpret_cast<const double2*>(pack) + 2 * at;
  const double2 a = __ldg(p), b = __ldg(p + 1);
  q[0] = a.x; q[1] = a.y; q[2] = b.x; q[3] = b.y;
}

// slot key of a point: the floor of its clipped y index, in [0, ny-2]
// (ops/pole.py pole_keys); it is also the point's upper-left row
template <typename T>
__device__ __forceinline__ int pole_key(T yc, int ny) {
  return min(max(to_index(floor(yc)), 0), ny - 2);
}

// min of `lo` and max of `hi` over the CTA, in every thread
__device__ __forceinline__ void block_min_max(int& lo, int& hi) {
  constexpr int nwarps = kLadderThreads / 32;
  __shared__ int s_lo[nwarps], s_hi[nwarps];
  const int lane = threadIdx.x & 31;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    s_lo[threadIdx.x >> 5] = lo;
    s_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  const int w = lane < nwarps ? lane : 0;
  lo = __reduce_min_sync(0xffffffffu, s_lo[w]);
  hi = __reduce_max_sync(0xffffffffu, s_hi[w]);
}

// The pole ladder in one launch: one thread per point of the sorted (8, 128)-
// point pole slots, four CTAs of 256 points per slot.  `pack` is
// (n_slots * 1024, 4): [yc, xc, vmask, mask] from routing.  Each CTA takes
// the key range of its whole slot (its own points' keys, the keys of the
// slot's other three CTAs, then a block reduction), and from it the level
// that serves the slot and that level's window start, in the integer
// arithmetic of ops/pole.py pole_levels: the first of the windows (wy1,
// wy2, wy3) that holds rows [kymn, kymx + 1], the last if none does.  Then
// each thread evaluates the order-1 mode='constant' bilinear of its point
// on the raw stack against that y window, full longitude.  A masked point
// of a level >= 2 slot whose rows leave the window clamps and raises `bit`.
// The values equal those of a ladder that runs the levels one launch
// after the other: a window that holds a slot's rows does not change them.
template <typename T, int NF>
__global__ void __launch_bounds__(kLadderThreads)
pole_ladder_kernel(const T* __restrict__ raw, const T* __restrict__ pack,
                   T* __restrict__ out, int* __restrict__ overflow,
                   int* __restrict__ levels, int n_slots, int ny, int nx,
                   int ny_p, int wy1, int wy2, int wy3, int bit) {
  const int s = blockIdx.x / kLadderParts;
  const int part = blockIdx.x % kLadderParts;
  const int64_t first = static_cast<int64_t>(s) * kTile;
  const int64_t at = first + part * kLadderThreads + threadIdx.x;
  T q[4];
  load_pack(pack, at, q);
  const T yc = q[0], xc = q[1], vm = q[2], mk = q[3];
  const int yi = pole_key(yc, ny);
  int lo = yi, hi = yi;
#pragma unroll
  for (int o = 1; o < kLadderParts; ++o) {
    const int64_t other =
        first + (part + o) % kLadderParts * kLadderThreads + threadIdx.x;
    const int k = pole_key(__ldg(pack + 4 * other), ny);
    lo = min(lo, k);
    hi = max(hi, k);
  }
  block_min_max(lo, hi);
  const int kymx = min(max(hi + 1, 0), ny - 2);
  const int kymn = min(min(max(lo - 1, 0), ny - 2), kymx);
  const int wys[3] = {wy1, wy2, wy3};
  int level = 2, y0w = 0, wy = wy3;
#pragma unroll
  for (int l = 2; l >= 0; --l) {
    const int y = min(max(kymn / 8 * 8, 0), max(ny_p - wys[l], 0));
    if (l == 2 || (kymn >= y && kymx + 1 <= y + wys[l] - 1)) {
      level = l;
      y0w = y;
      wy = wys[l];
    }
  }
  if (levels != nullptr && part == 0 && threadIdx.x == 0) levels[s] = level;

  const int64_t pp = static_cast<int64_t>(n_slots) * kTile;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  int oy = yi - y0w;
  const bool bad = (oy < 0 || oy > wy - 2) && mk > T(0);
  oy = min(max(oy, 0), wy - 2);
  const int64_t r0 = static_cast<int64_t>(pmod(y0w + oy, ny)) * nx;
  const int64_t r1 = static_cast<int64_t>(pmod(y0w + oy + 1, ny)) * nx;
  const int xi = min(max(to_index(floor(xc)), 0), nx - 2);
  const T ty = sub_rn(yc, static_cast<T>(yi));
  const T tx = sub_rn(xc, static_cast<T>(xi));
  const T one_ty = sub_rn(T(1), ty);
  const T one_tx = sub_rn(T(1), tx);
  const T w00 = mul_rn(one_ty, one_tx);
  const T w01 = mul_rn(one_ty, tx);
  const T w10 = mul_rn(ty, one_tx);
  const T w11 = mul_rn(ty, tx);
  T v[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f) {   // 4 * NF independent loads in flight
    const T* r = raw + f * plane;
    v[f][0] = __ldg(r + r0 + xi);
    v[f][1] = __ldg(r + r0 + xi + 1);
    v[f][2] = __ldg(r + r1 + xi);
    v[f][3] = __ldg(r + r1 + xi + 1);
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    out[f * pp + at] =
        vm > T(0) ? add_rn(add_rn(add_rn(mul_rn(v[f][0], w00),
                                         mul_rn(v[f][1], w01)),
                                  mul_rn(v[f][2], w10)),
                           mul_rn(v[f][3], w11))
                  : T(0);
  const int any = __syncthreads_or(bad && level > 0);
  if (any && threadIdx.x == 0) atomicOr(overflow, 1 << bit);
}

template <typename T, int ORDER, int NF, bool XFULL>
cudaError_t launch_tile(const T* coeffs, const T* folds, T* out, int* flags,
                        int* overflow, const int* y0map, const int* x0map,
                        const int* live, const int* sel, const int* count,
                        int n_slots, int ny, int nx, int ny_t, int nx_t,
                        int wy, int wx, int bit, int stage_bytes,
                        cudaStream_t s) {
  auto kernel = tile_window_kernel<T, ORDER, NF, XFULL>;
  // once per instantiation: opt in to more than 48 KB of dynamic smem
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  kernel<<<n_slots, kThreads, stage_bytes, s>>>(
      coeffs, folds, out, flags, overflow, y0map, x0map, live, sel, count, ny,
      nx, ny_t, nx_t, wy, wx, bit, stage_bytes > 0);
  return cudaGetLastError();
}

template <typename T>
int dispatch_tile(const void* coeffs, const void* folds, void* out,
                  void* flags, void* overflow, const void* y0map,
                  const void* x0map, const void* live, const void* sel,
                  const void* count, int n_slots, int ny, int nx, int ny_t,
                  int nx_t, int order, int nf, long long f0, int wy, int wx,
                  int bit, int stage_bytes, void* stream) {
  if (stage_bytes < 0 || stage_bytes > kSmemLimit || n_slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* c = static_cast<const T*>(coeffs) + static_cast<int64_t>(f0) * ny * nx;
  const bool xfull = x0map == nullptr;
#define TILE_CASE(O, F, X)                                                     \
  if (order == O && nf == F && xfull == X)                                     \
    return static_cast<int>(launch_tile<T, O, F, X>(                          \
        c, static_cast<const T*>(folds), static_cast<T*>(out),                \
        static_cast<int*>(flags), static_cast<int*>(overflow),                \
        static_cast<const int*>(y0map), static_cast<const int*>(x0map),       \
        static_cast<const int*>(live), static_cast<const int*>(sel),          \
        static_cast<const int*>(count), n_slots, ny, nx, ny_t, nx_t, wy, wx,  \
        bit, X ? 0 : stage_bytes, static_cast<cudaStream_t>(stream)));
  TILE_CASE(3, 4, false) TILE_CASE(3, 4, true)
  TILE_CASE(3, 2, false) TILE_CASE(3, 2, true)
  TILE_CASE(1, 4, false) TILE_CASE(1, 4, true)
  TILE_CASE(1, 2, false) TILE_CASE(1, 2, true)
#undef TILE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int ORDER, int NF>
cudaError_t launch_sub(const T* coeffs, const T* folds, T* out, int* flags,
                       int* overflow, const int* y0map, const int* x0q,
                       const int* live, int n_tiles, int ny, int nx, int ny_t,
                       int nx_t, int wy, int bit, int stage_bytes,
                       cudaStream_t s) {
  auto kernel = sub_window_kernel<T, ORDER, NF>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  kernel<<<4 * n_tiles, kThreads, stage_bytes, s>>>(
      coeffs, folds, out, flags, overflow, y0map, x0q, live, ny, nx, ny_t,
      nx_t, wy, bit, stage_bytes > 0);
  return cudaGetLastError();
}

template <typename T>
int dispatch_sub(const void* coeffs, const void* folds, void* out, void* flags,
                 void* overflow, const void* y0map, const void* x0q,
                 const void* live, int n_tiles, int ny, int nx, int ny_t,
                 int nx_t, int order, int nf, long long f0, int wy, int bit,
                 int stage_bytes, void* stream) {
  if (stage_bytes < 0 || stage_bytes > kSmemLimit || n_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* c = static_cast<const T*>(coeffs) + static_cast<int64_t>(f0) * ny * nx;
#define SUB_CASE(O, F)                                                         \
  if (order == O && nf == F)                                                   \
    return static_cast<int>(launch_sub<T, O, F>(                              \
        c, static_cast<const T*>(folds), static_cast<T*>(out),                \
        static_cast<int*>(flags), static_cast<int*>(overflow),                \
        static_cast<const int*>(y0map), static_cast<const int*>(x0q),         \
        static_cast<const int*>(live), n_tiles, ny, nx, ny_t, nx_t, wy, bit,  \
        stage_bytes, static_cast<cudaStream_t>(stream)));
  SUB_CASE(3, 4) SUB_CASE(3, 2) SUB_CASE(1, 4) SUB_CASE(1, 2)
#undef SUB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_ladder(const void* raw, const void* pack, void* out,
                    void* overflow, void* levels, int n_slots, int ny, int nx,
                    int nf, long long f0, int ny_p, int wy1, int wy2, int wy3,
                    int bit, void* stream) {
  if (n_slots <= 0 || overflow == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* r = static_cast<const T*>(raw) + static_cast<int64_t>(f0) * ny * nx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LADDER_CASE(F)                                                         \
  if (nf == F) {                                                               \
    pole_ladder_kernel<T, F>                                                  \
        <<<n_slots * kLadderParts, kLadderThreads, 0, s>>>(                   \
        r, static_cast<const T*>(pack), static_cast<T*>(out),                 \
        static_cast<int*>(overflow), static_cast<int*>(levels), n_slots, ny,  \
        nx, ny_p, wy1, wy2, wy3, bit);                                        \
    return static_cast<int>(cudaGetLastError());                              \
  }
  LADDER_CASE(4) LADDER_CASE(2)
#undef LADDER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry points, bound with ctypes by ops/cuda_window.py.  `coeffs`/`raw`
// point at the whole (fields, ny, nx) stacks; fields [f0, f0 + nf) are
// evaluated.  Optional pointers are NULL: x0map (full-longitude tier),
// live (list mode), sel/count (dense mode), overflow (no bit to set; the
// pole ladder needs it), levels (the pole ladder's per-slot level output).
// Each returns cudaGetLastError() after the launch (0 = launched).
#define LCS_TILE_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* coeffs, const void* folds, void* out,        \
                      void* flags, void* overflow, const void* y0map,          \
                      const void* x0map, const void* live, const void* sel,    \
                      const void* count, int n_slots, int ny, int nx,          \
                      int ny_t, int nx_t, int order, int nf, long long f0,     \
                      int wy, int wx, int bit, int stage_bytes,                \
                      void* stream) {                                          \
    return dispatch_tile<T>(coeffs, folds, out, flags, overflow, y0map, x0map, \
                            live, sel, count, n_slots, ny, nx, ny_t, nx_t,     \
                            order, nf, f0, wy, wx, bit, stage_bytes, stream);  \
  }
LCS_TILE_ENTRY(tile_window_gather_f32, float)
LCS_TILE_ENTRY(tile_window_gather_f64, double)
#undef LCS_TILE_ENTRY

#define LCS_SUB_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* coeffs, const void* folds, void* out,        \
                      void* flags, void* overflow, const void* y0map,          \
                      const void* x0q, const void* live, int n_tiles, int ny,  \
                      int nx, int ny_t, int nx_t, int order, int nf,           \
                      long long f0, int wy, int bit, int stage_bytes,          \
                      void* stream) {                                          \
    return dispatch_sub<T>(coeffs, folds, out, flags, overflow, y0map, x0q,    \
                           live, n_tiles, ny, nx, ny_t, nx_t, order, nf, f0,   \
                           wy, bit, stage_bytes, stream);                      \
  }
LCS_SUB_ENTRY(sub_window_gather_f32, float)
LCS_SUB_ENTRY(sub_window_gather_f64, double)
#undef LCS_SUB_ENTRY

#define LCS_LADDER_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* raw, const void* pack, void* out,            \
                      void* overflow, void* levels, int n_slots, int ny,       \
                      int nx, int nf, long long f0, int ny_p, int wy1,         \
                      int wy2, int wy3, int bit, void* stream) {               \
    return dispatch_ladder<T>(raw, pack, out, overflow, levels, n_slots, ny,   \
                              nx, nf, f0, ny_p, wy1, wy2, wy3, bit, stream);   \
  }
LCS_LADDER_ENTRY(pole_ladder_gather_f32, float)
LCS_LADDER_ENTRY(pole_ladder_gather_f64, double)
#undef LCS_LADDER_ENTRY

// The empty launch, with pole_ladder_gather's arguments (all ignored but the
// stream), so that both cross the binding at the same cost.
#define LCS_EMPTY_ENTRY(NAME)                                                  \
  extern "C" int NAME(const void*, const void*, void*, void*, void*, int, int, \
                      int, int, long long, int, int, int, int, int,            \
                      void* stream) {                                          \
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();           \
    return static_cast<int>(cudaGetLastError());                               \
  }
LCS_EMPTY_ENTRY(empty_launch_f32)
LCS_EMPTY_ENTRY(empty_launch_f64)
#undef LCS_EMPTY_ENTRY
