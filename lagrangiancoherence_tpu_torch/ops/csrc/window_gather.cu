// tier_window_gather (the spline window tiers) and pole_ladder_gather (the
// pole ladder): the windowed gathers of the `blockspec` route of
// lagrangiancoherence_tpu_torch.
//
// Replace the Pallas TPU kernels of lagrangiancoherence_tpu/ops/
// pallas_interp.py:
//   tier_window_gather <- `_grid_kernel` (:715, tier A, body
//                         `_spline_tile_body`), `_list_kernel` (:772, the
//                         escalation ladder) and `_sub_grid_kernel` (:648,
//                         tier A-sub, body `_sub_tile_body`), and the XLA
//                         ops that routed tiles to them (:1833-2036)
//   pole ladder        <- `_pole_grid_kernel` (:738, pole level 1) and
//                         `_pole_list_kernel` (:755, pole levels 2 and 3),
//                         both with body `_pole_block_body` (:668): the
//                         three launches of `_pole_eval_block` (:1116-1341)
// Those contract one-hot bases on the MXU over a window of field cells that
// routing proved to hold each (8, 128) tile's taps, one launch a window
// shape, because a Pallas grid has one.  Here a CTA takes its tile's or
// slot's window from the tile's own parcels, so one gather launch serves
// every tier, and each thread gathers its parcels' taps directly, with K1's
// arithmetic (gather_math.cuh):
//   * tap offsets are taken relative to the window start exactly as
//     `_tap_offsets` (:268-299) takes them: the unwrapped floor is
//     floor(fold) + n*k with the integer period count k of `_unwrap_k`,
//     and the mirror-edge remaps are applied to the offsets;
//   * a tile whose taps leave the window sets its flag and ORs its
//     overflow bit; the offsets are clipped into the window (the flag
//     contract of `_onehot_basis`, :375-391);
//   * a window cell maps to the resident (fields, ny, nx) stack by
//     period-n index arithmetic; full-longitude tiers use K1's mirrored
//     column taps, and the pole path reads raw rows directly;
//   * taps accumulate as in K1 (y outer, x inner, weight wy*wx first), so
//     an unflagged tile's values equal K1's bit for bit.
// Outputs are written in place into each tile's home block.  Nothing is
// staged in shared memory: the windows sit in L2, and staging them cost a
// CTA more than its taps did.
//
// The pole ladder moves under half a megabyte, so a launch's latency bounds
// it, not bytes or operations.  One point a thread, its packed operand in
// one 16-byte load, the 4 * NF raw cells loaded together through the
// read-only path (the home rows sit in L2): 40 CTAs of 256 threads at the
// flagship's 2 x 5 slots.
#include <limits.h>

#include "gather_math.cuh"

namespace {

using namespace lcs;

constexpr int kTileR = 8;
constexpr int kTileC = 128;
constexpr int kTile = kTileR * kTileC;
constexpr int kSubW = 32;
constexpr int kLadderThreads = 256;            // pole ladder: points per CTA
constexpr int kLadderParts = kTile / kLadderThreads;   // CTAs per slot

// a mod n in [0, n); windows lie within a period of the field, so the
// division is the rare path
__device__ __forceinline__ int pmod(int a, int n) {
  if (a < 0) a += n;
  if (a >= n) a -= n;
  if (static_cast<unsigned>(a) < static_cast<unsigned>(n)) return a;
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// torch.remainder / jnp.mod for floats with b > 0: fmod, then the
// divisor's sign.  For |a| < 2b fmod is a itself or a - b, which is exact,
// so the library call is the rare path (NaN takes it).
template <typename T>
__device__ __forceinline__ T remainder_f(T a, T b) {
  T m;
  if (a > -b && a < b) {
    m = a;
  } else if (a >= b && a < add_rn(b, b)) {
    m = sub_rn(a, b);
  } else {
    m = fmod(a, b);
  }
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

// One parcel of a windowed spline tier: taps relative to the (wy, wx)
// window at (y0, x0) (XFULL: mirrored columns, no x window).  Returns true
// if a tap left the window.
template <typename T, int ORDER, int NF, bool XFULL>
__device__ __forceinline__ bool window_parcel(
    const T* __restrict__ coeffs, T yf, T xf, T ya, T xa, int ny, int nx,
    int y0, int x0, int wy, int wx, T* acc) {
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
      for (int f = 0; f < NF; ++f)
        acc[f] = add_rn(acc[f],
                        mul_rn(w, __ldg(coeffs + f * plane + row + col)));
    }
  }
  return bad;
}

// ---------------------------------------------------------------------------
// The spline tiers in one routed gather: tier_window_gather
// ---------------------------------------------------------------------------
//
// Two launches a gather group replace tier A, tier A-sub and the ladder's
// list launches, and with them the torch ops that routed tiles to them.
//
// tier_route_kernel, one CTA a home tile, every tile, eight parcels a
// thread: block reductions give the tile's window facts (the min/max of its
// parcels' unwrapped floors anchored at the tile's first fold, the same per
// 32-column quarter anchored at the quarter's first fold, the min/max of
// the plain fold floors), and the lanes of one warp evaluate from them, one
// window a lane, in the integer arithmetic of ops/tiles.py route_tiles,
// whether the tile fits tier A-sub's four quarter windows, tier A's window,
// and each ladder tier's.  The ladder's capacities need tiles in index
// order, so the last CTA to arrive (a __threadfence and an atomic ticket)
// runs the three-pass first fit over all tiles: in each pass a tile not
// yet taken tries the first ladder tier that fits it and that it has not
// tried, and is taken if its rank among the tiles trying that tier (in
// index order, after the tier's count so far) is under the tier's
// capacity; the tiles' state sits in shared memory (4 bytes a tile, at
// most kMaxTiles tiles) and a warp walks the tiles that try its tier with
// ballots.  It leaves each tile's choice and window in `plan` (kPlanW ints
// a tile: tier, y0, x0 of quarters 0..3, wy, wx or 0 for full longitude)
// and ORs bit 1 if a tile fits nothing.
//
// tier_gather_kernel, one CTA a home tile: each thread gathers its four
// parcels against the tile's window (tier A-sub: its quarter's) with
// window_parcel; a full-longitude tier is a branch the whole CTA takes.  A
// tile whose taps leave its window sets its flag (tier A-sub: bit q for
// quarter q) and ORs bit 2 (tier A, A-sub) or 5 + t (ladder tier t) into
// the overflow word.
//
// What bounds them: the folds are read by both (17.9 MB at the flagship, the
// second time from L2) and the gather is K1's: latency of 16 * NF dependent-
// free loads a parcel from an L2-resident window.  Every CTA is live (1,092
// at the flagship), nothing is staged, and no torch op routes.

constexpr int kMaxSpecs = 16;        // ladder tiers
constexpr int kRouteThreads = 128;   // eight parcels a thread, in one column
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kGatherThreads = 256;  // four parcels a thread, in one column
constexpr int kPlanW = 8;            // ints a tile in `plan`
constexpr int kMaxTiles = 12288;     // the plan's state fits 48 KB of smem
constexpr int kFitA = 16, kFitS = 17;   // bits of a tile's `fits` word
static_assert(kRouteWarps == kTileC / kSubW, "a warp holds one quarter");
static_assert(kGatherThreads % kTileC == 0, "a thread keeps its column");

struct TierGeom {
  int ny, nx, ny_t, nx_t;
  int ypad, xpad;       // JAX's padded coefficient geometry
  int wy, wx;           // tier A's window
  int m;                // tap reach below the floor: 2 at order 3, else 1
  int sub;              // tier A-sub and bit 1 are on
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// start (unpadded) of the `gran`-granular window of width w that routing
// gives floors from `lo_slop` = min - slop, clamped to the padded geometry
__device__ __forceinline__ int window_start(int lo_slop, int pad, int gran,
                                            int limit, int w) {
  const int s = max(floor_div(lo_slop + pad, gran) * gran, 0);
  return min(s, floor_div(limit - w, gran) * gran) - pad;
}

// whether floors [mn, mx] with their tap reach fit [start, start + w)
__device__ __forceinline__ bool window_holds(int mn, int mx, int m, int ulp,
                                             int start, int w) {
  return mn - m - ulp >= start && mx + 2 + ulp <= start + w - 1;
}

// `lad`: n_specs ladder tiers of (wy, wx or 0 for full longitude, capacity),
// on the device
template <typename T>
__global__ void __launch_bounds__(kRouteThreads, 12)
tier_route_kernel(const T* __restrict__ folds, const int* __restrict__ lad,
                  int n_specs, int* __restrict__ plan, int* __restrict__ fits,
                  int* __restrict__ scratch, int* __restrict__ overflow,
                  unsigned* __restrict__ ticket, const TierGeom g) {
  constexpr int nq = 10;   // y, x, plain y, plain x, quarter x: min and max
  __shared__ int s_red[nq][kRouteWarps];
  __shared__ int s_last;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int gx = g.nx_t / kTileC;
  const int iy = tile / gx;
  const int jx = tile - gx * iy;
  const int64_t tplane = static_cast<int64_t>(g.ny_t) * g.nx_t;
  const int64_t corner = static_cast<int64_t>(iy) * kTileR * g.nx_t +
                         static_cast<int64_t>(jx) * kTileC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;   // the quarter of this thread's column
  const T ya = folds[corner];
  const T xa = folds[tplane + corner];
  const T xqa = folds[tplane + corner + warp * kSubW];
  int v[nq];
#pragma unroll
  for (int i = 0; i < nq; i += 2) {
    v[i] = INT_MAX;
    v[i + 1] = INT_MIN;
  }
#pragma unroll 4
  for (int r = 0; r < kTileR; ++r) {
    const int64_t at = corner + static_cast<int64_t>(r) * g.nx_t + threadIdx.x;
    const T yf = folds[at];
    const T xf = folds[tplane + at];
    const int fy = to_index(floor(yf));
    const int fx = to_index(floor(xf));
    const int w[nq / 2] = {fy + g.ny * unwrap_k(yf, ya, g.ny),
                           fx + g.nx * unwrap_k(xf, xa, g.nx), fy, fx,
                           fx + g.nx * unwrap_k(xf, xqa, g.nx)};
#pragma unroll
    for (int i = 0; i < nq / 2; ++i) {
      v[2 * i] = min(v[2 * i], w[i]);
      v[2 * i + 1] = max(v[2 * i + 1], w[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < nq; i += 2) {
    const int lo = __reduce_min_sync(0xffffffffu, v[i]);
    const int hi = __reduce_max_sync(0xffffffffu, v[i + 1]);
    if (lane == 0) {
      s_red[i][warp] = lo;
      s_red[i + 1][warp] = hi;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // every lane takes the tile's facts, then one window each: lane t the
    // ladder's tier t, lane kFitA tier A's, lanes kFitS + q quarter q's
    int r[8];             // ymn ymx xmn xmx, plain ymn ymx xmn xmx
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      r[i] = INT_MAX;
      r[i + 1] = INT_MIN;
#pragma unroll
      for (int w = 0; w < kRouteWarps; ++w) {
        r[i] = min(r[i], s_red[i][w]);
        r[i + 1] = max(r[i + 1], s_red[i + 1][w]);
      }
    }
    const int ymn = r[0], ymx = r[1];
    // tiles within a cell of the mirror-remap zones take one more cell
    const bool edge = r[4] <= 1 || r[5] >= g.ny - 3 || r[6] <= 1 ||
                      r[7] >= g.nx - 3;
    const int ulp = edge ? 2 : 1;
    const int slop = g.m + ulp;
    const int q = lane - kFitS;
    const bool quarter = q >= 0 && q < kRouteWarps;
    const bool spec = lane < n_specs;
    const int xmn = quarter ? s_red[8][q] : r[2];
    const int xmx = quarter ? s_red[9][q] : r[3];
    const int wy = spec ? __ldg(lad + 3 * lane) : g.wy;
    const int wx = spec ? __ldg(lad + 3 * lane + 1) : quarter ? kTileC : g.wx;
    const int wxe = wx == 0 ? g.wx : wx;
    const int y0 = window_start(ymn - slop, g.ypad, 8, g.ny + 2 * g.ypad, wy);
    const int x0 = window_start(xmn - slop, g.xpad, kSubW,
                                g.nx + 2 * g.xpad - kTileC, wxe);
    const bool ok = (spec || lane == kFitA || quarter) &&
                    window_holds(ymn, ymx, g.m, ulp, y0, wy) &&
                    (wx == 0 || window_holds(xmn, xmx, g.m, ulp, x0, wxe));
    const unsigned b = __ballot_sync(0xffffffffu, ok);
    const unsigned quarters = (1u << kRouteWarps) - 1u;
    const bool fit_a = (b >> kFitA) & 1u;
    const bool fit_s = g.sub && ((b >> kFitS) & quarters) == quarters;
    const int y0a = __shfl_sync(0xffffffffu, y0, kFitA);
    const int x0a = __shfl_sync(0xffffffffu, x0, kFitA);
    int* row = plan + static_cast<int64_t>(tile) * kPlanW;
    if (lane == 0) {
      row[0] = fit_s ? -2 : -1;
      row[1] = y0a;
      row[6] = g.wy;
      row[7] = fit_s ? kTileC : g.wx;
      fits[tile] = static_cast<int>(b & ((1u << n_specs) - 1u)) |
                   (fit_a ? 1 << kFitA : 0) | (fit_s ? 1 << kFitS : 0);
      scratch[2 * tile] = r[0] - slop;
      scratch[2 * tile + 1] = r[2] - slop;
    }
    if (quarter) row[2 + q] = fit_s ? x0 : (q ? 0 : x0a);
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      __threadfence();
      s_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(n_tiles - 1);
    }
  }
  __syncthreads();
  if (!s_last) return;

  // the last CTA: every tile's facts are written; plan the ladder.  The
  // tiles' state lives in shared memory, so a pass reads no global memory:
  // s_elig[i], the ladder tiers tile i has yet to try (0 once it is taken
  // or if a base tier holds it); s_try[i], the tier it tries in this pass;
  // s_tier[i], the tier that took it (kNone: none, kBase: a base tier)
  __threadfence();
  constexpr int kNone = 0xff, kBase = 0xfe;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* s_elig = reinterpret_cast<unsigned short*>(smem);
  unsigned char* s_tier = smem + 2 * static_cast<size_t>(n_tiles);
  unsigned char* s_try = s_tier + n_tiles;
  __shared__ int s_cnt[kMaxSpecs];   // tiles each tier has taken so far
  __shared__ int s_uncovered;
  __shared__ int s_away[3];          // a tier turned a tile away in pass p
  if (threadIdx.x < kMaxSpecs) s_cnt[threadIdx.x] = 0;
  if (threadIdx.x < 3) s_away[threadIdx.x] = 0;
  if (threadIdx.x == 0) s_uncovered = 0;
  const unsigned base_bits = (1u << kFitA) | (1u << kFitS);
  const unsigned spec_bits = (1u << kMaxSpecs) - 1u;
  for (int i = threadIdx.x; i < n_tiles; i += kRouteThreads) {
    const unsigned w = static_cast<unsigned>(__ldcg(fits + i));
    const bool base = (w & base_bits) != 0;
    s_elig[i] = base ? 0 : static_cast<unsigned short>(w & spec_bits);
    s_tier[i] = base ? kBase : kNone;
  }
  __syncthreads();
  for (int pass = 0; pass < min(3, n_specs); ++pass) {
    // the tier each tile tries in this pass: the first it has not tried
    for (int i = threadIdx.x; i < n_tiles; i += kRouteThreads) {
      const unsigned e = s_elig[i];
      s_try[i] = e ? __ffs(e) - 1 : kNone;
      s_elig[i] = static_cast<unsigned short>(e & (e - 1u));
    }
    __syncthreads();
    // one warp a tier walks the tiles in index order, 4 x 32 at a time
    for (int t = warp; t < n_specs; t += kRouteWarps) {
      const int cap = __ldg(lad + 3 * t + 2);
      const int cnt = s_cnt[t];
      int seen = 0;       // tiles so far that try tier t in this pass
      for (int i0 = 0; i0 < n_tiles; i0 += 4 * 32) {
        bool tries[4];
        unsigned b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 32 * u + lane;
          tries[u] = i < n_tiles && s_try[i] == t;
          b[u] = __ballot_sync(0xffffffffu, tries[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 32 * u + lane;
          const int rank = cnt + seen + __popc(b[u] & ((1u << lane) - 1u));
          if (tries[u] && rank < cap) {
            s_tier[i] = t;
            s_elig[i] = 0;
          }
          seen += __popc(b[u]);
        }
      }
      __syncwarp();
      if (lane == 0) {
        const int room = max(cap - cnt, 0);
        s_cnt[t] = cnt + min(seen, room);
        if (seen > room) s_away[pass] = 1;
      }
    }
    __syncthreads();
    if (!s_away[pass]) break;   // every tile that tried was taken
  }
  // each taken tile's window; a tile that fits nothing raises bit 1
  const int ylim = g.ny + 2 * g.ypad;
  const int xlim = g.nx + 2 * g.xpad - kTileC;
  bool uncovered = false;
  for (int i = threadIdx.x; i < n_tiles; i += kRouteThreads) {
    const int t = s_tier[i];
    if (t < kMaxSpecs) {
      const int wy = __ldg(lad + 3 * t), wx = __ldg(lad + 3 * t + 1);
      int* row = plan + static_cast<int64_t>(i) * kPlanW;
      row[0] = t;
      row[1] = window_start(__ldcg(scratch + 2 * i), g.ypad, 8, ylim, wy);
      row[2] = wx == 0 ? 0
                       : window_start(__ldcg(scratch + 2 * i + 1), g.xpad,
                                      kSubW, xlim, wx);
      row[6] = wy;
      row[7] = wx;
    } else if (t == kNone) {
      uncovered = true;
    }
  }
  if (g.sub && uncovered) s_uncovered = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_uncovered) atomicOr(overflow, 1 << 1);
    *ticket = 0u;         // ready for the next launch
  }
}

template <typename T, int ORDER, int NF>
__global__ void __launch_bounds__(kGatherThreads, 4)
tier_gather_kernel(const T* __restrict__ coeffs, const T* __restrict__ folds,
                   T* __restrict__ out, const int* __restrict__ plan,
                   int* __restrict__ flags, int* __restrict__ overflow,
                   int ny, int nx, int ny_t, int nx_t) {
  __shared__ int s_flag;
  const int tile = blockIdx.x;
  const int* row = plan + static_cast<int64_t>(tile) * kPlanW;
  const int tier = row[0];
  const int y0 = row[1];
  const int wy = row[6], wx = row[7];
  const bool sub = tier == -2;
  const int q = (threadIdx.x % kTileC) / kSubW;
  const int x0 = row[2 + (sub ? q : 0)];
  const int gx = nx_t / kTileC;
  const int iy = tile / gx;
  const int jx = tile - gx * iy;
  const int64_t tplane = static_cast<int64_t>(ny_t) * nx_t;
  const int64_t corner = static_cast<int64_t>(iy) * kTileR * nx_t +
                         static_cast<int64_t>(jx) * kTileC;
  const T ya = folds[corner];
  const T xa = folds[tplane + corner + (sub ? q * kSubW : 0)];
  if (threadIdx.x == 0) s_flag = 0;
  __syncthreads();
  bool bad = false;
  for (int p = threadIdx.x; p < kTile; p += kGatherThreads) {
    const int64_t at = corner + static_cast<int64_t>(p / kTileC) * nx_t +
                       p % kTileC;
    const T yf = folds[at];
    const T xf = folds[tplane + at];
    T acc[NF];
    if (wx == 0) {
      bad |= window_parcel<T, ORDER, NF, true>(coeffs, yf, xf, ya, xa, ny, nx,
                                               y0, 0, wy, 0, acc);
    } else {
      bad |= window_parcel<T, ORDER, NF, false>(coeffs, yf, xf, ya, xa, ny,
                                                nx, y0, x0, wy, wx, acc);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) out[f * tplane + at] = acc[f];
  }
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0)
    atomicOr(&s_flag, sub ? 1 << q : 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    flags[tile] = s_flag;
    if (s_flag) atomicOr(overflow, 1 << (tier >= 0 ? 5 + tier : 2));
  }
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

template <typename T, int ORDER, int NF>
cudaError_t launch_tier(const T* coeffs, const T* folds, T* out, int* plan,
                        int* fits, int* flags, int* scratch, int* overflow,
                        unsigned* ticket, int n_tiles, const TierGeom& g,
                        const int* lad, int n_specs, cudaStream_t s) {
  tier_route_kernel<T><<<n_tiles, kRouteThreads, 4 * n_tiles, s>>>(
      folds, lad, n_specs, plan, fits, scratch, overflow, ticket, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tier_gather_kernel<T, ORDER, NF><<<n_tiles, kGatherThreads, 0, s>>>(
      coeffs, folds, out, plan, flags, overflow, g.ny, g.nx, g.ny_t, g.nx_t);
  return cudaGetLastError();
}

template <typename T>
int dispatch_tier(const void* coeffs, const void* folds, void* out,
                  void* plan, void* fits, void* flags, void* scratch,
                  void* overflow, void* ticket, int ny, int nx, int ny_t,
                  int nx_t, int order, int nf, long long f0, int wy, int wx,
                  int ypad, int xpad, int sub, int n_specs, const int* specs,
                  void* stream) {
  if (n_specs < 0 || n_specs > kMaxSpecs || ny_t % kTileR || nx_t % kTileC ||
      ny_t <= 0 || nx_t <= 0 || (n_specs > 0 && specs == nullptr) ||
      ny_t / kTileR * (nx_t / kTileC) > kMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  TierGeom g{ny, nx, ny_t, nx_t, ypad, xpad, wy, wx, order == 3 ? 2 : 1,
             sub != 0};
  const int n_tiles = ny_t / kTileR * (nx_t / kTileC);
  const T* c = static_cast<const T*>(coeffs) + static_cast<int64_t>(f0) * ny * nx;
#define TIER_CASE(O, F)                                                        \
  if (order == O && nf == F)                                                   \
    return static_cast<int>(launch_tier<T, O, F>(                             \
        c, static_cast<const T*>(folds), static_cast<T*>(out),                \
        static_cast<int*>(plan), static_cast<int*>(fits),                     \
        static_cast<int*>(flags), static_cast<int*>(scratch),                 \
        static_cast<int*>(overflow), static_cast<unsigned*>(ticket), n_tiles, \
        g, specs, n_specs, static_cast<cudaStream_t>(stream)));
  TIER_CASE(3, 4) TIER_CASE(3, 2) TIER_CASE(1, 4) TIER_CASE(1, 2)
#undef TIER_CASE
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
// tier_window_gather: both launches of a gather group's spline tiers.
// `specs` is a device array of n_specs (wy, wx or 0, capacity) ladder
// tiers; `ticket` a device word that is 0 between launches.
#define LCS_TIER_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* coeffs, const void* folds, void* out,        \
                      void* plan, void* fits, void* flags, void* scratch,      \
                      void* overflow, void* ticket, int ny, int nx, int ny_t,  \
                      int nx_t, int order, int nf, long long f0, int wy,       \
                      int wx, int ypad, int xpad, int sub, int n_specs,        \
                      const int* specs, void* stream) {                        \
    return dispatch_tier<T>(coeffs, folds, out, plan, fits, flags, scratch,    \
                            overflow, ticket, ny, nx, ny_t, nx_t, order, nf,   \
                            f0, wy, wx, ypad, xpad, sub, n_specs, specs,       \
                            stream);                                           \
  }
LCS_TIER_ENTRY(tier_window_gather_f32, float)
LCS_TIER_ENTRY(tier_window_gather_f64, double)
#undef LCS_TIER_ENTRY

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
