// Per-pixel pass of the flat retarded-time renderer: one warp per tile (a
// strip of whole pixel rows of an occupied view cell), a group of lanes per
// run of kRun pixels along x; one thread per run of the empty cells.
//
// Replaces the TPU kernel spacetime_tpu/ops/render_pallas.py `_pixel_kernel`
// with its `_shade_group` (host function `pixel_pass_pallas`).  For each pixel:
//   * the pixel's world position, cone radius r and emission time
//     t_e = t_now - r (t_now when not retarded);
//   * a running min over the cell's splat entries (ops/raytrace.py CSR:
//     entries[cell_lo[c]:cell_hi[c]], nearest-first): the nearest in-time
//     swept-capsule hit with |tau - 0.5| <= 0.501 and dist2 < nextafter(rho^2),
//     the FIRST minimum in entry order winning a tie;
//   * Doppler (source x camera), hat-band or exact Planck shading, D^3
//     beaming, ambient mix;
//   * composition with the occlusion retina: blocked when
//     s_first < r - 2 rho, which selects absorbed_dim or the shadow.
// The planar (3, H, W) image is written directly; pixels of the partial
// last cell row/column (1080 = 67.5 x 16) are skipped.
//
// A launch shades the cell rows [row0, row0 + rows) into planes of out_h
// pixel rows whose first row is pixel row row0 * k: the whole image (row0
// 0, rows hc_img, out_h H), or one rank's band of cell rows on a mesh (the
// TPU kernel's cell-row split across chips, `row_off` in its scal9,
// render_pallas.py:375-414).  Each pixel's maths is the same either way.
//
// CAMERA_FRAME (the boosted view, the TPU kernel's `camera_frame` branch,
// render_pallas.py:110-118): the pixel is a point of the camera's rest
// frame, so it is first mapped back to its ground query point by the
// closed-form inverse warp `unwarp_xy` (ops/boost.py, same f32 operation
// order, the v < 1e-9 still-camera select after the arithmetic, no
// fast-math intrinsics); r, t_e, the shading direction and everything
// after them use the ground point.  The retina quads (sfq) were looked up
// from the unwarped bearing on the host side and are read unchanged.
//
// What bounds it on an H100: by its bytes, device memory: the planar image
// is 12 bytes a pixel (24.9 MB at 1920x1080), most of what the pass must
// move, then the splat entries (40 bytes each) and the retina quads.  Its
// time goes elsewhere (NVIDIA H100 80GB HBM3, 700.00 W, headline CSR after
// 200 frames: 0.0248 ms against a 0.0087 ms bound; compare_kernels, PERF.md
// section 6): the crowded tiles' staging and candidate walk, serial per
// pixel, and the background part that writes the ~80% empty cells.
// A warp that takes several tiles, and a background grid launched beside
// the tiles as a programmatic dependent, both measured slower.  One launch
// has two parts:
//   * Tiles, the first blocks.  A k x k cell is cut into strips of `strip`
//     pixel rows, the most rows whose runs fit the warp's 32 / L lane groups
//     at once (k 16, L 1: 8 rows, so 2 tiles a cell), and one warp takes one
//     tile; kWarps warps make a block, with no block barrier, so a short
//     tile does not wait for a crowded one.  Tiles go by cell rows from the
//     image's middle outwards, where a frame's matter mostly is, so the
//     crowded tiles start first.  A tile of an empty cell ends after its one
//     CSR load.
//   * Background, the later blocks.  One thread per run of kRun pixels of an
//     image row, as a fill streams: a pixel of an empty cell gets the
//     background, or the shadow where the retina blocks it, stored 16 bytes
//     a plane; the retina quad is read with the cell's bounds, not after.
//   * Staging by age.  An entry is in time at a pixel only if its age
//     x = (t_now - ta) / dt, the ring row its segment starts at, lies within
//     [u - 0.001, u + 1.001] of the pixel's u = (t_now - t_e) / dt: one of
//     the ~5 ages a cell's entries span (two at a tick's edge; a particle
//     leaves `band` consecutive ages).  So a tile's warp stages the cell's
//     entries into its slice of shared memory grouped by rounded age, as
//     (ax, ay, bx - ax, by - ay), ta and the entry's CSR index: a counting
//     sort into at most kMaxBins bins of 2^s consecutive ages each, s the
//     least that covers the cell's span (0 but for a far zoom or a long
//     max_age), with each bin's range of x.  A run walks only the bins whose
//     x can fall in its pixels' window, widened by a margin that covers the
//     f32 rounding 16 times over.  The tests inside the walk are the plain
//     version's, in its f32 order, so what the window skips could not have
//     won.
//   * Runs.  A strip row is cut into runs of kRun = 4 pixels (the last run
//     of a row may be shorter: cell_px 9 gives 4, 4, 1).  A group of L lanes
//     takes a run; lane l of the group walks the entries l, l + L, ... of
//     the run's window with a running minimum per pixel of (d2, CSR index),
//     lexicographic: the first minimum in entry order that the plain
//     version's argmin takes, whatever order the walk visits the entries in.
//     With L > 1, a fixed __shfl_xor butterfly merges the group's minima the
//     same way, so the result is the plain version's and the same from run
//     to run.
//   * Stores.  Lane l of a group computes the run's pixels l, l + L, ...
//     (world point, r, t_e; shared with the group by shuffles) and shades
//     them (with L 1 all 4, written as one 16-byte store per plane where
//     the pixel offset is 16-byte aligned; scalar stores at a ragged edge),
//     reading the winner's velocity and colour from the entries (in L1
//     since the staging read).  The retina quads are read before the
//     staging, so their latency overlaps it.  The camera's terms of the
//     unwarp are computed once a thread (`Boost`).
//   * Division by launch constants (k, ds, runs a row, ...) is a
//     multiply-high and two shifts (`Divisor`), exact for every int.
// kLanesGround (1) and kLanesCamera (4, the boosted view's cells hold up
// to 256-384 entries) and kWarps (4) were chosen on an H100 (PERF.md,
// section 6).  The TPU layout machinery (cells on lanes, 80-wide W-rows,
// occupancy-sorted groups, assemble_sorted) does not carry over.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

enum { F_AX, F_AY, F_BX, F_BY, F_TA, F_VX, F_VY, F_CR, F_CG, F_CB, NF };

enum {
  USE_RAYS = 1,
  RETARDED = 2,
  DOPPLER = 4,
  BEAMING = 8,
  SPECTRAL = 16,
  CAMERA_FRAME = 32,
};

// the launch shape, chosen on an H100 (PERF.md, section 6): pixels of a run,
// lanes per run in each branch, warps per block
constexpr int kRun = 4;
constexpr int kLanesGround = 1;
constexpr int kLanesCamera = 4;
constexpr int kWarps = 4;
// bins a tile sorts its entries into by age
constexpr int kMaxBins = 64;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may use without opting in, and the most an H100
// block may opt into (cudaFuncAttributeMaxDynamicSharedMemorySize)
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemOptIn = 232448;

// Mirrors render_cuda.PixelParams (ctypes) field for field.
struct PixelParams {
  int n_cells, width, height, wc_img, k, ds, wq, cap, flags, row0, rows, out_h;
  float rho2_edge, inv_dt, two_rho, strength, amb, one_m_amb, absorbed_dim,
      shadow;
  float planck_x[3], planck_num[3];
};

// Exact division of a non-negative int n by a divisor d fixed at launch,
// 1 <= d < 2^31 (Granlund and Montgomery's multiply-high form for 32-bit
// unsigned dividends): n / d = (t + ((n - t) >> s1)) >> s2, t = umulhi(n, m).
struct Divisor {
  unsigned m;
  int s1, s2;
};

Divisor divisor_of(int d) {
  int l = 0;  // ceil(log2 d)
  while ((1ll << l) < d) ++l;
  const unsigned long long ud = static_cast<unsigned long long>(d);
  const unsigned long long m = (1ull << 32) * ((1ull << l) - ud) / ud + 1;
  return {static_cast<unsigned>(m), l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ int quot(int n, const Divisor& d) {
  const unsigned u = static_cast<unsigned>(n);
  const unsigned t = __umulhi(u, d.m);
  return static_cast<int>((t + ((u - t) >> d.s1)) >> d.s2);
}

// What the launch derives from PixelParams: the tiles, the background's
// runs, and the divisors of the kernel's index arithmetic.
struct Shape {
  int strip;           // pixel rows of a tile
  int tiles_per_cell;  // ceil(k / strip)
  int n_tiles;         // n_cells * tiles_per_cell
  int cell_runs;       // runs of a cell row, ceil(k / kRun)
  int img_runs;        // runs of an image row, ceil(width / kRun)
  int bg_runs;         // the band's pixel rows * img_runs: the background's threads
  int mid_row;         // the cell row tiles start from, row0 + (rows - 1) / 2
  int y0;              // the first pixel row of the band, row0 * k
  int cell_blocks, bg_blocks;
  Divisor tiles_per_cell_d, wc_img_d, cell_runs_d, img_runs_d, k_d, ds_d;
  bool vec4;  // the planes are 16-byte aligned: whole runs store as float4
};

// scal: t_now, camera x, y, vx, vy, pixel (0, 0)'s world x0, y0, pixel size
struct Frame {
  float t_now, cxm, cym, cvx, cvy, x0, y0, ps;
};

__device__ float planck(float d_safe, float x, float num) {
  // exp(x - x/D) * (1 - e^-x) / (1 - e^-x/D), exponent clamped at +-80;
  // num = 1 - e^-x comes precomputed from the host
  const float expo = fminf(fmaxf(x - x / d_safe, -80.0f), 80.0f);
  const float den = -expm1f(-x / d_safe);
  return expf(expo) * num / fmaxf(den, 1e-38f);
}

__device__ float hat(float x) { return fmaxf(0.0f, 1.0f - fabsf(x)); }

// The camera's terms of ops/boost.py unwarp_xy, which depend on its
// velocity alone: computed once a thread, in unwarp_xy's f32 order.
struct Boost {
  float v, vhx, vhy, g, inv_g2;
};

__device__ Boost boost_of(float vx, float vy) {
  const float eps = 1e-12f;
  Boost b;
  b.v = sqrtf(vx * vx + vy * vy);
  const float inv = 1.0f / fmaxf(b.v, eps);
  b.vhx = vx * inv;
  b.vhy = vy * inv;
  b.g = 1.0f / sqrtf(fmaxf(1.0f - (vx * vx + vy * vy), eps));
  b.inv_g2 = fmaxf(1.0f - b.v * b.v, eps);  // 1/gamma^2
  return b;
}

// ops/boost.py unwarp_xy: camera-frame offset (ux, uy) -> ground cone
// offset (dx, dy) for the camera of `b`.
__device__ __forceinline__ void unwarp_xy(float ux, float uy, const Boost& b, float* dx,
                                          float* dy) {
  const float u_par = ux * b.vhx + uy * b.vhy;
  const float u2 = ux * ux + uy * uy;
  const float uperp2 = fmaxf(u2 - u_par * u_par, 0.0f);
  const float a = u_par / b.g;
  const float s = sqrtf(a * a * b.v * b.v + (a * a + uperp2) * b.inv_g2);
  const float r = (s - a * b.v) / b.inv_g2;
  const float d_par = a - b.v * r;
  const float wx = ux + b.vhx * (d_par - u_par);
  const float wy = uy + b.vhy * (d_par - u_par);
  const bool still = b.v < 1e-9f;
  *dx = still ? ux : wx;
  *dy = still ? uy : wy;
}

// Pixel (gx, gy)'s world query point (unwarped in the camera frame), its
// cone radius r and its emission time t_e.
template <bool CF>
__device__ __forceinline__ void pixel_point(const Frame& s, const Boost& b,
                                            const PixelParams& p, int gx, int gy, float* pxw,
                                            float* pyw, float* r, float* t_e) {
  float x = s.x0 + static_cast<float>(gx) * s.ps;
  float y = s.y0 + static_cast<float>(gy) * s.ps;
  if (CF) {
    float ox, oy;
    unwarp_xy(x - s.cxm, y - s.cym, b, &ox, &oy);
    x = s.cxm + ox;
    y = s.cym + oy;
  }
  const float relx = x - s.cxm;
  const float rely = y - s.cym;
  *pxw = x;
  *pyw = y;
  *r = sqrtf(relx * relx + rely * rely);
  *t_e = (p.flags & RETARDED) ? s.t_now - *r : s.t_now;
}

// A float's bits as an int of the same order (for shared-memory min/max).
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// The colour of a pixel at world point (pxw, pyw) and cone radius r: its
// winning entry `win` (a row of `entries`, or -1 for no hit) shaded, or
// the background; `blocked` from the retina.
__device__ void shade(const float* __restrict__ entries, int win, bool blocked,
                      const Frame& s, const PixelParams& p, float pxw, float pyw,
                      float r, float o[3]) {
  if (win < 0) {
    const float bg = blocked ? p.shadow : 1.0f;
    o[0] = o[1] = o[2] = bg;
    return;
  }
  const float* f = entries + static_cast<size_t>(win) * NF;
  const float wvx = f[F_VX], wvy = f[F_VY];
  const float c[3] = {f[F_CR], f[F_CG], f[F_CB]};
  const float inv_r = 1.0f / fmaxf(r, 1e-12f);
  const float nx = (s.cxm - pxw) * inv_r;
  const float ny = (s.cym - pyw) * inv_r;
  float d = 1.0f;
  if (p.flags & (DOPPLER | BEAMING | SPECTRAL)) {
    const float v2s = wvx * wvx + wvy * wvy;
    const float gs = 1.0f / sqrtf(fmaxf(1.0f - v2s, 1e-12f));
    const float d_src = 1.0f / (gs * (1.0f - (wvx * nx + wvy * ny)));
    const float v2c = s.cvx * s.cvx + s.cvy * s.cvy;
    const float gc = 1.0f / sqrtf(fmaxf(1.0f - v2c, 1e-12f));
    const float d_cam = gc * (1.0f - (s.cvx * nx + s.cvy * ny));
    d = d_src * d_cam;
  }
  float sh[3];
  if (p.flags & SPECTRAL) {
    const float d_safe = fmaxf(d, 1e-3f);
    for (int i = 0; i < 3; ++i) sh[i] = c[i] * planck(d_safe, p.planck_x[i], p.planck_num[i]);
  } else if (p.flags & DOPPLER) {
    const float t = fminf(fmaxf(log2f(fmaxf(d, 1e-6f)) * p.strength, -2.5f), 2.5f);
    for (int i = 0; i < 3; ++i) {
      const float src = static_cast<float>(i) - t;
      sh[i] = hat(src) * c[0] + hat(src - 1.0f) * c[1] + hat(src - 2.0f) * c[2];
    }
  } else {
    for (int i = 0; i < 3; ++i) sh[i] = c[i];
  }
  if ((p.flags & BEAMING) && !(p.flags & SPECTRAL)) {
    const float boost = d * d * d;
    for (int i = 0; i < 3; ++i) sh[i] = sh[i] * boost;
  }
  for (int i = 0; i < 3; ++i) {
    const float mixed = p.amb * c[i] + p.one_m_amb * fminf(fmaxf(sh[i], 0.0f), 1.0f);
    o[i] = blocked ? mixed * p.absorbed_dim : mixed;
  }
}

// A tile's entries, staged in its warp's slice of shared memory.
struct Slice {
  float4* geo;  // (ax, ay, bx - ax, by - ay), in age order
  float4* box;  // x0, x1, y0, y1: the segment's box grown by rho and the rounding
  float* ta;    // the segment's start time
  int* idx;     // its index in the cell's CSR order (the tie rule)
  int* start;   // kMaxBins + 1 offsets: bin b is start[b]..start[b + 1]
  int* cursor;  // kMaxBins counters
  int* xlo;     // kMaxBins: the least and greatest (t_now - ta) / dt of a bin,
  int* xhi;     //   as order_key
};

__host__ __device__ constexpr size_t slice_bytes(int cap) {
  // geo, box, ta, idx per entry; start, cursor, xlo, xhi per age; 16-byte aligned
  return ((static_cast<size_t>(cap) * 40 + (4 * kMaxBins + 1) * 4) + 15) / 16 * 16;
}

__device__ __forceinline__ Slice slice_of(float4* smem, int warp, int cap) {
  char* base = reinterpret_cast<char*>(smem) + warp * slice_bytes(cap);
  Slice sl;
  sl.geo = reinterpret_cast<float4*>(base);
  sl.box = reinterpret_cast<float4*>(base + static_cast<size_t>(cap) * 16);
  sl.ta = reinterpret_cast<float*>(base + static_cast<size_t>(cap) * 32);
  sl.idx = reinterpret_cast<int*>(base + static_cast<size_t>(cap) * 36);
  sl.start = reinterpret_cast<int*>(base + static_cast<size_t>(cap) * 40);
  sl.cursor = sl.start + kMaxBins + 1;
  sl.xlo = sl.cursor + kMaxBins;
  sl.xhi = sl.xlo + kMaxBins;
  return sl;
}

// An entry's age in ticks before t_now, x = (t_now - ta) / dt, and x
// rounded: the ring row its segment starts at (raytrace._band_pairs:
// ta = t_now - age dt).
__device__ __forceinline__ float age_x(float t_now, float ta, float inv_dt) {
  return (t_now - ta) * inv_dt;
}

// x rounded, within +-1e9 (a NaN x counts as -1e9): ages differ by less
// than 2^31
__device__ __forceinline__ int age_of(float x) {
  return __float2int_rn(fminf(fmaxf(x, -1e9f), 1e9f));
}

// The bin of age a >= amin: bins are 2^shift ages wide.
__device__ __forceinline__ int bin_of(int a, int amin, int shift) { return (a - amin) >> shift; }

// Stage the cell's `count` (> 0) entries from row `lo` into `sl`, grouped
// by age: a counting sort into nb <= kMaxBins bins of 2^shift consecutive
// ages each, shift the least that covers the entries' span of ages (the
// order inside a bin does not matter, the walk's tie rule uses idx), with
// each bin's range of x.  Returns nb; *amin gets the least age, *shift the
// bins' width.
__device__ int stage(const float* __restrict__ entries, int lo, int count, float t_now,
                     float inv_dt, float rho, int lane, const Slice& sl, int* amin,
                     int* shift) {
  int lo_age = INT_MAX, hi_age = INT_MIN;
  for (int e = lane; e < count; e += 32) {
    const int a = age_of(age_x(t_now, entries[static_cast<size_t>(lo + e) * NF + F_TA], inv_dt));
    lo_age = min(lo_age, a);
    hi_age = max(hi_age, a);
  }
  lo_age = __reduce_min_sync(kFull, lo_age);
  hi_age = __reduce_max_sync(kFull, hi_age);
  int s = 0;
  while (((hi_age - lo_age) >> s) >= kMaxBins) ++s;
  const int nb = ((hi_age - lo_age) >> s) + 1;
  for (int b = lane; b < nb; b += 32) {
    sl.cursor[b] = 0;
    sl.xlo[b] = INT_MAX;
    sl.xhi[b] = INT_MIN;
  }
  __syncwarp();
  for (int e = lane; e < count; e += 32) {
    const float x = age_x(t_now, entries[static_cast<size_t>(lo + e) * NF + F_TA], inv_dt);
    const int b = bin_of(age_of(x), lo_age, s);
    atomicAdd(&sl.cursor[b], 1);
    atomicMin(&sl.xlo[b], order_key(x));
    atomicMax(&sl.xhi[b], order_key(x));
  }
  __syncwarp();
  // exclusive scan of the counts: lane l holds bins 2l and 2l + 1
  const int c0 = 2 * lane < nb ? sl.cursor[2 * lane] : 0;
  const int c1 = 2 * lane + 1 < nb ? sl.cursor[2 * lane + 1] : 0;
  int incl = c0 + c1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - c0 - c1;
  __syncwarp();
  if (2 * lane < nb) sl.start[2 * lane] = sl.cursor[2 * lane] = excl;
  if (2 * lane + 1 < nb) sl.start[2 * lane + 1] = sl.cursor[2 * lane + 1] = excl + c0;
  if (lane == 0) sl.start[nb] = count;
  __syncwarp();
  for (int e = lane; e < count; e += 32) {
    const float* f = entries + static_cast<size_t>(lo + e) * NF;
    const float ax = f[F_AX], ay = f[F_AY], bx = f[F_BX], by = f[F_BY], t0 = f[F_TA];
    const int pos = atomicAdd(&sl.cursor[bin_of(age_of(age_x(t_now, t0, inv_dt)), lo_age, s)], 1);
    sl.geo[pos] = make_float4(ax, ay, bx - ax, by - ay);
    // a pixel the capsule can hit lies within rho of the segment's box; the
    // walk's f32 point and distance stray from it by a few ulps of the
    // coordinates, far inside 4e-6 of them
    const float grow =
        rho * 1.001f + 4e-6f * (1.0f + fabsf(ax) + fabsf(ay) + fabsf(bx) + fabsf(by));
    sl.box[pos] = make_float4(fminf(ax, bx) - grow, fmaxf(ax, bx) + grow,
                              fminf(ay, by) - grow, fmaxf(ay, by) + grow);
    sl.ta[pos] = t0;
    sl.idx[pos] = e;
  }
  __syncwarp();
  *amin = lo_age;
  *shift = s;
  return nb;
}

__device__ __forceinline__ Frame frame_of(const float* __restrict__ scal) {
  return {scal[0], scal[1], scal[2], scal[3], scal[4], scal[5], scal[6], scal[7]};
}

// The occupied cells' part: one warp per tile; a tile of an empty cell ends
// at once (the background part writes its pixels).
template <bool CF, int L>
__device__ void cell_tile(const float* __restrict__ entries, const float* __restrict__ sfq,
                          const float* __restrict__ scal, const PixelParams& p, const Shape& sh,
                          int strip_index, int cell, int crow, int lo, int count,
                          const Slice& sl, float* __restrict__ out) {
  constexpr int G = 32 / L;  // lane groups of a warp: runs taken at once
  const int lane = threadIdx.x & 31;
  const int k = p.k;
  const Frame s = frame_of(scal);
  const Boost b = CF ? boost_of(s.cvx, s.cvy) : Boost{};
  const int row0 = strip_index * sh.strip;
  const int ccol = cell - crow * p.wc_img;
  const int tile_runs = min(sh.strip, k - row0) * sh.cell_runs;
  const int l = lane & (L - 1);
  const size_t plane = static_cast<size_t>(p.width) * p.out_h;
  int nb = 0, amin = 0, shift = 0;
  // every lane runs every pass (the staging and the shuffles need the
  // whole warp); a group past the tile's runs redoes its last run and
  // stores nothing
  for (int base = 0; base < tile_runs; base += G) {
    const int u = min(base + lane / L, tile_runs - 1);
    const int ry = quot(u, sh.cell_runs_d);
    const int cx = (u - ry * sh.cell_runs) * kRun;
    const int gy = crow * k + row0 + ry;
    const int gx0 = ccol * k + cx;
    const bool row_ok = base + lane / L < tile_runs && gy < p.height;
    bool ok[kRun], blocked[kRun];
    float sq[kRun];
    // the retina quads first: their loads overlap the staging
    const int qrow = quot(gy, sh.ds_d) * p.wq;
    int qx = quot(gx0, sh.ds_d), rx = gx0 - qx * p.ds;  // pixel gx0 + q's quad column, stepped
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      if (q > 0 && ++rx == p.ds) {
        rx = 0;
        ++qx;
      }
      ok[q] = row_ok && cx + q < k && gx0 + q < p.width;
      sq[q] = (p.flags & USE_RAYS) && ok[q] && q % L == l ? sfq[qrow + qx] : 0.0f;
    }
    if (base == 0) {
      nb = stage(entries, lo, count, s.t_now, p.inv_dt, 0.5f * p.two_rho, lane, sl, &amin,
                 &shift);
    }
    // pixel q's geometry is computed by lane q % L of the group and shared
    float pxw[kRun], pyw[kRun], r[kRun], te[kRun], md[kRun];
    int bj[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      pxw[q] = pyw[q] = r[q] = te[q] = 0.0f;
      if (q % L == l) pixel_point<CF>(s, b, p, gx0 + q, gy, &pxw[q], &pyw[q], &r[q], &te[q]);
      if (L > 1) {
        const int src = (lane & ~(L - 1)) | (q % L);
        pxw[q] = __shfl_sync(kFull, pxw[q], src);
        pyw[q] = __shfl_sync(kFull, pyw[q], src);
        te[q] = __shfl_sync(kFull, te[q], src);
      }
      md[q] = p.rho2_edge;
      bj[q] = INT_MAX;
      blocked[q] = (p.flags & USE_RAYS) && sq[q] < r[q] - p.two_rho;
    }
    float umin = INFINITY, umax = -INFINITY, tmax = 0.0f;
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      if (ok[q]) {
        const float uq = (s.t_now - te[q]) * p.inv_dt;
        umin = fminf(umin, uq);
        umax = fmaxf(umax, uq);
        tmax = fmaxf(tmax, fabsf(te[q]));
      } else {
        te[q] = __int_as_float(0x7fffffff);  // NaN: in time for no entry
      }
    }
    // The entries in time for one of the run's pixels: tau = (t_e - ta) / dt
    // in [-0.001, 1.001] puts the entry's x = (t_now - ta) / dt within
    // [u - 0.001, u + 1.001] of a pixel's u = (t_now - t_e) / dt, and
    // `margin` covers the f32 rounding of the three (16x the worst case).
    // Bins are contiguous in the slice and their x ranges ordered, so the
    // window is the bins of the ages from rint(x_lo) to rint(x_hi) (age_of
    // is monotone), less an end bin whose x all lie outside.
    const float margin =
        0.01f + (fabsf(s.t_now) + tmax + 1.0f) * p.inv_dt * 3.814697265625e-6f;  // 2^-18
    const float x_lo = umin - 0.001f - margin, x_hi = umax + 1.001f + margin;
    const int alo = age_of(x_lo), ahi = age_of(x_hi);
    int blo = alo <= amin ? 0 : min(bin_of(alo, amin, shift), nb);
    int bhi = ahi < amin ? -1 : min(bin_of(ahi, amin, shift), nb - 1);
    if (blo <= bhi && sl.xhi[blo] < order_key(x_lo)) ++blo;
    if (blo <= bhi && sl.xlo[bhi] > order_key(x_hi)) --bhi;
    const int jlo = sl.start[min(blo, nb)];
    const int jhi = blo <= bhi ? sl.start[bhi + 1] : jlo;
    // The run's box and its t_e range: an entry whose grown box misses the
    // box, or which is in time for neither end of the range (tau is
    // monotone in t_e, in f32 too), can hit none of the run's pixels.  Each
    // lane marks the entries of its part of the window that pass, 32 at a
    // time, and walks only those.
    float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
    float te0 = INFINITY, te1 = -INFINITY;
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      if (ok[q]) {
        x0 = fminf(x0, pxw[q]);
        x1 = fmaxf(x1, pxw[q]);
        y0 = fminf(y0, pyw[q]);
        y1 = fmaxf(y1, pyw[q]);
        te0 = fminf(te0, te[q]);
        te1 = fmaxf(te1, te[q]);
      }
    }
    for (int chunk = jlo + l; chunk < jhi; chunk += 32 * L) {
      unsigned marks = 0u;
      for (int i = 0; i < 32; ++i) {
        const int j = chunk + i * L;
        if (j >= jhi) break;
        const float4 bx = sl.box[j];
        const float t0 = sl.ta[j];
        const bool near = x1 >= bx.x && x0 <= bx.y && y1 >= bx.z && y0 <= bx.w;
        const bool timely = (te1 - t0) * p.inv_dt - 0.5f >= -0.501f &&
                            (te0 - t0) * p.inv_dt - 0.5f <= 0.501f;
        if (near && timely) marks |= 1u << i;
      }
      while (marks) {
        const int j = chunk + (__ffs(marks) - 1) * L;
        marks &= marks - 1u;
        const float t0 = sl.ta[j];
        const float4 c = sl.geo[j];
        const int e = sl.idx[j];
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          const float tau = (te[q] - t0) * p.inv_dt;
          const float tc = __saturatef(tau);  // clamp(tau, 0, 1), as fminf(fmaxf(tau, 0), 1)
          const float dx = pxw[q] - (c.x + tc * c.z);
          const float dy = pyw[q] - (c.y + tc * c.w);
          const float d2 = dx * dx + dy * dy;
          // the least d2, then the least CSR index: the first minimum in
          // entry order that the plain version's argmin takes
          if (fabsf(tau - 0.5f) <= 0.501f && (d2 < md[q] || (d2 == md[q] && e < bj[q]))) {
            md[q] = d2;
            bj[q] = e;
          }
        }
      }
    }
    // the group's minima, merged the same way by a fixed butterfly
#pragma unroll
    for (int o = 1; o < L; o <<= 1) {
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        const float od = __shfl_xor_sync(kFull, md[q], o);
        const int oj = __shfl_xor_sync(kFull, bj[q], o);
        if (od < md[q] || (od == md[q] && oj < bj[q])) {
          md[q] = od;
          bj[q] = oj;
        }
      }
    }
    float o[kRun][3];
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      if (ok[q] && q % L == l) {
        shade(entries, md[q] < p.rho2_edge ? lo + bj[q] : -1, blocked[q], s, p, pxw[q],
              pyw[q], r[q], o[q]);
      }
    }
    const size_t idx = static_cast<size_t>(gy - sh.y0) * p.width + gx0;
    if (L == 1 && sh.vec4 && ok[kRun - 1] && idx % kRun == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        *reinterpret_cast<float4*>(out + c * plane + idx) =
            make_float4(o[0][c], o[1][c], o[2][c], o[3][c]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        if (ok[q] && q % L == l) {
#pragma unroll
          for (int c = 0; c < 3; ++c) out[c * plane + idx + q] = o[q][c];
        }
      }
    }
  }
}

// The background part: one thread per run of kRun pixels of an image row;
// a pixel of an empty cell gets the background, or the shadow where the
// retina blocks it (what a tile writes for a pixel no entry hits).  The
// retina quads and the cells' bounds are all loaded before any is used.
template <bool CF>
__device__ void background(const int* __restrict__ cell_lo, const int* __restrict__ cell_hi,
                           const float* __restrict__ sfq, const float* __restrict__ scal,
                           const PixelParams& p, const Shape& sh, int t,
                           float* __restrict__ out) {
  const int k = p.k;
  const int by = quot(t, sh.img_runs_d);  // the row within the band
  const int gy = sh.y0 + by;
  const int gx0 = (t - by * sh.img_runs) * kRun;
  const int crow_cells = quot(gy, sh.k_d) * p.wc_img;
  const int qrow = quot(gy, sh.ds_d) * p.wq;
  // pixel gx0 + q's cell and quad columns, stepped from gx0's
  int cx = quot(gx0, sh.k_d), rc = gx0 - cx * k;
  int qx = quot(gx0, sh.ds_d), rx = gx0 - qx * p.ds;
  bool mine[kRun];
  float sv[kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const int gx = gx0 + q;
    if (q > 0 && ++rc == k) {
      rc = 0;
      ++cx;
    }
    if (q > 0 && ++rx == p.ds) {
      rx = 0;
      ++qx;
    }
    const int cell = crow_cells + cx;
    const bool in = gx < p.width;
    // the retina quad is read whatever the cell holds: no load waits on another
    sv[q] = in && (p.flags & USE_RAYS) ? sfq[qrow + qx] : 0.0f;
    mine[q] = in && min(cell_hi[in ? cell : 0] - cell_lo[in ? cell : 0], p.cap) <= 0;
  }
  const Frame s = frame_of(scal);
  const Boost b = CF ? boost_of(s.cvx, s.cvy) : Boost{};
  const size_t plane = static_cast<size_t>(p.width) * p.out_h;
  float o[kRun];
  bool all = true;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    o[q] = 1.0f;
    if (p.flags & USE_RAYS) {
      float pxw, pyw, r, te;
      pixel_point<CF>(s, b, p, gx0 + q, gy, &pxw, &pyw, &r, &te);
      if (sv[q] < r - p.two_rho) o[q] = p.shadow;
    }
    all = all && mine[q];
  }
  const size_t idx = static_cast<size_t>(by) * p.width + gx0;
  if (sh.vec4 && all && idx % kRun == 0) {
    const float4 v = make_float4(o[0], o[1], o[2], o[3]);
#pragma unroll
    for (int c = 0; c < 3; ++c) *reinterpret_cast<float4*>(out + c * plane + idx) = v;
  } else {
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      if (mine[q]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out[c * plane + idx + q] = o[q];
      }
    }
  }
}

// Blocks [0, cell_blocks) take the tiles, the rest the background: the
// crowded tiles start early and the stream fills the card around them
// (alternating the two parts' blocks measured slower).
template <bool CF, int L>
__global__ void __launch_bounds__(kWarps * 32)
    pixel_kernel(const float* __restrict__ entries, const int* __restrict__ cell_lo,
                 const int* __restrict__ cell_hi, const float* __restrict__ sfq,
                 const float* __restrict__ scal, const PixelParams p, const Shape sh,
                 float* __restrict__ out) {
  if (static_cast<int>(blockIdx.x) < sh.cell_blocks) {
    extern __shared__ float4 smem[];
    const int warp = threadIdx.x >> 5;
    const int tile = blockIdx.x * (blockDim.x >> 5) + warp;
    if (tile >= sh.n_tiles) return;
    // tiles run by cell rows from the image's middle outwards (a frame's
    // matter is mostly near the middle, so its crowded tiles start first)
    const int rank = quot(tile, sh.tiles_per_cell_d);
    const int rrow = quot(rank, sh.wc_img_d);
    const int crow = sh.mid_row + ((rrow & 1) ? (rrow + 1) >> 1 : -(rrow >> 1));
    const int cell = crow * p.wc_img + (rank - rrow * p.wc_img);
    const int lo = cell_lo[cell];
    const int count = min(cell_hi[cell] - lo, p.cap);
    if (count > 0) {  // the whole warp
      cell_tile<CF, L>(entries, sfq, scal, p, sh, tile - rank * sh.tiles_per_cell, cell,
                       crow, lo, count, slice_of(smem, warp, p.cap), out);
    }
  } else {
    const int t = (blockIdx.x - sh.cell_blocks) * blockDim.x + threadIdx.x;
    if (t < sh.bg_runs) background<CF>(cell_lo, cell_hi, sfq, scal, p, sh, t, out);
  }
}

template <bool CF>
int launch(const PixelParams& p, const float* entries, const int* cell_lo,
           const int* cell_hi, const float* sfq, const float* scal, float* out,
           cudaStream_t stream) {
  constexpr int L = CF ? kLanesCamera : kLanesGround;
  static_assert(kRun == 4 && L >= 1 && L <= 32 && (L & (L - 1)) == 0 && kWarps >= 1,
                "launch shape");
  if (p.n_cells < 0 || p.k < 1 || p.ds < 1 || p.wc_img < 1 || p.cap < 0 || p.width < 0 ||
      p.height < 0 || p.n_cells % p.wc_img != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hc_img = p.n_cells / p.wc_img;
  // the band: whole cell rows of the image, and planes that hold its pixel
  // rows (those past the image's last row are not written)
  const long long y0 = static_cast<long long>(p.row0) * p.k;
  const long long y1 = std::min(static_cast<long long>(p.row0 + p.rows) * p.k,
                                static_cast<long long>(p.height));
  if (p.row0 < 0 || p.rows < 0 || p.row0 > hc_img || p.rows > hc_img - p.row0 ||
      p.out_h < 0 || (p.rows > 0 && y1 - y0 > p.out_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh;
  sh.cell_runs = (p.k + kRun - 1) / kRun;
  // the most rows whose runs fit the warp's lane groups, within 1..k
  const int strip = (32 / L) / sh.cell_runs;
  sh.strip = strip < 1 ? 1 : (strip > p.k ? p.k : strip);
  sh.tiles_per_cell = (p.k + sh.strip - 1) / sh.strip;
  const long long n_tiles =
      static_cast<long long>(p.rows) * p.wc_img * sh.tiles_per_cell;
  sh.img_runs = (p.width + kRun - 1) / kRun;
  const long long bg_runs = (y1 > y0 ? y1 - y0 : 0) * sh.img_runs;
  const size_t per_warp = slice_bytes(p.cap);
  // tile and run indices, and the threads' (block, thread) index, stay ints
  const long long lim = INT_MAX - 1024;
  if (n_tiles > lim || bg_runs > lim || per_warp > kSmemOptIn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sh.n_tiles = static_cast<int>(n_tiles);
  sh.bg_runs = static_cast<int>(bg_runs);
  sh.tiles_per_cell_d = divisor_of(sh.tiles_per_cell);
  sh.wc_img_d = divisor_of(p.wc_img);
  sh.cell_runs_d = divisor_of(sh.cell_runs);
  sh.img_runs_d = divisor_of(sh.img_runs > 0 ? sh.img_runs : 1);
  sh.k_d = divisor_of(p.k);
  sh.ds_d = divisor_of(p.ds);
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > kSmemDefault) --warps;
  const size_t smem = warps * per_warp;
  if (smem > kSmemDefault) {
    // a slice past 48 KB (bin_capacity above 1203): one warp a block, opted
    // into the larger dynamic shared memory once for the largest seen; a
    // launch within 48 KB keeps its size and so its occupancy
    static size_t opted = kSmemDefault;
    if (smem > opted) {
      const cudaError_t err = cudaFuncSetAttribute(
          pixel_kernel<CF, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted = smem;
    }
  }
  const size_t plane = static_cast<size_t>(p.width) * p.out_h;
  sh.vec4 = plane % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = warps * 32;
  sh.mid_row = p.row0 + (p.rows - 1) / 2;
  sh.y0 = static_cast<int>(y0);
  sh.cell_blocks = (sh.n_tiles + warps - 1) / warps;
  sh.bg_blocks = (sh.bg_runs + threads - 1) / threads;
  const int blocks = sh.cell_blocks + sh.bg_blocks;
  if (blocks > 0) {
    pixel_kernel<CF, L><<<blocks, threads, smem, stream>>>(
        entries, cell_lo, cell_hi, sfq, scal, p, sh, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pixel_pass_launch(const void* entries, const void* cell_lo,
                                 const void* cell_hi, const void* sfq,
                                 const void* scal, const void* params,
                                 void* out, void* stream) {
  const PixelParams p = *static_cast<const PixelParams*>(params);
  const auto e = static_cast<const float*>(entries);
  const auto lo = static_cast<const int*>(cell_lo);
  const auto hi = static_cast<const int*>(cell_hi);
  const auto q = static_cast<const float*>(sfq);
  const auto sc = static_cast<const float*>(scal);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return (p.flags & CAMERA_FRAME) ? launch<true>(p, e, lo, hi, q, sc, o, st)
                                  : launch<false>(p, e, lo, hi, q, sc, o, st);
}
