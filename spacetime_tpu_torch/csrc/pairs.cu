// The retarded frame's pair rows, compacted to the pair budget (two
// launches, one C call).
//
// Replaces no Pallas kernel: the JAX package builds its pair rows and
// compacts them in plain jnp (spacetime_tpu/ops/raytrace.py `_band_pairs`,
// `_compact_pairs_two_segment`), which XLA fuses.  The port ran the same
// chain as plain torch (ops/raytrace.py `_band_search`, then
// `_compact_pairs_two_segment` / `_compact_pairs_to_budget`), which stays
// as the CPU version and the card's reference: about 25 ops on (N, band)
// tensors for the segment tests, a 10-column torch.stack into (N * k, 10)
// rows, a class key, a stable radix sort of every row and a gather of the
// first `pair_budget`.  At 2^20 particles and band 4 that is 4.19M rows
// (168 MB written at a 40-byte stride) built and sorted to keep 131,072:
// 2.7 ms of a 6 ms device frame on an H100.  These kernels write the kept
// rows only, in their final compacted order.
//
// From the band kernel's window (csrc/band.cu: per particle the band + 1
// window entries of the four ring planes and their ages, ascending), segment
// j of particle i runs from window entry j (A, its age a_j) to entry j + 1
// (B).  It is valid, as ops/raytrace.py `_band_search` tests it, iff
//   1 <= a_j <= hi0,  max(|A - cam|, |B - cam|) >= (s_hi - dt) - rho,
//   min(|A - cam|, |B - cam|) <= s_hi + rho,  |A.x| < 1e8,
//   s_hi = t_now - (t_now - float(a_j) * dt),
// and, with the view-hull cull, its bounding box meets the view + camera
// hull grown by margin = 4 (rho + dt).  With 0 < segments < band a particle
// keeps its first `segments` valid crossings (rank compaction) and counts
// the rest as dropped.  A row is the plain chain's 10 fields: A, B, t_a =
// t_now - float(a_j) * dt, the velocity at A, the object's colour.  Every
// operation rounds as torch rounds it on the card: the same expressions in
// the same order, each product and sum rounded on its own (-fmad=false),
// an IEEE square root, maxima and minima that keep a NaN, Python scalars
// rounded to f32 by the launcher; the pixel size is torch's own
// `cam.zoom / max(width, height)`, read through a pointer.
//
// The order is `_compact_by_class`'s stable order: the valid rows of
// boundary particles in row order (particle-major, then crossing), then the
// other valid rows in row order, then sentinel rows (all ten fields 2e9,
// pair_valid false), cut to `out_rows`.  Without a boundary mask every
// valid row is of the second class.  `dense` instead keeps the uncompacted
// (N * k, 10) layout, each row at its own index (invalid rows: 2e9
// endpoints, t_a 0; a rank-compacted slot with no crossing also has a zero
// velocity).  `totals` receives the valid count before the budget, the
// first class's count and the dropped crossings.
//
//   * pair_count_kernel: a block of kTile particles, one a thread.  A
//     thread reads its particle's window of wx, wy and the ages, tests its
//     band segments (each window entry's distance to the camera computed
//     once) and stores the valid mask; the block sums its rows of each
//     class and its dropped crossings into one tile entry.
//   * pair_rows_kernel: the same tiling.  A block sums the tile entries
//     before its own and of all tiles (an exclusive scan over at most a few
//     thousand entries, read from L2), then scans its threads' row counts
//     (both classes packed in one 32-bit word), so each thread knows where
//     its particle's rows go, and writes those that land under out_rows,
//     40 bytes a row as five 8-byte stores.  The rows from the valid count
//     to out_rows get sentinels, over the whole grid; block 0 writes the
//     totals.  No atomics: every count is exact and the order fixed.
//
// What bounds it on an H100: device memory.  The first launch reads three
// of the window's five (N, band + 1) planes once (wx, wy, ages: 63 MB at
// 2^20 and band 4) and writes 4 bytes a particle; the second reads the masks
// and the boundary flags, the window entries of the particles that have
// rows, and writes out_rows x 41 bytes (5.4 MB at a budget of 131,072):
// about 0.022 ms at 3.35 TB/s.  The window's reads stride band + 1 words
// between neighbouring threads, which L1 absorbs (a block's 1,024
// particles are 61 KB of the three planes).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // particles a block, one a thread
constexpr int kWarps = kTile / 32;
constexpr int kMaxBand = 32;  // the valid mask is one 32-bit word
constexpr float kFar = 2.0e9f;

}  // namespace

// Field order: pointers, then ints, then floats (no padding between
// groups); kernels.py mirrors it as a ctypes Structure and checks its size.
struct PairRowsArgs {
  const float* wx;             // (N, band + 1) window rows, ascending age
  const float* wy;
  const float* wvx;
  const float* wvy;
  const int* ages;             // (N, band + 1)
  const int* hi0;              // () oldest usable age
  const float* cam_pos;        // (2,)
  const float* t_now;          // ()
  const float* pixel_size;     // () cam.zoom / max(width, height); null: no cull
  const int* obj_index;        // (N,)
  const float* base_color;     // (objects, 3)
  const bool* boundary;        // (N,) or null: one class
  unsigned* mask;              // (N,) scratch: each particle's valid mask
  int* tiles;                  // (tiles, 3) scratch: class 0 rows, class 1 rows, dropped
  float* pdata;                // (out_rows, 10)
  bool* pair_valid;            // (out_rows,)
  long long* totals;           // (3,) valid rows, class 0 rows, dropped crossings
  int n, band, k, out_rows, dense, width, height;
  float dt, rho, margin;
};

namespace {

// torch.maximum / torch.minimum on the card: NaN if either is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// the rows a particle keeps of its valid mask: all of them, or with rank
// compaction (k < band) its first k
__device__ __forceinline__ int kept_rows(unsigned valid, const PairRowsArgs& a) {
  const int c = __popc(valid);
  return a.k < a.band ? min(c, a.k) : c;
}

// the sum of v over the block (every thread gets it); `red` holds kWarps
// ints and is free again when this returns
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = lane < kWarps ? red[lane] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  s = __shfl_sync(0xffffffffu, s, 0);
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kTile) pair_count_kernel(const PairRowsArgs a) {
  __shared__ int red[kWarps];
  const int i = blockIdx.x * kTile + threadIdx.x;
  unsigned valid = 0u;
  if (i < a.n) {
    const int hi0 = *a.hi0;
    const float cx = a.cam_pos[0];
    const float cy = a.cam_pos[1];
    const float t_now = *a.t_now;
    // the view + camera hull of ops/raytrace.py `_band_search`, each bound
    // in torch's order: x0 = cam.x - (width - 1) / 2 * pixel_size, ...
    float vx0 = 0.0f, vx1 = 0.0f, vy0 = 0.0f, vy1 = 0.0f;
    const bool cull = a.pixel_size != nullptr;
    if (cull) {
      const float ps = *a.pixel_size;
      const float x0 = cx - static_cast<float>((a.width - 1) / 2.0) * ps;
      const float y0 = cy - static_cast<float>((a.height - 1) / 2.0) * ps;
      vx0 = tmin(x0, cx) - a.margin;
      vx1 = tmax(x0 + static_cast<float>(a.width) * ps, cx) + a.margin;
      vy0 = tmin(y0, cy) - a.margin;
      vy1 = tmax(y0 + static_cast<float>(a.height) * ps, cy) + a.margin;
    }
    const int w = a.band + 1;
    const float* px = a.wx + static_cast<size_t>(i) * w;
    const float* py = a.wy + static_cast<size_t>(i) * w;
    const int* pa = a.ages + static_cast<size_t>(i) * w;
    float qax = px[0];
    float qay = py[0];
    float dx = qax - cx;
    float dy = qay - cy;
    float ra = sqrtf(dx * dx + dy * dy);
    for (int j = 0; j < a.band; ++j) {
      const float qbx = px[j + 1];
      const float qby = py[j + 1];
      dx = qbx - cx;
      dy = qby - cy;
      const float rb = sqrtf(dx * dx + dy * dy);
      const int age = pa[j];
      const float pta = t_now - static_cast<float>(age) * a.dt;
      const float s_hi = t_now - pta;
      bool v = age >= 1 && age <= hi0 && tmax(ra, rb) >= (s_hi - a.dt) - a.rho &&
               tmin(ra, rb) <= s_hi + a.rho && fabsf(qax) < 1.0e8f;
      if (cull) {
        v = v && tmax(qax, qbx) >= vx0 && tmin(qax, qbx) <= vx1 && tmax(qay, qby) >= vy0 &&
            tmin(qay, qby) <= vy1;
      }
      if (v) valid |= 1u << j;
      qax = qbx;
      qay = qby;
      ra = rb;
    }
    a.mask[i] = valid;
  }
  const int rows = kept_rows(valid, a);
  const bool first = i < a.n && a.boundary != nullptr && a.boundary[i];
  const int c0 = block_sum(first ? rows : 0, red);
  const int c1 = block_sum(first ? 0 : rows, red);
  const int dropped = block_sum(__popc(valid) - rows, red);
  if (threadIdx.x == 0) {
    a.tiles[3 * blockIdx.x] = c0;
    a.tiles[3 * blockIdx.x + 1] = c1;
    a.tiles[3 * blockIdx.x + 2] = dropped;
  }
}

// one row of 10 fields at pdata + 10 r, as five 8-byte stores
__device__ __forceinline__ void store_row(float* pdata, int r, const float f[10]) {
  float2* o = reinterpret_cast<float2*>(pdata + static_cast<size_t>(r) * 10);
#pragma unroll
  for (int c = 0; c < 5; ++c) o[c] = make_float2(f[2 * c], f[2 * c + 1]);
}

// the row of particle i's segment `col`; `ok` false gives the uncompacted
// layout's invalid row (2e9 endpoints, t_a 0, velocity zeroed if `zero_v`)
__device__ __forceinline__ void pair_row(const PairRowsArgs& a, int i, int col, bool ok,
                                         bool zero_v, const float rgb[3], float t_now,
                                         float f[10]) {
  const size_t at = static_cast<size_t>(i) * (a.band + 1) + col;
  f[0] = ok ? a.wx[at] : kFar;
  f[1] = ok ? a.wy[at] : kFar;
  f[2] = ok ? a.wx[at + 1] : kFar;
  f[3] = ok ? a.wy[at + 1] : kFar;
  f[4] = ok ? t_now - static_cast<float>(a.ages[at]) * a.dt : 0.0f;
  f[5] = zero_v ? 0.0f : a.wvx[at];
  f[6] = zero_v ? 0.0f : a.wvy[at];
  f[7] = rgb[0];
  f[8] = rgb[1];
  f[9] = rgb[2];
}

__global__ void __launch_bounds__(kTile) pair_rows_kernel(const PairRowsArgs a, int n_tiles) {
  __shared__ int red[kWarps];
  __shared__ unsigned scan[kWarps];
  // the tiles before this block's, and all of them
  int pre0 = 0, pre1 = 0, all0 = 0, all1 = 0, dropped = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kTile) {
    const int c0 = a.tiles[3 * t];
    const int c1 = a.tiles[3 * t + 1];
    all0 += c0;
    all1 += c1;
    dropped += a.tiles[3 * t + 2];
    if (t < static_cast<int>(blockIdx.x)) {
      pre0 += c0;
      pre1 += c1;
    }
  }
  pre0 = block_sum(pre0, red);
  pre1 = block_sum(pre1, red);
  all0 = block_sum(all0, red);
  all1 = block_sum(all1, red);
  dropped = block_sum(dropped, red);
  const int total = all0 + all1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.totals[0] = total;
    a.totals[1] = all0;
    a.totals[2] = dropped;
  }

  const int i = blockIdx.x * kTile + threadIdx.x;
  const unsigned valid = i < a.n ? a.mask[i] : 0u;
  const int rows = kept_rows(valid, a);
  const bool first = i < a.n && a.boundary != nullptr && a.boundary[i];
  // exclusive scan of the block's rows, class 0 in the low half-word and
  // class 1 in the high one (each at most kTile x kMaxBand = 32,768)
  const unsigned mine = first ? static_cast<unsigned>(rows) : static_cast<unsigned>(rows) << 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) scan[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kWarps ? scan[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned up = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += up;
    }
    if (lane < kWarps) scan[lane] = s;
  }
  __syncthreads();
  const unsigned ex = inc - mine + (warp > 0 ? scan[warp - 1] : 0u);

  if (i < a.n && (rows > 0 || a.dense)) {
    const float t_now = *a.t_now;
    const float* c = a.base_color + 3 * static_cast<size_t>(a.obj_index[i]);
    const float rgb[3] = {c[0], c[1], c[2]};
    float f[10];
    unsigned bits = valid;
    if (a.dense) {
      const bool rank = a.k < a.band;
      for (int s = 0; s < a.k; ++s) {
        // with rank compaction slot s holds the particle's (s + 1)-th valid
        // crossing, else column s
        bool ok;
        int col = s;
        if (rank) {
          ok = s < rows;
          if (ok) {
            col = __ffs(bits) - 1;
            bits &= bits - 1u;
          }
        } else {
          ok = (valid >> s) & 1u;
        }
        pair_row(a, i, col, ok, rank && !ok, rgb, t_now, f);
        const int r = i * a.k + s;
        store_row(a.pdata, r, f);
        a.pair_valid[r] = ok;
      }
    } else {
      const int base = first ? pre0 + static_cast<int>(ex & 0xffffu)
                             : all0 + pre1 + static_cast<int>(ex >> 16);
      for (int s = 0; s < rows && base + s < a.out_rows; ++s) {
        const int col = __ffs(bits) - 1;
        bits &= bits - 1u;
        pair_row(a, i, col, true, false, rgb, t_now, f);
        store_row(a.pdata, base + s, f);
        a.pair_valid[base + s] = true;
      }
    }
  }
  if (!a.dense) {
    // the rows past the valid ones: sentinels
    float f[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) f[c] = kFar;
    const int stride = gridDim.x * kTile;
    for (int r = min(total, a.out_rows) + static_cast<int>(blockIdx.x) * kTile + threadIdx.x;
         r < a.out_rows; r += stride) {
      store_row(a.pdata, r, f);
      a.pair_valid[r] = false;
    }
  }
}

}  // namespace

extern "C" int pairs_struct_size() { return static_cast<int>(sizeof(PairRowsArgs)); }

// particles a tile: the wrapper sizes the scratch's tile entries by it
extern "C" int pairs_tile() { return kTile; }

extern "C" int pair_rows_launch(const PairRowsArgs* args, void* stream) {
  const PairRowsArgs& a = *args;
  const long long rows = static_cast<long long>(a.n) * a.k;
  if (a.n < 0 || a.band < 1 || a.band > kMaxBand || a.k < 1 || a.k > a.band ||
      rows > (1LL << 30) || a.out_rows < 0 || a.out_rows > rows ||
      (a.dense && a.out_rows != rows) || (a.dense && a.boundary)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (a.n + kTile - 1) / kTile;
  if (n_tiles > 0) pair_count_kernel<<<n_tiles, kTile, 0, s>>>(a);
  // one block at least: block 0 writes the totals
  pair_rows_kernel<<<max(n_tiles, 1), kTile, 0, s>>>(a, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
