// Collision forces over cell-sorted particles (a group of lanes per particle).
//
// Replaces the TPU kernel spacetime_tpu/ops/forces_pallas.py
// `_collision_kernel` (host function `collision_forces_pallas`).  Per particle i it
// sums  repulsion * (p_i - p_j) / |p_i - p_j|  over every j with
// 0 < |p_i - p_j|^2 < cd^2, in one of the TPU kernel's two variants:
//   * include (`exclude_bonds=False`, collision_forces_launch): bonded
//     pairs stay in the sum, the caller subtracts them with
//     `bonded_repulsion_shifted`; dist2 > 0 is the self-exclusion;
//   * exclude (`exclude_bonds=True`, collision_forces_exclude_launch): the
//     kernel itself drops j == i and j == neighbors[i][0..7], for scenes
//     whose bonds have no shifted offsets (forces_pallas.py:68-73, 158-163).
//     The distance test runs first; the 9 id compares run only for a
//     candidate inside the cutoff, against the 8 neighbour slots each lane
//     loaded once before its scan (a -1 slot never equals a candidate,
//     whose ids are >= 0).  The sum is the same as comparing first.
//
// Layout: particles are stable-sorted by flat halo cell id once per step
// (ops/forces_cuda.py), and `cell_start[c]` is the first sorted row of cell
// c (an empty cell starts where the next one does).  Row-major cell ids
// make the cells x_lo..x_hi of one grid row a contiguous range of sorted
// rows, so a particle's neighbourhood is one exact range per grid row — no
// window cap, hence `window_truncated` is always 0 on this path.
//
// The scan: the cells were built from the step's start positions, and
// since then every active particle moved by at most (Dx, Dy) (`disp`, a
// device pair the caller reduces per RK4 stage).  A partner j of i at its
// current position p has |p - q_j| < cd, so j's start position lies within
// cd + Dx of p.x and cd + Dy of p.y.  The group scans exactly the cells
// those two intervals map to, by the cell function of grid.cell_ids
// (origin, bin, clamp into [1, grid_dim] — so particles parked outside the
// extent in border cells are still found), each interval widened by
// kRel of the magnitudes involved, many times the f32 rounding of the
// bounds and of the cell division (here or in grid.cell_ids).  Contacts
// that form during a step are found exactly as the all-pairs oracle finds
// them.  At stage 0 (disp 0) this is about the 3 x 3 cells around the
// particle; at stages 1-3 it is narrower than a square of reach
// ceil((cd + 2 max(Dx, Dy)) / bin) around the start cell, and much
// narrower across the direction of motion.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic (its
// bytes take a fraction of a launch's time).  At the
// headline size (13k particles, a few to a few tens of candidates each) the
// tables sit in L2, and each candidate is a chain of dependent loads (row
// bounds, then the sorted id, then the position; the bounds of kRows rows
// are loaded in one round trip).  One thread per particle would leave
// most of the card idle (13k threads: about 100 blocks of 4 warps on 132
// SMs), each thread walking its chain alone.  So each particle gets
// a group of G lanes (a power of two: 8, or 16 when excluding); lane l takes the
// candidates l, l + G, ... of the concatenation of the group's row ranges,
// which splits each chain G ways and puts G times as many warps on the card
// to overlap them.  The lanes' partial forces are summed by a __shfl_xor
// butterfly in a fixed order: no float atomics, so the result is
// bit-identical from run to run.
// A launch covers the sorted rows [row0, row0 + rows): the whole order
// (row0 0, rows n), or one rank's share of it on a mesh (the TPU kernel's
// tile grid split across chips, forces_pallas.py:451-492), whose forces the
// caller sums across the ranks.  A row's force is written at its particle
// index only, so rows outside the range leave `out` as the caller filled
// it.
// The TPU kernel's 128-element window alignment, DMA chunking, split
// windows and BIGPOS overscan exist to feed the TPU's DMA engine and do not
// carry over.

#include <cuda_runtime.h>

namespace {

// widening of each scan bound, relative to |p| + |origin| + cd + D: 16
// roundings of f32 (2^-24 each) of the largest magnitude in the bound and
// the cell division
constexpr float kRel = 1.0f / 1048576.0f;  // 2^-20
// grid rows whose range bounds are loaded at once (the 3 rows of stage 0
// and the few of a step's later stages across the motion fit in one go)
constexpr int kRows = 4;
// the launch shape, chosen on an H100 (PERF.md, section 6): lanes per
// particle for each variant (the exclude variant's later-stage scans hold
// more candidates) and threads per block
constexpr int kLanesInclude = 8;
constexpr int kLanesExclude = 16;
constexpr int kThreads = 256;

// grid.cell_ids' cell of a coordinate already in cell units from the
// origin: floor, clamped in float (a far particle would overflow an int)
// into [0, grid_dim - 1], plus the halo
__device__ __forceinline__ int cell_of(float u, int grid_dim) {
  return static_cast<int>(fminf(fmaxf(floorf(u), 0.0f), static_cast<float>(grid_dim - 1))) + 1;
}

template <bool EXCLUDE, int G>
__global__ void collision_kernel(const float2* __restrict__ pos,
                                 const int* __restrict__ sorted_idx,
                                 const int* __restrict__ sorted_cell,
                                 const int* __restrict__ cell_start,
                                 const float* __restrict__ origin,
                                 const float* __restrict__ disp, int n,
                                 int row0, int rows, int n_cells, int side, float cd, float cd2,
                                 float bres, float repulsion,
                                 const int* __restrict__ neighbors,
                                 float2* __restrict__ out) {
  const int lane = threadIdx.x & (G - 1);
  // the group's sorted row; neighbouring groups hold neighbouring cells,
  // so their ranges overlap in L1
  const int local = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int t = row0 + local;
  const bool mine = local < rows && t < n;
  int i = 0;
  float fx = 0.0f, fy = 0.0f;
  if (mine) {
    i = sorted_idx[t];
    if (sorted_cell[t] < n_cells) {  // inactive particles (cell id n_cells) get no force
      const float2 p = pos[i];
      int nbr[8];
      if (EXCLUDE) {
        for (int s = 0; s < 8; ++s) nbr[s] = neighbors[static_cast<size_t>(i) * 8 + s];
      }
      const int grid_dim = side - 2;
      const float rx = cd + disp[0];
      const float ry = cd + disp[1];
      const float ox = origin[0];
      const float oy = origin[1];
      const float ex = rx + (fabsf(p.x) + fabsf(ox) + rx) * kRel;
      const float ey = ry + (fabsf(p.y) + fabsf(oy) + ry) * kRel;
      const int x_lo = cell_of((p.x - ex - ox) / bres, grid_dim);
      const int x_hi = cell_of((p.x + ex - ox) / bres, grid_dim);
      const int y_lo = cell_of((p.y - ey - oy) / bres, grid_dim);
      const int y_hi = cell_of((p.y + ey - oy) / bres, grid_dim);
      int base = 0;  // candidates in the rows before this one
      for (int r0 = y_lo; r0 <= y_hi; r0 += kRows) {
        // cells x_lo..x_hi of one grid row are one contiguous sorted range;
        // row * side + x_hi + 1 < n_cells, an entry of cell_start.  The
        // bounds of up to kRows rows are loaded together (independent
        // loads, one round trip), then their candidates walked
        int lo[kRows], hi[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = min(r0 + r, y_hi);
          lo[r] = cell_start[row * side + x_lo];
          hi[r] = r0 + r <= y_hi ? cell_start[row * side + x_hi + 1] : lo[r];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          for (int k = lo[r] + ((lane - base) & (G - 1)); k < hi[r]; k += G) {
            const int j = sorted_idx[k];
            const float2 q = pos[j];
            const float dx = p.x - q.x;
            const float dy = p.y - q.y;
            const float d2 = dx * dx + dy * dy;
            if (d2 < cd2 && d2 > 0.0f) {
              if (EXCLUDE) {
                bool bonded = j == i;
                for (int s = 0; s < 8; ++s) bonded |= j == nbr[s];
                if (bonded) continue;
              }
              const float mag = repulsion * rsqrtf(fmaxf(d2, 1e-20f));
              fx += mag * dx;
              fy += mag * dy;
            }
          }
          base += hi[r] - lo[r];
        }
      }
    }
  }
  // every lane of the warp reaches here (no early return): the butterfly
  // adds the same pairs in the same order on every run, and commutes, so
  // all G lanes hold the same bits
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    fx += __shfl_xor_sync(0xffffffffu, fx, o);
    fy += __shfl_xor_sync(0xffffffffu, fy, o);
  }
  if (mine && lane == 0) out[i] = make_float2(fx, fy);
}

template <bool EXCLUDE>
int launch(const void* pos, const void* sorted_idx, const void* sorted_cell,
           const void* cell_start, const void* origin, const void* disp, int n, int row0,
           int rows, int n_cells, int side, float cd, float cd2, float bres, float repulsion,
           const void* neighbors, void* out, void* stream) {
  constexpr int G = EXCLUDE ? kLanesExclude : kLanesInclude;
  static_assert(G <= 32 && (G & (G - 1)) == 0 && kThreads % 32 == 0, "launch shape");
  if (n < 0 || row0 < 0 || rows < 0 || row0 > n || rows > n - row0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(rows) * G;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  if (blocks > 0) {
    collision_kernel<EXCLUDE, G><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos), static_cast<const int*>(sorted_idx),
        static_cast<const int*>(sorted_cell), static_cast<const int*>(cell_start),
        static_cast<const float*>(origin), static_cast<const float*>(disp), n, row0, rows,
        n_cells, side,
        cd, cd2, bres, repulsion, static_cast<const int*>(neighbors),
        static_cast<float2*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int collision_forces_launch(const void* pos, const void* sorted_idx,
                                       const void* sorted_cell,
                                       const void* cell_start, const void* origin,
                                       const void* disp, int n, int row0, int rows,
                                       int n_cells, int side, float cd, float cd2,
                                       float bres, float repulsion, void* out,
                                       void* stream) {
  return launch<false>(pos, sorted_idx, sorted_cell, cell_start, origin, disp, n, row0,
                       rows, n_cells, side, cd, cd2, bres, repulsion, nullptr, out, stream);
}

extern "C" int collision_forces_exclude_launch(
    const void* pos, const void* sorted_idx, const void* sorted_cell,
    const void* cell_start, const void* origin, const void* disp, int n, int row0,
    int rows, int n_cells, int side, float cd, float cd2, float bres, float repulsion,
    const void* neighbors, void* out, void* stream) {
  return launch<true>(pos, sorted_idx, sorted_cell, cell_start, origin, disp, n, row0,
                      rows, n_cells, side, cd, cd2, bres, repulsion, neighbors, out, stream);
}
