// Collision forces over cell-sorted particles (one thread per particle).
//
// Replaces the TPU kernel spacetime_tpu/ops/forces_pallas.py
// `_collision_kernel` (host function `collision_forces_pallas`).  Per particle i it
// sums  repulsion * (p_i - p_j) / |p_i - p_j|  over every j with
// 0 < |p_i - p_j|^2 < cd^2, bonded pairs included (the caller subtracts
// them with `bonded_repulsion_shifted`); dist2 > 0 is the self-exclusion.
//
// Layout: particles are stable-sorted by flat halo cell id once per step
// (ops/forces_cuda.py), and `cell_start[c]` is the first sorted row of cell
// c (an empty cell starts where the next one does).  Row-major cell ids
// make the cells (cx-R .. cx+R) of one grid row a contiguous range of
// sorted rows, so a particle's neighbourhood is 2R+1 exact ranges — no
// window cap, hence `window_truncated` is always 0 on this path.  R is 1
// (the 3x3 scan) for the stage-0 positions the cells were built from; the
// later RK4 stages move particles by up to `max_disp` (a device scalar the
// caller reduces per stage), and R grows to cover it, so contacts that
// form during the step are found exactly as the all-pairs oracle finds
// them.  A fixed 3x3 scan misses them: at a 0.5c impact, pairs close by
// more than a 0.002 ls bin within one step.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic.  At the
// headline size (13k particles, a few candidates each at 0.002 ls bins)
// the position table sits in L2, and the cost is the launch plus a few
// dependent loads per candidate (index, then position); the design
// keeps every candidate read a cached load and accumulates in registers in
// a fixed order, so results are deterministic run to run (no atomics).
// The TPU kernel's 128-element window alignment, DMA chunking, split
// windows and BIGPOS overscan exist to feed the TPU's DMA engine and do not
// carry over.

#include <cuda_runtime.h>

namespace {

__global__ void collision_kernel(const float2* __restrict__ pos,
                                 const int* __restrict__ sorted_idx,
                                 const int* __restrict__ sorted_cell,
                                 const int* __restrict__ cell_start,
                                 const float* __restrict__ max_disp, int n,
                                 int n_cells, int side, float cd, float cd2,
                                 float bres, float repulsion,
                                 float2* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = sorted_idx[t];
  const int c = sorted_cell[t];
  float fx = 0.0f, fy = 0.0f;
  if (c < n_cells) {  // inactive particles (cell id n_cells) get no force
    const float2 p = pos[i];
    const int cy = c / side;
    const int cx = c - cy * side;
    // cells were assigned at the step's start positions; since then every
    // particle moved by at most max_disp per axis, so a pair in contact now
    // was at most cd + 2 max_disp apart per axis at the start: R cells
    const int reach = static_cast<int>(ceilf((cd + 2.0f * max_disp[0]) / bres));
    const int r = min(max(reach, 1), side);
    const int x_lo = max(cx - r, 0);
    const int x_hi = min(cx + r, side - 1);
    for (int row = max(cy - r, 0); row <= min(cy + r, side - 1); ++row) {
      // cells x_lo..x_hi of one grid row are one contiguous sorted range;
      // row * side + x_hi + 1 <= n_cells, the last entry of cell_start
      const int lo = cell_start[row * side + x_lo];
      const int hi = cell_start[row * side + x_hi + 1];
      for (int j = lo; j < hi; ++j) {
        const float2 q = pos[sorted_idx[j]];
        const float dx = p.x - q.x;
        const float dy = p.y - q.y;
        const float d2 = dx * dx + dy * dy;
        if (d2 < cd2 && d2 > 0.0f) {
          const float mag = repulsion * rsqrtf(fmaxf(d2, 1e-20f));
          fx += mag * dx;
          fy += mag * dy;
        }
      }
    }
  }
  out[i] = make_float2(fx, fy);
}

}  // namespace

extern "C" int collision_forces_launch(const void* pos, const void* sorted_idx,
                                       const void* sorted_cell,
                                       const void* cell_start,
                                       const void* max_disp, int n,
                                       int n_cells, int side, float cd,
                                       float cd2, float bres, float repulsion,
                                       void* out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    collision_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(pos), static_cast<const int*>(sorted_idx),
        static_cast<const int*>(sorted_cell),
        static_cast<const int*>(cell_start),
        static_cast<const float*>(max_disp), n, n_cells, side, cd, cd2, bres,
        repulsion, static_cast<float2*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
