// Light-cone band search and window fetch (a block per 32 particles).
//
// Replaces the TPU kernel spacetime_tpu/ops/band_pallas.py `_band_kernel`
// (host function `cone_band_window_pallas`), and with it the dense XLA
// sweep of spacetime_tpu/ops/raytrace.py `_cone_band_window`.  For
// particle i, over the swept ages 1..hi0 of the mirrored ring,
//   f(age) = |pos(age) - cam| - age * dt
// is monotone (|v| < c while the cone grows at c per tick).  The kernel
// finds a0 = the youngest age with f <= thresh and alast = the oldest age
// with -thresh <= f <= thresh, exactly the masked min / max reductions of
// the plain version (ops/band_cuda.py) — a full sweep, no bisection, so
// they stay right where f32 rounding or parked rows break the
// monotonicity — then gathers the band + 1 window rows [start, start +
// band] of the four planes, start = clamp(base_col - (a0 + band - 1), 0,
// 2T - band - 1), and the age of each row.  `truncated` counts particles
// with alast >= a0 + band.
//
// Layout: the ring planes are time-major (2T, N) f32.  A block holds 32
// consecutive particles (one per lane) and S = 8 age slices (one warp
// each, `kSlices`): warp s sweeps the ages 1 + s, 1 + s + S, ...,
// so each ring row it reads is one coalesced 128 B segment and the S warps
// read S neighbouring rows at a time.  The slices' a0 (min) and alast
// (max) are reduced in shared memory; integer min and max are exact in any
// order.  f is rounded as the plain version rounds it: sqrt(dx * dx + dy *
// dy), then minus float(age) * dt, with no fused multiply-add
// (-fmad=false), so a0, alast and the windows are bit-equal to it.  The
// block's 32 particles own one contiguous run of 32 x (band + 1) entries
// of each output; all its threads gather the window rows and store them
// as contiguous words.  The truncation count takes one integer atomic a
// block (the same total in any order).
//
// What bounds it on an H100: device memory.  At the headline frame
// (max_age 160, 13,312 particles) the sweep reads 160 x 13,312 x 2 planes
// x 4 B = 17 MB once (5.1 us at 3.35 TB/s), which a frame finds in device
// memory, and the windows 4 x (band + 1) rows per particle.  A thread per
// particle would sweep up to 160 rows alone, with too few loads in flight
// to cover the memory latency.  Splitting the ages S ways
// puts S times as many warps on the card, each thread issues the loads of
// kBatch ages before it uses the first, and the stores are coalesced.  It
// replaces some 120 eager launches of the plain sweep with one.  Not
// carried over from the TPU kernel: the 8-row DMA alignment, the 512-lane
// blocks, the double-buffered chunks and the masked-reduce window
// extraction (band_pallas.py:23-29, 159-207): a GPU thread loads window
// rows directly.

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 8;  // ages a thread loads before it uses them
// age slices (warps) a block, chosen on an H100 (PERF.md, section 6)
constexpr int kSlices = 8;

__global__ void band_kernel(const float* __restrict__ pos_x,
                            const float* __restrict__ pos_y,
                            const float* __restrict__ vel_x,
                            const float* __restrict__ vel_y,
                            const float* __restrict__ cam_pos, int n, int t2,
                            int col0, int a_sw, int hi0, int base_col,
                            int band, float dt, float thresh,
                            int* __restrict__ a0_out,
                            int* __restrict__ alast_out,
                            float* __restrict__ wx, float* __restrict__ wy,
                            float* __restrict__ wvx, float* __restrict__ wvy,
                            int* __restrict__ ages,
                            unsigned long long* __restrict__ truncated) {
  __shared__ int s_a0[kSlices][32];
  __shared__ int s_alast[kSlices][32];
  __shared__ int s_start[32];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int i0 = blockIdx.x * 32;
  const int i = i0 + lane;
  int a0 = hi0 + 1;
  int alast = -1;
  if (i < n) {
    const float cx = cam_pos[0];
    const float cy = cam_pos[1];
    // row col0 + s holds age a_sw - 1 - s; ages outside 1..hi0 never count
    const int top = min(hi0, a_sw - 1);
    // kBatch ages of this slice at a time: all their loads are issued
    // before the first is used, so 2 kBatch rows per thread are in flight
    for (int first = 1 + slice; first <= top; first += kBatch * kSlices) {
      float px[kBatch], py[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int age = min(first + u * kSlices, top);
        const size_t at = static_cast<size_t>(col0 + a_sw - 1 - age) * n + i;
        px[u] = pos_x[at];
        py[u] = pos_y[at];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int age = first + u * kSlices;
        const float dx = px[u] - cx;
        const float dy = py[u] - cy;
        const float f = sqrtf(dx * dx + dy * dy) - static_cast<float>(age) * dt;
        if (age <= top && f <= thresh) {
          a0 = min(a0, age);
          if (f >= -thresh) alast = max(alast, age);
        }
      }
    }
  }
  s_a0[slice][lane] = a0;
  s_alast[slice][lane] = alast;
  __syncthreads();
  const int w = band + 1;
  if (slice == 0) {
    for (int s = 1; s < kSlices; ++s) {
      a0 = min(a0, s_a0[s][lane]);
      alast = max(alast, s_alast[s][lane]);
    }
    s_start[lane] = min(max(base_col - (a0 + band - 1), 0), t2 - w);
    if (i < n) {
      a0_out[i] = a0;
      alast_out[i] = alast;
    }
    const unsigned over = __ballot_sync(0xffffffffu, i < n && alast >= a0 + band);
    if (lane == 0 && over != 0u) {
      atomicAdd(truncated, static_cast<unsigned long long>(__popc(over)));
    }
  }
  __syncthreads();
  // the block's m particles own entries [i0 * w, (i0 + m) * w) of each
  // output: consecutive threads store consecutive words
  const int m = min(32, n - i0);
  const size_t o0 = static_cast<size_t>(i0) * w;
  for (int e = threadIdx.x; e < m * w; e += kSlices * 32) {
    const int p = e / w;
    const int row = s_start[p] + (e - p * w);
    const size_t at = static_cast<size_t>(row) * n + i0 + p;
    wx[o0 + e] = pos_x[at];
    wy[o0 + e] = pos_y[at];
    wvx[o0 + e] = vel_x[at];
    wvy[o0 + e] = vel_y[at];
    ages[o0 + e] = base_col - row;
  }
}

}  // namespace

extern "C" int band_window_launch(const void* pos_x, const void* pos_y,
                                  const void* vel_x, const void* vel_y,
                                  const void* cam_pos, int n, int t2,
                                  int col0, int a_sw, int hi0, int base_col,
                                  int band, float dt, float thresh, void* a0,
                                  void* alast, void* wx, void* wy, void* wvx,
                                  void* wvy, void* ages, void* truncated,
                                  void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + 31) / 32;
  if (blocks > 0) {
    band_kernel<<<blocks, kSlices * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos_x), static_cast<const float*>(pos_y),
        static_cast<const float*>(vel_x), static_cast<const float*>(vel_y),
        static_cast<const float*>(cam_pos), n, t2, col0, a_sw, hi0, base_col, band, dt,
        thresh, static_cast<int*>(a0), static_cast<int*>(alast), static_cast<float*>(wx),
        static_cast<float*>(wy), static_cast<float*>(wvx), static_cast<float*>(wvy),
        static_cast<int*>(ages), static_cast<unsigned long long*>(truncated));
  }
  return static_cast<int>(cudaGetLastError());
}
