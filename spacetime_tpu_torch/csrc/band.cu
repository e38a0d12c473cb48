// Light-cone band search and window fetch (one thread per particle).
//
// Replaces the TPU kernel spacetime_tpu/ops/band_pallas.py `_band_kernel`
// (host function `cone_band_window_pallas`), and with it the dense XLA
// sweep of spacetime_tpu/ops/raytrace.py `_cone_band_window`.  For
// particle i, over the swept ages 1..hi0 of the mirrored ring,
//   f(age) = |pos(age) - cam| - age * dt
// is monotone (|v| < c while the cone grows at c per tick).  The thread
// keeps a0 = the youngest age with f <= thresh and alast = the oldest age
// with -thresh <= f <= thresh, exactly the masked min / max reductions of
// the plain version (ops/band_cuda.py), then gathers the band + 1 window
// rows [start, start + band] of the four planes, start =
// clamp(base_col - (a0 + band - 1), 0, 2T - band - 1), and the age of each
// row.  `truncated` counts particles with alast >= a0 + band (an integer
// atomic: the count is the same in any order).
//
// Layout: the ring planes are time-major (2T, N) f32, so the threads of a
// warp read one age row coalesced.  f is rounded as the plain version
// rounds it: sqrt(dx * dx + dy * dy), then minus float(age) * dt, with no
// fused multiply-add (-fmad=false), so a0, alast and the windows are
// bit-equal to it.
//
// What bounds it on an H100: device memory.  At the headline frame
// (max_age 160, 13,312 particles) the sweep reads 160 x 13,312 x 2 planes
// x 4 B = 17 MB once, and the window 7 x 4 rows per particle; the loop
// keeps several age rows in flight per thread (unrolled) so the loads
// overlap.  It replaces some 120 eager launches of the plain sweep with
// one.  Not carried over from the TPU kernel: the 8-row DMA alignment, the
// 512-lane blocks, the double-buffered chunks and the masked-reduce
// window extraction (band_pallas.py:23-29, 159-207): a GPU thread loads
// its window rows directly.

#include <cuda_runtime.h>

namespace {

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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float cx = cam_pos[0];
  const float cy = cam_pos[1];
  int a0 = hi0 + 1;
  int alast = -1;
  // row col0 + s holds age a_sw - 1 - s; ages outside 1..hi0 never count
  const int top = min(hi0, a_sw - 1);
#pragma unroll 8
  for (int age = 1; age <= top; ++age) {
    const size_t at = static_cast<size_t>(col0 + a_sw - 1 - age) * n + i;
    const float dx = pos_x[at] - cx;
    const float dy = pos_y[at] - cy;
    const float f = sqrtf(dx * dx + dy * dy) - static_cast<float>(age) * dt;
    if (f <= thresh) {
      a0 = min(a0, age);
      if (f >= -thresh) alast = max(alast, age);
    }
  }
  const int w = band + 1;
  const int start = min(max(base_col - (a0 + band - 1), 0), t2 - w);
  for (int j = 0; j < w; ++j) {
    const size_t at = static_cast<size_t>(start + j) * n + i;
    const size_t o = static_cast<size_t>(i) * w + j;
    wx[o] = pos_x[at];
    wy[o] = pos_y[at];
    wvx[o] = vel_x[at];
    wvy[o] = vel_y[at];
    ages[o] = base_col - (start + j);
  }
  a0_out[i] = a0;
  alast_out[i] = alast;
  if (alast >= a0 + band) atomicAdd(truncated, 1ULL);
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
  // 64 threads a block: the headline's 13,312 particles fill 208 blocks,
  // more than the card's 132 SMs
  const int threads = 64;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    band_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos_x), static_cast<const float*>(pos_y),
        static_cast<const float*>(vel_x), static_cast<const float*>(vel_y),
        static_cast<const float*>(cam_pos), n, t2, col0, a_sw, hi0, base_col,
        band, dt, thresh, static_cast<int*>(a0), static_cast<int*>(alast),
        static_cast<float*>(wx), static_cast<float*>(wy),
        static_cast<float*>(wvx), static_cast<float*>(wvy),
        static_cast<int*>(ages),
        static_cast<unsigned long long*>(truncated));
  }
  return static_cast<int>(cudaGetLastError());
}
