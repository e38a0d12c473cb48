// The non-relativistic point view: one pixel per active on-screen particle,
// the lowest particle index winning a shared pixel, coloured by its object
// on a white background.
//
// Replaces the TPU kernel spacetime_tpu/ops/points_pallas.py
// `_points_kernel` (host functions `_rasterize_sorted`,
// `render_points_pallas`).  Two launches make one render:
//   1. points_winner_kernel, one thread per particle: the pixel as
//      camera.world_to_pixel computes it, ((p - cam) * (larger / zoom) +
//      (size - 1) / 2) in f32 with no fused multiply-add, rounded half to
//      even (rintf, as jnp.round / torch.round); an active particle on
//      screen takes an atomicMin of its index into the int32 (H * W)
//      winner buffer, which the wrapper fills with N.
//   2. points_resolve_kernel, one thread per pixel: the winner's object
//      colour, or white, written planar (3, H, W).
// Only an integer minimum decides a pixel, so the image is the same in any
// order of the atomics and bit-equal to the plain version (ops/points_cuda.py,
// a scatter_reduce "amin").  There is no window cap, so nothing is dropped:
// PointsDiag.window_truncated is 0 by construction.
//
// What bounds it on an H100: device memory and launch overhead.  At the
// 116k reference demo (capacity 149,248, 1920x1080) pass 1 reads 1.3 MB of
// particle state and issues at most one atomic per particle, pass 2
// touches the 8 MB winner buffer and writes the 25 MB image.  Not carried
// over from the TPU kernel: the (8, 128) tile keys, the key sort, the
// per-group windows and the one-hot MXU matmuls (points_pallas.py:13-25,
// 89-126), which exist because a TPU scatter serializes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void points_winner_kernel(const float2* __restrict__ pos,
                                     const uint8_t* __restrict__ active,
                                     const float* __restrict__ cam_pos,
                                     const float* __restrict__ cam_zoom, int n,
                                     int width, int height, float larger,
                                     float half_w, float half_h,
                                     int* __restrict__ winner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !active[i]) return;
  const float scale = larger / cam_zoom[0];
  const float2 p = pos[i];
  const float x = rintf((p.x - cam_pos[0]) * scale + half_w);
  const float y = rintf((p.y - cam_pos[1]) * scale + half_h);
  // compared as floats, so far-off-screen coordinates never reach an
  // integer conversion
  if (x >= 0.0f && x < static_cast<float>(width) && y >= 0.0f &&
      y < static_cast<float>(height)) {
    atomicMin(&winner[static_cast<int>(y) * width + static_cast<int>(x)], i);
  }
}

__global__ void points_resolve_kernel(const int* __restrict__ winner,
                                      const int* __restrict__ object_index,
                                      const float* __restrict__ base_color,
                                      int n, int hw, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int w = winner[p];
  float r = 1.0f, g = 1.0f, b = 1.0f;
  if (w < n) {
    const float* c = base_color + 3 * object_index[w];
    r = c[0];
    g = c[1];
    b = c[2];
  }
  out[p] = r;
  out[hw + p] = g;
  out[2 * hw + p] = b;
}

}  // namespace

extern "C" int points_launch(const void* pos, const void* active,
                             const void* cam_pos, const void* cam_zoom,
                             const void* object_index, const void* base_color,
                             int n, int width, int height, void* winner,
                             void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const float larger = static_cast<float>(width > height ? width : height);
  if (n > 0) {
    points_winner_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const float2*>(pos), static_cast<const uint8_t*>(active),
        static_cast<const float*>(cam_pos), static_cast<const float*>(cam_zoom),
        n, width, height, larger, 0.5f * (width - 1), 0.5f * (height - 1),
        static_cast<int*>(winner));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int hw = width * height;
  if (hw > 0) {
    points_resolve_kernel<<<(hw + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const int*>(winner), static_cast<const int*>(object_index),
        static_cast<const float*>(base_color), n, hw, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
