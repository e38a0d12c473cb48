// The non-relativistic point view: one pixel per active on-screen particle,
// the lowest particle index winning a shared pixel, coloured by its object
// on a white background.
//
// Replaces the TPU kernel spacetime_tpu/ops/points_pallas.py
// `_points_kernel` (host functions `_rasterize_sorted`,
// `render_points_pallas`).  Two launches make one render, over two scratch
// buffers that the wrapper (ops/points_cuda.py) keeps between calls and
// that every render leaves as it found them: an int32 winner slot per
// pixel, all kEmpty (INT32_MAX, so the buffer serves any capacity), and an
// occupancy mask of one bit a pixel, all 0.
//   1. points_winner_kernel, one thread per particle: the pixel as
//      camera.world_to_pixel computes it, ((p - cam) * (larger / zoom) +
//      (size - 1) / 2) in f32 with no fused multiply-add, rounded half to
//      even (rintf, as jnp.round / torch.round); an active particle on
//      screen takes an atomicMin of its index into the pixel's winner slot
//      and sets the pixel's mask bit (atomicOr); neither waits for a reply.
//   2. points_resolve_kernel, one thread per run of 4 pixels: one read of
//      the mask word that holds the run's 4 bits (8 threads share a word);
//      for a set bit the winner's object colour, and the winner slot set
//      back to kEmpty; the colours written planar (3, H, W), one 16-byte
//      store per plane where the plane size is a multiple of 4; then the
//      first thread of the word clears it (after a __syncwarp: its 8
//      readers are lanes of one warp).  It is launched as pass 1's
//      programmatic dependent: pass 1's blocks let it launch at once, and
//      it waits (griddepcontrol.wait) for pass 1 to finish before its first
//      read, so the launch gap between the passes is hidden.
// Only an integer minimum decides a pixel, so the image is the same in any
// order of the atomics and bit-equal to the plain version (ops/points_cuda.py,
// a scatter_reduce "amin").  There is no window cap, so nothing is dropped:
// PointsDiag.window_truncated is 0 by construction.
//
// What bounds it on an H100: device memory.  At the 116k reference demo
// (capacity 149,248, 1920x1080) the planar image is 24.9 MB of the ~27 MB a
// render must move; pass 1 reads 1.9 MB of particle state and touches one
// winner slot per active on-screen particle, pass 2 reads the 259 KB mask
// and only the touched winner slots.  Nothing fills or reads the whole
// 8.3 MB winner buffer in a render.  On an NVIDIA H100 80GB HBM3 at 700 W
// a render reads 0.0118 ms against a 0.0080 ms bound (PERF.md, section 6).
// Not carried over from the TPU kernel:
// the (8, 128) tile keys, the key sort, the per-group windows and the
// one-hot MXU matmuls (points_pallas.py:13-25, 89-126), which exist because
// a TPU scatter serializes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kEmpty = INT_MAX;
constexpr int kRun = 4;  // pixels of a resolve thread
constexpr unsigned kFull = 0xffffffffu;

__global__ void points_winner_kernel(const float2* __restrict__ pos,
                                     const uint8_t* __restrict__ active,
                                     const float* __restrict__ cam_pos,
                                     const float* __restrict__ cam_zoom, int n,
                                     int width, int height, float larger,
                                     float half_w, float half_h,
                                     int* __restrict__ winner,
                                     unsigned* __restrict__ mask) {
  // the resolve pass may launch now: it waits for this grid before it
  // reads what this grid writes
  asm volatile("griddepcontrol.launch_dependents;");
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
    const int px = static_cast<int>(y) * width + static_cast<int>(x);
    atomicMin(&winner[px], i);
    atomicOr(&mask[px >> 5], 1u << (px & 31));
  }
}

__global__ void points_resolve_kernel(int* __restrict__ winner,
                                      unsigned* __restrict__ mask,
                                      const int* __restrict__ object_index,
                                      const float* __restrict__ base_color,
                                      int hw, bool vec4, float* __restrict__ out) {
  // this grid launched early (programmatic dependent launch): wait until
  // the winner pass has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int p0 = t * kRun;  // a multiple of 4: the run's bits share one word
  const unsigned word = p0 < hw ? mask[p0 >> 5] : 0u;
  const unsigned bits = (word >> (p0 & 31)) & ((1u << kRun) - 1u);
  float c[3][kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    c[0][q] = c[1][q] = c[2][q] = 1.0f;
    if (bits & (1u << q)) {
      const int w = winner[p0 + q];
      const float* col = base_color + 3 * object_index[w];
      c[0][q] = col[0];
      c[1][q] = col[1];
      c[2][q] = col[2];
      winner[p0 + q] = kEmpty;
    }
  }
  // the word's 8 threads are lanes of this warp: all have read it
  __syncwarp(kFull);
  if (word != 0u && (t & 7) == 0) mask[p0 >> 5] = 0u;
  const size_t plane = static_cast<size_t>(hw);
  if (vec4 && p0 < hw) {  // hw % 4 == 0: the run lies in the image
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      *reinterpret_cast<float4*>(out + ch * plane + p0) =
          make_float4(c[ch][0], c[ch][1], c[ch][2], c[ch][3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      if (p0 + q < hw) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) out[ch * plane + p0 + q] = c[ch][q];
      }
    }
  }
}

}  // namespace

extern "C" int points_launch(const void* pos, const void* active,
                             const void* cam_pos, const void* cam_zoom,
                             const void* object_index, const void* base_color,
                             int n, int width, int height, void* winner,
                             void* mask, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float larger = static_cast<float>(width > height ? width : height);
  if (n < 0 || width < 0 || height < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    points_winner_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float2*>(pos), static_cast<const uint8_t*>(active),
        static_cast<const float*>(cam_pos), static_cast<const float*>(cam_zoom),
        n, width, height, larger, 0.5f * (width - 1), 0.5f * (height - 1),
        static_cast<int*>(winner), static_cast<unsigned*>(mask));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int hw = width * height;
  if (hw > 0) {
    const int runs = (hw + kRun - 1) / kRun;
    const bool vec4 = hw % kRun == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((runs + kThreads - 1) / kThreads);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, points_resolve_kernel, static_cast<int*>(winner), static_cast<unsigned*>(mask),
        static_cast<const int*>(object_index), static_cast<const float*>(base_color), hw, vec4,
        static_cast<float*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
