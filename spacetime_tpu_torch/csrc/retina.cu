// Occlusion retina: the first hit along each ray over the retina's pairs.
//
// Replaces no TPU kernel: the JAX package's `_retina`
// (spacetime_tpu/ops/raytrace.py:1373) is a plain jnp march that XLA
// fuses.  The port ran it as a chunked plain-torch chain
// (ops/retina_cuda.py `retina_march_plain`): some 38 launches a chunk, each
// reading and writing (num_rays, ray_chunk) f32 tensors, 4.6-4.7 ms a frame
// at 4,096 rays x 16,384 pairs on an H100.  This kernel computes the same
// function.  For ray r (direction dhx[r], dhy[r], computed by torch) and
// valid pair row p (fields ax, ay, bx, by, ta at columns 0..4), as
// ops/raytrace.py `_ray_hit_xy`:
//   s_hi = t_now - ta;  a = (cam + s_hi * dh) - A;  b = dt * dh + (B - A)
//   tau = clamp((a . b) / clamp(|b|^2, min 1e-20), 0, 1);  d = a - tau * b
//   s_hit = s_hi - tau * dt;  hit = |d|^2 <= rho^2 and s_hit > 0
// and s_first[r] is the least s_hit over the hits, left at the launcher's
// fill (3e38) where nothing hits.  Every operation is rounded as torch
// rounds it: the same order, each product and sum rounded on its own
// (-fmad=false), an IEEE division, clamps that keep a NaN, and the Python
// scalars rounded to f32 by the launcher.  A minimum is exact in any order,
// so s_first is bit-equal to the plain march.
//
// What bounds it on an H100: operations.  The inputs are small (16,384
// pairs x 5 floats, 328 KB, and 4,096 directions) against 67.1M ray-pair
// tests of ~30 f32 operations and one division each, ~2 GFLOP, all of it
// in registers.  A block owns kRaysPerBlock rays (kRaysPerThread a thread,
// with dt * dh and a running minimum each in registers) and one slice of
// kTile pair rows (more only past kMaxSlices slices).  It stages the
// slice's valid rows in shared memory (a shared-memory counter compacts
// them, in any order) with the per-pair terms B - A and s_hi computed once;
// then every thread walks the staged rows against its rays, one broadcast
// 16-byte load and one 4-byte load a row for kRaysPerThread tests.  The
// rays alone make 16 blocks at 4,096 rays; the small slices make 4,096 at
// 16,384 rows, so the work spreads over the card's 132 SMs also where the
// valid rows are a short prefix (a frame's boundary pairs: 1,100-2,600 of
// 16,384 in the retarded cells), and a block whose slice holds none only
// reads its validity.  The slices combine by one atomicMin a ray and slice
// that hit, on the float's bits as int: every candidate is > 0, where int
// order is float order.  t_now and the camera position are read through
// device pointers, so a captured CUDA graph replays at the ring's current
// time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRaysPerThread = 2;
constexpr int kRaysPerBlock = kThreads * kRaysPerThread;
// pair rows a block stages in shared memory at a time, and a block's slice
// while the grid's y extent allows it
constexpr int kTile = 64;
constexpr int kMaxSlices = 65535;

// torch.clamp on the card: a NaN stays NaN, else fmaxf / fminf
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
retina_kernel(const float* __restrict__ pdata, int stride,
              const unsigned char* __restrict__ valid, int n_pairs, int chunk,
              const float* __restrict__ dhx, const float* __restrict__ dhy,
              int n_rays, const float* __restrict__ cam_pos,
              const float* __restrict__ t_now_ptr, float dt, float rho2,
              float tiny, float* __restrict__ s_first) {
  __shared__ float4 s_pair[kTile];  // ax, ay, bx - ax, by - ay
  __shared__ float s_hi[kTile];     // t_now - ta
  __shared__ int s_count;
  const float cx = cam_pos[0], cy = cam_pos[1], t_now = *t_now_ptr;
  const int ray0 = blockIdx.x * kRaysPerBlock + threadIdx.x;
  float ux[kRaysPerThread], uy[kRaysPerThread];  // dh
  float wx[kRaysPerThread], wy[kRaysPerThread];  // dt * dh
  float best[kRaysPerThread];
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int r = ray0 + k * kThreads;
    ux[k] = r < n_rays ? dhx[r] : 0.0f;
    uy[k] = r < n_rays ? dhy[r] : 0.0f;
    wx[k] = dt * ux[k];
    wy[k] = dt * uy[k];
    best[k] = __int_as_float(0x7f800000);  // +inf: no hit yet
  }
  const int lo = blockIdx.y * chunk;
  const int hi = min(n_pairs, lo + chunk);
  for (int base = lo; base < hi; base += kTile) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int p = base + i;
      if (p < hi && valid[p]) {
        const float* row = pdata + static_cast<size_t>(p) * stride;
        const float ax = row[0], ay = row[1];
        const int slot = atomicAdd(&s_count, 1);
        s_pair[slot] = make_float4(ax, ay, row[2] - ax, row[3] - ay);
        s_hi[slot] = t_now - row[4];
      }
    }
    __syncthreads();
    const int n = s_count;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 q = s_pair[j];
      const float sh = s_hi[j];
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) {
        const float a_x = (cx + sh * ux[k]) - q.x;
        const float a_y = (cy + sh * uy[k]) - q.y;
        const float b_x = wx[k] + q.z;
        const float b_y = wy[k] + q.w;
        const float bb = b_x * b_x + b_y * b_y;
        const float tau = clamp01(__fdiv_rn(a_x * b_x + a_y * b_y, clamp_min(bb, tiny)));
        const float d_x = a_x - tau * b_x;
        const float d_y = a_y - tau * b_y;
        const float s_hit = sh - tau * dt;
        if (d_x * d_x + d_y * d_y <= rho2 && s_hit > 0.0f) best[k] = fminf(best[k], s_hit);
      }
    }
    __syncthreads();  // the tile is read before the next one is staged
  }
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int r = ray0 + k * kThreads;
    if (r < n_rays && best[k] < __int_as_float(0x7f800000)) {
      atomicMin(reinterpret_cast<int*>(s_first + r), __float_as_int(best[k]));
    }
  }
}

}  // namespace

// s_first (n_rays,) must hold the no-hit value (3e38) on entry; the kernel
// lowers each ray's entry to its first hit.  pdata is (n_pairs, >= 5) f32
// with row stride `stride` (elements), valid (n_pairs,) bool; cam_pos (2,)
// and t_now () f32 on the device; dt, rho2 (rho * rho) and tiny (1e-20)
// rounded to f32 as torch rounds them.  n_rays >= 1; n_pairs >= 0 (none:
// one launch that changes nothing).  Returns the launch's cudaError_t.
extern "C" int retina_march_launch(const float* pdata, int stride, const unsigned char* valid,
                                   int n_pairs, const float* dhx, const float* dhy, int n_rays,
                                   const float* cam_pos, const float* t_now, float dt,
                                   float rho2, float tiny, float* s_first,
                                   cudaStream_t stream) {
  const int ray_blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  const int tiles = n_pairs > kTile ? (n_pairs + kTile - 1) / kTile : 1;
  const int slices = tiles < kMaxSlices ? tiles : kMaxSlices;
  const int per_slice = (n_pairs + slices - 1) / slices;
  const int chunk = per_slice > kTile ? per_slice : kTile;
  retina_kernel<<<dim3(ray_blocks, slices), kThreads, 0, stream>>>(
      pdata, stride, valid, n_pairs, chunk, dhx, dhy, n_rays, cam_pos, t_now, dt, rho2, tiny,
      s_first);
  return cudaGetLastError();
}
