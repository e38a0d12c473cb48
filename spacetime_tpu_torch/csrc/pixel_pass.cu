// Per-pixel pass of the flat retarded-time renderer: one CTA per view cell,
// one thread per pixel of the cell's k x k block (cells wider than 32
// pixels, which the Engine's cell ladder picks at deep zoom-in, loop over
// their pixels with 1024 threads).
//
// Replaces the TPU kernel spacetime_tpu/ops/render_pallas.py `_pixel_kernel`
// with its `_shade_group` (host function `pixel_pass_pallas`).  For each pixel:
//   * the pixel's world position, cone radius r and emission time
//     t_e = t_now - r (t_now when not retarded);
//   * a running min over the cell's splat entries (ops/raytrace.py CSR:
//     entries[cell_lo[c]:cell_hi[c]], nearest-first): the nearest in-time
//     swept-capsule hit with |tau - 0.5| <= 0.501 and dist2 < nextafter(rho^2),
//     strict < so the FIRST minimum in entry order wins;
//   * Doppler (source x camera), hat-band or exact Planck shading, D^3
//     beaming, ambient mix;
//   * composition with the occlusion retina: blocked when
//     s_first < r - 2 rho, which selects absorbed_dim or the shadow.
// The planar (3, H, W) image is written directly; pixels of the partial
// last cell row/column (1080 = 67.5 x 16) are skipped.
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
// What bounds it on an H100: arithmetic and instruction throughput in the candidate loop
// (~15 flops per candidate per pixel, up to bin_capacity candidates), not
// memory: a cell's entries (<= bin_capacity x 10 floats, 2.5 KB at 64) are
// read once from device memory into shared memory and then broadcast to all
// k^2 threads, so device-memory traffic is ~40 bytes per entry per cell plus
// 12 bytes per pixel written.  The TPU layout machinery (cells on lanes,
// 80-wide W-rows, occupancy-sorted groups, assemble_sorted) does not carry
// over.

#include <cuda_runtime.h>

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

// Mirrors render_cuda.PixelParams (ctypes) field for field.
struct PixelParams {
  int n_cells, width, height, wc_img, k, ds, wq, cap, flags;
  float rho2_edge, inv_dt, two_rho, strength, amb, one_m_amb, absorbed_dim,
      shadow;
  float planck_x[3], planck_num[3];
};

__device__ float planck(float d_safe, float x, float num) {
  // exp(x - x/D) * (1 - e^-x) / (1 - e^-x/D), exponent clamped at +-80;
  // num = 1 - e^-x comes precomputed from the host
  const float expo = fminf(fmaxf(x - x / d_safe, -80.0f), 80.0f);
  const float den = -expm1f(-x / d_safe);
  return expf(expo) * num / fmaxf(den, 1e-38f);
}

__device__ float hat(float x) { return fmaxf(0.0f, 1.0f - fabsf(x)); }

// ops/boost.py unwarp_xy: camera-frame offset (ux, uy) -> ground cone
// offset (dx, dy) for camera velocity (vx, vy).
__device__ void unwarp_xy(float ux, float uy, float vx, float vy, float* dx,
                          float* dy) {
  const float eps = 1e-12f;
  const float v = sqrtf(vx * vx + vy * vy);
  const float inv = 1.0f / fmaxf(v, eps);
  const float vhx = vx * inv;
  const float vhy = vy * inv;
  const float g = 1.0f / sqrtf(fmaxf(1.0f - (vx * vx + vy * vy), eps));
  const float u_par = ux * vhx + uy * vhy;
  const float u2 = ux * ux + uy * uy;
  const float uperp2 = fmaxf(u2 - u_par * u_par, 0.0f);
  const float a = u_par / g;
  const float inv_g2 = fmaxf(1.0f - v * v, eps);  // 1/gamma^2
  const float s = sqrtf(a * a * v * v + (a * a + uperp2) * inv_g2);
  const float r = (s - a * v) / inv_g2;
  const float d_par = a - v * r;
  const float wx = ux + vhx * (d_par - u_par);
  const float wy = uy + vhy * (d_par - u_par);
  const bool still = v < 1e-9f;
  *dx = still ? ux : wx;
  *dy = still ? uy : wy;
}

// The pass for pixel (gx, gy) over the cell's `count` entries staged in sh.
__device__ void shade_pixel(const float* sh, int count, const float* __restrict__ sfq,
                            const float* __restrict__ scal, const PixelParams& p,
                            int gx, int gy, float* __restrict__ out) {
  const float t_now = scal[0], cxm = scal[1], cym = scal[2];
  const float cvx = scal[3], cvy = scal[4];
  const float x0 = scal[5], y0 = scal[6], ps = scal[7];
  float pxw = x0 + static_cast<float>(gx) * ps;
  float pyw = y0 + static_cast<float>(gy) * ps;
  if (p.flags & CAMERA_FRAME) {
    float ox, oy;
    unwarp_xy(pxw - cxm, pyw - cym, cvx, cvy, &ox, &oy);
    pxw = cxm + ox;
    pyw = cym + oy;
  }
  const float relx = pxw - cxm;
  const float rely = pyw - cym;
  const float r = sqrtf(relx * relx + rely * rely);
  const float t_e = (p.flags & RETARDED) ? t_now - r : t_now;

  // start one f32 ULP past rho^2 so `dist2 < min_d` is exactly the
  // reference's `dist2 <= rho^2` acceptance
  float min_d = p.rho2_edge;
  float wvx = 0.0f, wvy = 0.0f, wcr = 0.0f, wcg = 0.0f, wcb = 0.0f;
  for (int j = 0; j < count; ++j) {
    const float* f = sh + j * NF;
    const float tau = (t_e - f[F_TA]) * p.inv_dt;
    const bool in_time = fabsf(tau - 0.5f) <= 0.501f;
    const float tc = fminf(fmaxf(tau, 0.0f), 1.0f);
    const float dx = pxw - (f[F_AX] + tc * (f[F_BX] - f[F_AX]));
    const float dy = pyw - (f[F_AY] + tc * (f[F_BY] - f[F_AY]));
    const float d2 = dx * dx + dy * dy;
    if (in_time && d2 < min_d) {
      min_d = d2;
      wvx = f[F_VX];
      wvy = f[F_VY];
      wcr = f[F_CR];
      wcg = f[F_CG];
      wcb = f[F_CB];
    }
  }
  const bool occupied = min_d < p.rho2_edge;
  const bool blocked =
      (p.flags & USE_RAYS) &&
      sfq[(gy / p.ds) * p.wq + gx / p.ds] < r - p.two_rho;

  float o[3];
  if (occupied) {
    const float inv_r = 1.0f / fmaxf(r, 1e-12f);
    const float nx = (cxm - pxw) * inv_r;
    const float ny = (cym - pyw) * inv_r;
    float d = 1.0f;
    if (p.flags & (DOPPLER | BEAMING | SPECTRAL)) {
      const float v2s = wvx * wvx + wvy * wvy;
      const float gs = 1.0f / sqrtf(fmaxf(1.0f - v2s, 1e-12f));
      const float d_src = 1.0f / (gs * (1.0f - (wvx * nx + wvy * ny)));
      const float v2c = cvx * cvx + cvy * cvy;
      const float gc = 1.0f / sqrtf(fmaxf(1.0f - v2c, 1e-12f));
      const float d_cam = gc * (1.0f - (cvx * nx + cvy * ny));
      d = d_src * d_cam;
    }
    float s[3];
    const float c[3] = {wcr, wcg, wcb};
    if (p.flags & SPECTRAL) {
      const float d_safe = fmaxf(d, 1e-3f);
      for (int i = 0; i < 3; ++i) s[i] = c[i] * planck(d_safe, p.planck_x[i], p.planck_num[i]);
    } else if (p.flags & DOPPLER) {
      const float t =
          fminf(fmaxf(log2f(fmaxf(d, 1e-6f)) * p.strength, -2.5f), 2.5f);
      for (int i = 0; i < 3; ++i) {
        const float src = static_cast<float>(i) - t;
        s[i] = hat(src) * c[0] + hat(src - 1.0f) * c[1] + hat(src - 2.0f) * c[2];
      }
    } else {
      for (int i = 0; i < 3; ++i) s[i] = c[i];
    }
    if ((p.flags & BEAMING) && !(p.flags & SPECTRAL)) {
      const float boost = d * d * d;
      for (int i = 0; i < 3; ++i) s[i] = s[i] * boost;
    }
    for (int i = 0; i < 3; ++i) {
      const float mixed =
          p.amb * c[i] + p.one_m_amb * fminf(fmaxf(s[i], 0.0f), 1.0f);
      o[i] = blocked ? mixed * p.absorbed_dim : mixed;
    }
  } else {
    const float bg = blocked ? p.shadow : 1.0f;
    o[0] = o[1] = o[2] = bg;
  }
  const size_t plane = static_cast<size_t>(p.width) * p.height;
  const size_t idx = static_cast<size_t>(gy) * p.width + gx;
  out[idx] = o[0];
  out[plane + idx] = o[1];
  out[2 * plane + idx] = o[2];
}

__global__ void pixel_kernel(const float* __restrict__ entries,
                             const int* __restrict__ cell_lo,
                             const int* __restrict__ cell_hi,
                             const float* __restrict__ sfq,
                             const float* __restrict__ scal,
                             const PixelParams p, float* __restrict__ out) {
  extern __shared__ float sh[];
  const int cell = blockIdx.x;
  const int lo = cell_lo[cell];
  const int count = min(cell_hi[cell] - lo, p.cap);
  for (int e = threadIdx.x; e < count * NF; e += blockDim.x) {
    sh[e] = entries[static_cast<size_t>(lo) * NF + e];
  }
  __syncthreads();

  const int k = p.k;
  const int crow = cell / p.wc_img;
  const int ccol = cell - crow * p.wc_img;
  for (int q = threadIdx.x; q < k * k; q += blockDim.x) {
    const int gx = ccol * k + q % k;
    const int gy = crow * k + q / k;
    if (gx < p.width && gy < p.height) shade_pixel(sh, count, sfq, scal, p, gx, gy, out);
  }
}

}  // namespace

extern "C" int pixel_pass_launch(const void* entries, const void* cell_lo,
                                 const void* cell_hi, const void* sfq,
                                 const void* scal, const void* params,
                                 void* out, void* stream) {
  const PixelParams p = *static_cast<const PixelParams*>(params);
  const size_t smem = static_cast<size_t>(p.cap) * NF * sizeof(float);
  const int threads = p.k * p.k < 1024 ? p.k * p.k : 1024;
  if (p.n_cells > 0) {
    pixel_kernel<<<p.n_cells, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(entries), static_cast<const int*>(cell_lo),
        static_cast<const int*>(cell_hi), static_cast<const float*>(sfq),
        static_cast<const float*>(scal), p, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
