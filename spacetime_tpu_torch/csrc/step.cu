// The RK4 step's per-particle arithmetic, around the collision kernel.
//
// Replaces no TPU kernel: the JAX package's step (spacetime_tpu/ops/rk4.py
// `physics_step`) is a plain jnp chain that XLA fuses.  In the port that
// chain ran as some 100 torch ops a force evaluation (ops/rk4.py,
// ops/forces.py), each (N, 8) f32 temporary a round trip to device memory:
// 535 device ops and 9 ms a step at 2^20 particles on an H100.  Two kernels
// do the same arithmetic in registers, one thread per particle (a row of
// this rank's block, global index row0 + r):
//   * bond_stage_kernel, one launch a force evaluation (4 an RK4 step, 1 an
//     Euler step), after that evaluation's collision launch.  It reads the
//     row's 8 neighbour slots once and decides which are bonded (shifted
//     layout: nbr - i is one of the slot's offsets; rows layout: nbr >= 0),
//     gathers each partner's stage position and sums, slot by slot in slot
//     order, the Hooke spring term (with the pairwise-mean stiffness scale),
//     minus the bonded pairs' repulsion (shifted layout: the collision
//     kernel's include variant counted them), plus the bond damping against
//     the step's start velocities; adds the collision force as
//     coll + bonded, and the result into the force accumulator as
//     ((f0 + 2 f1) + 2 f2) + f3; for stages 0-2 writes the next stage's
//     position (ops/rk4.py `_advance`: acceleration at the start velocity,
//     position from the new velocity) and folds its per-axis displacement
//     from the start positions into a (2,) maximum that the next collision
//     launch widens its scan by (an integer atomicMax on the non-negative
//     float bits, one per block and axis: exact in any order).  RK4 stage 0
//     also breaks bonds and creeps rest lengths: it reads the start
//     positions, the same partners and the same distances those need, so
//     they cost no pass of their own; the new neighbour table and rest
//     lengths go to new buffers (the later stages read the old ones), the
//     broken count to one integer atomic a warp that broke any.
//   * step_finish_kernel, one launch a step: the final combine
//     (vel0 + r_acc(facc, vel0) h/6, the |v| >= 1 clamp to max_speed,
//     pos0 + vel h) or Euler's update, and the `active` select.
// Every operation rounds as the plain-torch functions round on the card:
// csrc/ builds with -fmad=false (kernels.NVCC_FLAGS), and each expression
// keeps the plain code's order of operations, so the bonded sum, the
// broken bonds and the crept rest lengths are bit-equal to ops/forces.py
// and ops/rk4.py on the same CUDA tensors.  The accelerations are not held
// to the bit (torch's 2-element norm reduces in its own order), only to
// the CPU path's tolerances.
//
// What bounds it on an H100: device memory.  A force evaluation must read
// per particle its stage and start positions, start velocity, 8 neighbour
// ids, rest mass, active flag, the collision force and the accumulator,
// and write the accumulator and the next position: about 95 bytes, 0.03 ms
// at 2^20 and 3.35 TB/s.  The partners lie about +-1 and +-one lattice row
// away, so their positions come from L1 and L2; per-bond rest lengths add
// 32 bytes; stage 0's new tables 32-64 more.  The arithmetic (8 IEEE square
// roots and divisions a particle) stays under the memory time.  The
// finish reads and writes about 45 bytes a particle.

#include <cuda_runtime.h>

// Field order: pointers, then ints, then floats (no padding between
// groups); kernels.py mirrors it as a ctypes Structure and checks its size.
struct BondStageArgs {
  const float2* pos;          // (N, 2) this evaluation's positions (global)
  const float2* pos0;         // (N, 2) the step's start positions (global)
  const float2* vel0;         // (B, 2) the block's start velocities
  const float2* gvel0;        // (N, 2) start velocities (global), damping only
  const float* mass;          // (B,) rest mass
  const bool* active;         // (B,)
  const int* nbr;             // (B, 8) neighbour ids, -1 empty
  const int* offsets;         // (8, width) shifted table, or null: rows layout
  const float* rest;          // (8,) per slot, or (B, 8) per bond (rest_stride 8)
  const float* k_pp;          // (N,) stiffness scale or null
  const float* c_pp;          // (N,) damping coefficient or null
  const float2* coll;         // (B, 2) this evaluation's collision forces
  const float2* facc_in;      // (B, 2) the accumulator so far (unread at weight 0)
  float2* facc_out;           // (B, 2)
  float2* next;               // (B, 2) the next stage's positions, or null
  int* disp;                  // (2,) float bits, max-folded, or null
  int* nbr_out;               // (B, 8) after breaking, or null: no breaking
  int* broken;                // () bonds broken, added to
  const float* break_scale;   // (N,) or null
  float* rest_out;            // (B, 8) after creep, or null: no creep
  const float* creep_rate;    // (N,)
  const float* yield_strain;  // (N,) or null
  int n, rows, row0, width, rest_stride, weight;
  float k, k_half, cd2, repulsion, h_adv, c2, threshold, h;
};

struct StepFinishArgs {
  const float2* facc;    // (B, 2) the summed forces (f0 for Euler)
  const float2* pos0;    // (N, 2) start positions (global)
  const float2* vel0;    // (B, 2)
  const float* mass;     // (B,)
  const bool* active;    // (B,)
  float2* pos;           // (B, 2) out
  float2* vel;           // (B, 2) out
  int n, rows, row0, euler;
  float h, h6, c2, max_speed;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 8;  // offsets per slot (forces.derive_spring_offsets)
constexpr float kEps = 1e-20f;  // ops/forces.py _EPS
constexpr unsigned kFull = 0xffffffffu;

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// relativity.r_acc(f, v, m) with g = gamma(|v|) and den = m g precomputed:
// (f - (v.f) v / c^2) / den
__device__ __forceinline__ float2 r_acc(float2 f, float2 v, float den, float c2) {
  const float vdotf = v.x * f.x + v.y * f.y;
  return make_float2((f.x - vdotf * v.x / c2) / den, (f.y - vdotf * v.y / c2) / den);
}

__device__ __forceinline__ float gamma_den(float2 v, float m, float c2) {
  const float speed = sqrtf(v.x * v.x + v.y * v.y);
  return m * (1.0f / sqrtf(1.0f - speed * speed / c2));
}

template <bool SHIFTED, bool KPP, bool DAMP>
__global__ void __launch_bounds__(kThreads) bond_stage_kernel(const BondStageArgs a) {
  __shared__ int off[8 * kMaxWidth];
  __shared__ unsigned dmax[2][kWarps];
  if (SHIFTED) {
    for (int t = threadIdx.x; t < 8 * a.width; t += kThreads) off[t] = a.offsets[t];
    __syncthreads();
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool mine = r < a.rows;
  unsigned mx = 0u, my = 0u;  // this thread's displacement, as float bits
  int broken = 0;
  if (mine) {
    // every per-row read is issued here, before the partners' gathers that
    // wait on the neighbour ids (nothing the kernel writes aliases them)
    const int i = a.row0 + r;
    const float2 p = __ldg(a.pos + i);
    int nb[8];
    const int4* nrow = reinterpret_cast<const int4*>(a.nbr + static_cast<size_t>(r) * 8);
    const int4 n0 = __ldg(nrow), n1 = __ldg(nrow + 1);
    nb[0] = n0.x; nb[1] = n0.y; nb[2] = n0.z; nb[3] = n0.w;
    nb[4] = n1.x; nb[5] = n1.y; nb[6] = n1.z; nb[7] = n1.w;
    const float* rrow = a.rest + static_cast<size_t>(r) * a.rest_stride;
    const float kpi = KPP ? __ldg(a.k_pp + i) : 0.0f;
    const float cpi = DAMP ? __ldg(a.c_pp + i) : 0.0f;
    const float2 vi = __ldg(a.vel0 + r);
    const float2 c = __ldg(a.coll + r);
    const float2 prev = a.weight != 0 ? __ldg(a.facc_in + r) : make_float2(0.0f, 0.0f);
    const float2 p0 = a.next ? __ldg(a.pos0 + i) : make_float2(0.0f, 0.0f);
    const float m = a.next ? __ldg(a.mass + r) : 0.0f;
    const bool act = a.next && a.active[r];
    const bool brk = a.nbr_out != nullptr;
    const bool creep = a.rest_out != nullptr;
    const float bsi = brk && a.break_scale ? __ldg(a.break_scale + i) : 0.0f;
    const float cri = creep ? __ldg(a.creep_rate + i) : 0.0f;
    const float ysi = creep && a.yield_strain ? __ldg(a.yield_strain + i) : 0.0f;
    // springs (s), bonded repulsion (b), damping (d), each summed in slot order
    float sx = 0.0f, sy = 0.0f, bx = 0.0f, by = 0.0f, dx_sum = 0.0f, dy_sum = 0.0f;
    int nout[8];
    float rout[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int nj = nb[s];
      bool bonded = nj >= 0;
      if (SHIFTED && bonded) {
        const int diff = nj - i;
        bool any = false;
        for (int t = 0; t < a.width; ++t) any |= off[s * a.width + t] == diff;
        bonded = any;
      }
      const int j = max(nj, 0);
      const float2 q = __ldg(a.pos + j);
      const float dx = p.x - q.x;
      const float dy = p.y - q.y;
      const float d2 = dx * dx + dy * dy;
      const float dist = sqrtf(d2);
      const float rl = __ldg(rrow + s);
      // forces._springs
      const float inv = dist > 0.0f ? 1.0f / clamp_min(dist, kEps) : 0.0f;
      const float kk = KPP ? (kpi + __ldg(a.k_pp + j)) * a.k_half : a.k;
      const float mag = bonded ? ((-kk) * (dist - rl)) * inv : 0.0f;
      sx = s == 0 ? mag * dx : sx + mag * dx;
      sy = s == 0 ? mag * dy : sy + mag * dy;
      if (SHIFTED) {  // forces.bonded_repulsion_shifted
        const bool hit = bonded && d2 < a.cd2 && d2 > 0.0f;
        const float bm = hit ? rsqrtf(clamp_min(d2, kEps)) * a.repulsion : 0.0f;
        bx = s == 0 ? bm * dx : bx + bm * dx;
        by = s == 0 ? bm * dy : by + bm * dy;
      }
      if (DAMP) {  // forces._damping
        const float2 vj = __ldg(a.gvel0 + j);
        const float dvx = vi.x - vj.x;
        const float dvy = vi.y - vj.y;
        const float inv2 = 1.0f / clamp_min(d2, kEps);
        const float cc = (cpi + __ldg(a.c_pp + j)) * 0.5f;
        const float dm = bonded ? ((-cc) * (dvx * dx + dvy * dy)) * inv2 : 0.0f;
        dx_sum = s == 0 ? dm * dx : dx_sum + dm * dx;
        dy_sum = s == 0 ? dm * dy : dy_sum + dm * dy;
      }
      if (brk) {  // rk4._break at the start positions (this is stage 0)
        const float thr = a.break_scale ? fminf(bsi, __ldg(a.break_scale + j)) * a.threshold
                                        : a.threshold;
        const bool broke = bonded && dist > thr;
        nout[s] = broke ? -1 : nj;
        broken += broke;
      }
      if (creep) {  // forces._creep
        const float c_pair = fminf(cri, __ldg(a.creep_rate + j));
        const float reach =
            a.yield_strain ? rl * (fmaxf(ysi, __ldg(a.yield_strain + j)) + 1.0f) : rl;
        const float excess = clamp_min(dist - reach, 0.0f);
        rout[s] = bonded ? rl + (c_pair * a.h) * excess : rl;
      }
    }
    // rk4.physics_step's F: coll + (springs - bonded [+ damping]); the rows
    // layout's spring_forces_rows: springs [+ damping]
    float fx = SHIFTED ? sx - bx : sx;
    float fy = SHIFTED ? sy - by : sy;
    if (DAMP) {
      fx = fx + dx_sum;
      fy = fy + dy_sum;
    }
    const float2 f = make_float2(c.x + fx, c.y + fy);
    float2 acc = f;
    if (a.weight != 0) {
      acc = a.weight == 2 ? make_float2(prev.x + f.x * 2.0f, prev.y + f.y * 2.0f)
                          : make_float2(prev.x + f.x, prev.y + f.y);
    }
    a.facc_out[r] = acc;
    if (a.next) {  // rk4._advance
      const float2 ac = r_acc(f, vi, gamma_den(vi, m, a.c2), a.c2);
      const float nvx = vi.x + ac.x * a.h_adv;
      const float nvy = vi.y + ac.y * a.h_adv;
      const float2 np = make_float2(p0.x + nvx * a.h_adv, p0.y + nvy * a.h_adv);
      a.next[r] = np;
      if (act) {
        mx = __float_as_uint(fabsf(np.x - p0.x));
        my = __float_as_uint(fabsf(np.y - p0.y));
      }
    }
    if (brk) {
      int4* orow = reinterpret_cast<int4*>(a.nbr_out + static_cast<size_t>(r) * 8);
      orow[0] = make_int4(nout[0], nout[1], nout[2], nout[3]);
      orow[1] = make_int4(nout[4], nout[5], nout[6], nout[7]);
    }
    if (creep) {
      float4* orow = reinterpret_cast<float4*>(a.rest_out + static_cast<size_t>(r) * 8);
      orow[0] = make_float4(rout[0], rout[1], rout[2], rout[3]);
      orow[1] = make_float4(rout[4], rout[5], rout[6], rout[7]);
    }
  }
  // every thread of the block reaches here: the warp, then the block, folds
  // its displacement (non-negative float bits order as unsigned ints) and
  // its broken count before one atomic each
  if (a.nbr_out) {
    broken = __reduce_add_sync(kFull, broken);
    if ((threadIdx.x & 31) == 0 && broken) atomicAdd(a.broken, broken);
  }
  if (a.disp) {
    mx = __reduce_max_sync(kFull, mx);
    my = __reduce_max_sync(kFull, my);
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      dmax[0][w] = mx;
      dmax[1][w] = my;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      unsigned m = 0u;
      for (int k = 0; k < kWarps; ++k) m = max(m, dmax[threadIdx.x][k]);
      if (m) atomicMax(reinterpret_cast<unsigned*>(a.disp) + threadIdx.x, m);
    }
  }
}

__global__ void __launch_bounds__(kThreads) step_finish_kernel(const StepFinishArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.rows) return;
  const float2 p0 = a.pos0[a.row0 + r];
  const float2 v0 = a.vel0[r];
  const float2 ac = r_acc(a.facc[r], v0, gamma_den(v0, a.mass[r], a.c2), a.c2);
  float2 p, v;
  if (a.euler) {  // the old velocity moves the position; no clamp
    p = make_float2(p0.x + v0.x * a.h, p0.y + v0.y * a.h);
    v = make_float2(v0.x + ac.x * a.h, v0.y + ac.y * a.h);
  } else {
    v = make_float2(v0.x + ac.x * a.h6, v0.y + ac.y * a.h6);
    const float speed = sqrtf(v.x * v.x + v.y * v.y);
    if (speed >= 1.0f) {
      const float s = clamp_min(speed, kEps);
      v = make_float2(v.x / s * a.max_speed, v.y / s * a.max_speed);
    }
    p = make_float2(p0.x + v.x * a.h, p0.y + v.y * a.h);
  }
  const bool act = a.active[r];
  a.pos[r] = act ? p : p0;
  a.vel[r] = act ? v : v0;
}

template <bool SHIFTED, bool KPP, bool DAMP>
void launch_stage(const BondStageArgs& a, int blocks, cudaStream_t stream) {
  bond_stage_kernel<SHIFTED, KPP, DAMP><<<blocks, kThreads, 0, stream>>>(a);
}

template <bool SHIFTED, bool KPP>
void launch_stage_damp(const BondStageArgs& a, int blocks, cudaStream_t stream) {
  if (a.c_pp) {
    launch_stage<SHIFTED, KPP, true>(a, blocks, stream);
  } else {
    launch_stage<SHIFTED, KPP, false>(a, blocks, stream);
  }
}

template <bool SHIFTED>
void launch_stage_kpp(const BondStageArgs& a, int blocks, cudaStream_t stream) {
  if (a.k_pp) {
    launch_stage_damp<SHIFTED, true>(a, blocks, stream);
  } else {
    launch_stage_damp<SHIFTED, false>(a, blocks, stream);
  }
}

}  // namespace

extern "C" int step_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(BondStageArgs));
  out[1] = static_cast<int>(sizeof(StepFinishArgs));
  return 0;
}

extern "C" int bond_stage_launch(const BondStageArgs* args, void* stream) {
  const BondStageArgs& a = *args;
  if (a.n < 0 || a.rows < 0 || a.row0 < 0 || a.row0 > a.n || a.rows > a.n - a.row0 ||
      (a.offsets && (a.width < 1 || a.width > kMaxWidth)) || a.weight < 0 || a.weight > 2 ||
      (a.rest_stride != 0 && a.rest_stride != 8) || (a.disp && !a.next) ||
      (a.nbr_out && !a.broken) || (a.rest_out && (!a.creep_rate || a.rest_stride != 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (a.rows + kThreads - 1) / kThreads;
  if (blocks > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a.offsets) {
      launch_stage_kpp<true>(a, blocks, s);
    } else {
      launch_stage_kpp<false>(a, blocks, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int step_finish_launch(const StepFinishArgs* args, void* stream) {
  const StepFinishArgs& a = *args;
  if (a.n < 0 || a.rows < 0 || a.row0 < 0 || a.row0 > a.n || a.rows > a.n - a.row0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (a.rows + kThreads - 1) / kThreads;
  if (blocks > 0) {
    step_finish_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
