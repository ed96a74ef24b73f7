// K1: ordered all-pairs softened gravity, fp32, R rows a thread.
// K5: the same kernel with a semi-implicit Euler epilogue (kEuler).
//
// K1 replaces mini_nbody_tpu/ops/pallas_force.py:44 `_direct_kernel`
// (reached through `body_force_pallas`, pallas_force.py:219-300): F_i =
// sum_j d * rsqrt(r2^3) [* m_j], d = p_j - p_i, r2 = |d|^2 + softening.
// K5 replaces pallas_force.py:92 `_fused_euler_kernel` (`euler_step_fused`,
// pallas_force.py:135-212): the force stays in registers and the block
// writes only v' = v + dt F and p' = p + dt v'.
//
// What bounds them on an H100: the issue rate, not memory. A pair is 3 FADD
// for d, 4 instructions for r2 (FMUL, two FFMA, FADD), 2 FMUL for r2^3 (the
// fast form), one MUFU.RSQ, one FMUL for the mass and 3 FFMA into the sums:
// 13-14 thread-instructions against the SM's 128 a clock, while the rsqrt
// unit's 16 a clock would allow 8 instructions a pair. The j stream is 16
// bytes per body per CTA from L2. K5's epilogue is 12 flops and 24 bytes
// more per body, nothing next to the N pairs of each row.
//
// Design (B10's shape, csrc/vjp_kernel.cu): each CTA keeps R * T
// i-bodies in registers, thread t rows i0 + t + T r (r < R), and stages
// the j-bodies through shared memory in tiles of R * T (x, y, z, m) float4s,
// two tiles deep: the next tile's sources are read into registers while the
// current one computes, so one barrier a tile and no exposed L2 latency.
// One broadcast load of a source then serves R pairs, and the R rows' sums
// are independent chains for the scheduler. The Pallas grid's sequential j
// axis is the loop over tiles, and every row adds its terms in j order,
// 0, 1, ..., nj - 1, into one running sum: no per-tile partials, so the bits
// are the same at every R and tile, and the same as a one-row-a-thread
// kernel's. The host (ops/direct_force.py row_schedule) picks R from the
// rows: a thread takes more rows only while the grid keeps ~32 warps an SM,
// since at fewer warps the rsqrt's latency shows (at 65,536 rows, R = 2
// took 19% longer than R = 1, R = 4 2.6 times as long).
//
// rsqrt is rsqrt.approx.ftz (slot_body.cuh rsqrt_normal) wherever its input
// is provably normal or +inf, which drops rsqrtf's denormal rescaling (an
// FSETP and two predicated FMULs a pair): r2^3 >= 1e-36 under
// fast_rsqrt_cube, and r2 >= softening >= FLT_MIN in the other mode. Below
// FLT_MIN the host picks the rsqrtf instantiation. On normal inputs the two
// give the same bits.
//
// The ragged j edge is padded in shared memory with (FAR, FAR, FAR, 0):
// r2^3 of a real body against FAR overflows to inf and the rsqrt of inf is
// 0 (or rsqrt(r2)^3 underflows to 0), so pads add exactly zero in every
// form, as the FAR/zero-mass padding does in the Pallas kernel. Rows past
// Ni compute and are not written, and K5's epilogue sits inside the same
// bounds test. K5 is one template flag on K1, so its force loop is K1's
// instruction for instruction; its epilogue rounds with __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA, so it rounds as the
// unfused step's PyTorch update does (dt * F, then the add). The output is
// out of place, as in JAX.
//
// Built without --use_fast_math: flush-to-zero arithmetic or approximate
// division would widen the gap to the plain version. nvcc contracts the
// mul/add pairs of the force loop into FMAs, which the plain PyTorch version
// does not do; the difference is a rounding in the last bit.

#include <cfloat>

#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

constexpr float kFar = 1.0e18f;

// The rsqrt forms (ops/direct_force.py rsqrt_form).
constexpr int kFormRsqrtf = 0;  // rsqrtf(r2)^3: softening < FLT_MIN
constexpr int kFormNormal = 1;  // rsqrt_normal(r2)^3: softening >= FLT_MIN
constexpr int kFormCube = 2;    // rsqrt_normal(r2^3): fast_rsqrt_cube

template <int kForm>
__device__ __forceinline__ float pair_weight(float r2) {
  if (kForm == kFormCube) return slot_body::rsqrt_normal((r2 * r2) * r2);
  const float inv =
      kForm == kFormNormal ? slot_body::rsqrt_normal(r2) : rsqrtf(r2);
  return (inv * inv) * inv;
}

// The pairs of U staged sources (k0 .. k0 + U - 1) with the R rows, each
// source one broadcast load, each row's sums in k order.
template <int R, int U, bool kMass, int kForm>
__device__ __forceinline__ void pair_group(
    const float4* __restrict__ sj, int k0, const float (&xi)[R],
    const float (&yi)[R], const float (&zi)[R], float (&fx)[R],
    float (&fy)[R], float (&fz)[R], float softening) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 q = sj[k0 + u];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dx = q.x - xi[r];
      const float dy = q.y - yi[r];
      const float dz = q.z - zi[r];
      const float r2 = dx * dx + dy * dy + (dz * dz + softening);
      float w = pair_weight<kForm>(r2);
      if (kMass) w *= q.w;
      fx[r] += dx * w;
      fy[r] += dy * w;
      fz[r] += dz * w;
    }
  }
}

// This thread's R sources of the j tile at `base`, (x, y, z, m) or the
// (FAR, FAR, FAR, 0) pad past nj: entries t + T q of the tile, q < R.
template <int R, bool kMass>
__device__ __forceinline__ void load_sources(
    const float* __restrict__ pos_j, const float* __restrict__ mass_j,
    int nj, int base, float4 (&p)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = base + threadIdx.x + q * blockDim.x;
    p[q] = make_float4(kFar, kFar, kFar, 0.f);
    if (j < nj)
      p[q] = make_float4(pos_j[3 * j], pos_j[3 * j + 1], pos_j[3 * j + 2],
                         kMass ? mass_j[j] : 1.f);
  }
}

// kEuler: pos_i is pos_j (ni == nj), `out` is pos' and `vel_out` vel'.
// blockDim.x = T threads, R * T rows a CTA and j tile; two tiles of shared
// memory, the next one's sources read into registers while this one
// computes.
template <int R, bool kMass, int kForm, bool kEuler>
__global__ void __launch_bounds__(1024 / R)
    direct_force_kernel(const float* __restrict__ pos_i, int ni,
                        const float* __restrict__ pos_j,
                        const float* __restrict__ mass_j, int nj,
                        float* __restrict__ out, float softening,
                        const float* __restrict__ vel,
                        float* __restrict__ vel_out, float dt) {
  constexpr int U = 8 / R;  // sources a pair group
  extern __shared__ float4 smem[];
  const int threads = blockDim.x, tile = R * threads;
  const int i0 = blockIdx.x * tile + threadIdx.x;
  float xi[R], yi[R], zi[R], fx[R], fy[R], fz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * threads;
    xi[r] = yi[r] = zi[r] = 0.f;
    if (i < ni) {
      xi[r] = pos_i[3 * i];
      yi[r] = pos_i[3 * i + 1];
      zi[r] = pos_i[3 * i + 2];
    }
    fx[r] = fy[r] = fz[r] = 0.f;
  }
  float4 next[R];
  load_sources<R, kMass>(pos_j, mass_j, nj, 0, next);
  for (int base = 0, t = 0; base < nj; base += tile, ++t) {
    float4* sj = smem + (t & 1) * tile;
#pragma unroll
    for (int q = 0; q < R; ++q) sj[threadIdx.x + q * threads] = next[q];
    // The tile is staged, and every thread is done with the tile before
    // last, this buffer's previous use.
    __syncthreads();
    if (base + tile < nj)
      load_sources<R, kMass>(pos_j, mass_j, nj, base + tile, next);
#pragma unroll 1
    for (int k = 0; k < tile; k += U)
      pair_group<R, U, kMass, kForm>(sj, k, xi, yi, zi, fx, fy, fz,
                                     softening);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * threads;
    if (i >= ni) continue;
    if (kEuler) {
      const float vx = __fadd_rn(vel[3 * i], __fmul_rn(dt, fx[r]));
      const float vy = __fadd_rn(vel[3 * i + 1], __fmul_rn(dt, fy[r]));
      const float vz = __fadd_rn(vel[3 * i + 2], __fmul_rn(dt, fz[r]));
      vel_out[3 * i] = vx;
      vel_out[3 * i + 1] = vy;
      vel_out[3 * i + 2] = vz;
      out[3 * i] = __fadd_rn(xi[r], __fmul_rn(dt, vx));
      out[3 * i + 1] = __fadd_rn(yi[r], __fmul_rn(dt, vy));
      out[3 * i + 2] = __fadd_rn(zi[r], __fmul_rn(dt, vz));
    } else {
      out[3 * i] = fx[r];
      out[3 * i + 1] = fy[r];
      out[3 * i + 2] = fz[r];
    }
  }
}

using Kernel = void (*)(const float*, int, const float*, const float*, int,
                        float*, float, const float*, float*, float);

template <int R, bool kEuler>
Kernel pick_form(bool masses, int form) {
  switch (form) {
    case kFormCube:
      return masses ? direct_force_kernel<R, true, kFormCube, kEuler>
                    : direct_force_kernel<R, false, kFormCube, kEuler>;
    case kFormNormal:
      return masses ? direct_force_kernel<R, true, kFormNormal, kEuler>
                    : direct_force_kernel<R, false, kFormNormal, kEuler>;
    case kFormRsqrtf:
      return masses ? direct_force_kernel<R, true, kFormRsqrtf, kEuler>
                    : direct_force_kernel<R, false, kFormRsqrtf, kEuler>;
  }
  return nullptr;
}

// The kernel of (r, masses, form, euler) and its threads per CTA for
// `rows` rows a CTA, or nullptr: r in {1, 2, 4}, rows a multiple of 32 r up
// to 1024.
Kernel pick(int r, int rows, bool masses, int form, bool euler,
            int* threads) {
  if ((r != 1 && r != 2 && r != 4) || rows <= 0 || rows > 1024 ||
      rows % (32 * r) != 0)
    return nullptr;
  *threads = rows / r;
  if (euler) {
    if (r == 4) return pick_form<4, true>(masses, form);
    if (r == 2) return pick_form<2, true>(masses, form);
    return pick_form<1, true>(masses, form);
  }
  if (r == 4) return pick_form<4, false>(masses, form);
  if (r == 2) return pick_form<2, false>(masses, form);
  return pick_form<1, false>(masses, form);
}

// Whether `form` is exact at `softening`: rsqrt_normal needs every r2
// (>= softening) or r2^3 (>= the fp32 softening^3) normal or +inf.
bool form_holds(int form, float softening) {
  if (form == kFormCube)
    return (softening * softening) * softening >= FLT_MIN;
  if (form == kFormNormal) return softening >= FLT_MIN;
  return form == kFormRsqrtf;
}

int launch(const float* pos_i, int ni, const float* pos_j,
           const float* mass_j, int nj, float* out, float softening,
           const float* vel, float* vel_out, float dt, int form, int r,
           int rows, bool euler, void* stream) {
  int threads = 0;
  const Kernel kernel =
      pick(r, rows, mass_j != nullptr, form, euler, &threads);
  if (kernel == nullptr || !form_holds(form, softening))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ni == 0) return 0;
  kernel<<<(ni + rows - 1) / rows, threads, 2 * rows * sizeof(float4),
           static_cast<cudaStream_t>(stream)>>>(
      pos_i, ni, pos_j, mass_j, nj, out, softening, vel, vel_out, dt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. pos_i (ni, 3), pos_j (nj, 3), mass_j (nj,) or NULL for unit masses,
// out (ni, 3): fp32, contiguous, on the current device. form: the rsqrt
// form (0 rsqrtf, 1 rsqrt_normal of r2, 2 of r2^3; refused where it does
// not hold at softening); r rows a thread, rows a CTA and j tile (a
// multiple of 32 r up to 1024). Returns cudaGetLastError() after the
// launch.
extern "C" int direct_force_launch(const float* pos_i, int ni,
                                   const float* pos_j, const float* mass_j,
                                   int nj, float* out, float softening,
                                   int form, int r, int rows, void* stream) {
  return launch(pos_i, ni, pos_j, mass_j, nj, out, softening, nullptr,
                nullptr, 0.f, form, r, rows, false, stream);
}

// K5. pos, vel, pos_out, vel_out (n, 3), mass (n,) or NULL: one fused
// force + semi-implicit Euler step of the self-forces of pos, out of place.
extern "C" int direct_euler_launch(const float* pos, const float* vel,
                                   const float* mass, int n, float* pos_out,
                                   float* vel_out, float softening, float dt,
                                   int form, int r, int rows, void* stream) {
  return launch(pos, n, pos, mass, n, pos_out, softening, vel, vel_out, dt,
                form, r, rows, true, stream);
}

// out[4]: registers per thread, local bytes per thread, CTAs per SM and
// threads per CTA of K1's (euler 0) or K5's (euler 1) kernel at (r, rows,
// masses, form).
extern "C" int direct_force_info(int r, int rows, int masses, int form,
                                 int euler, int* out) {
  int threads = 0;
  const void* kernel = reinterpret_cast<const void*>(
      pick(r, rows, masses != 0, form, euler != 0, &threads));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, threads, 2 * rows * sizeof(float4));
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = threads;
  return static_cast<int>(err);
}

extern "C" const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
