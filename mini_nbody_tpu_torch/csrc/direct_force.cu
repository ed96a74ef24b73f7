// K1: ordered all-pairs softened gravity, fp32, one thread per i-body.
// K5: the same kernel with a semi-implicit Euler epilogue (kEuler).
//
// K1 replaces mini_nbody_tpu/ops/pallas_force.py:44 `_direct_kernel`
// (reached through `body_force_pallas`, pallas_force.py:219-300): F_i =
// sum_j d * rsqrt(r2^3) [* m_j], d = p_j - p_i, r2 = |d|^2 + softening.
// K5 replaces pallas_force.py:92 `_fused_euler_kernel` (`euler_step_fused`,
// pallas_force.py:135-212): the force stays in registers and the block
// writes only v' = v + dt F and p' = p + dt v'.
//
// What bounds them on an H100: arithmetic, not memory. Each interaction is
// ~11 fp32 instructions (3 sub, 3 FMA for r2, 2 mul for r2^3, 3 FMA to
// accumulate) plus one rsqrt on the special-function unit, whose rate is an
// eighth of the FMA rate; the j stream is 16 bytes per body per block and
// comes from L2. K5's epilogue is 12 flops and 24 bytes more per body,
// nothing next to the N pairs of each row.
//
// Design (the GPU Gems 3 ch. 31 shape): each block of `block` threads keeps
// its i-bodies in registers and stages the j-bodies through shared memory in
// tiles of `block` (x, y, z, m) float4s, so each j-body is read from global
// memory once per block and from shared memory as a broadcast. The Pallas
// grid's sequential j axis becomes the loop over tiles inside the block, and
// the accumulators stay in registers. The ragged j edge is padded in shared
// memory with (FAR, FAR, FAR, 0): r2^3 of a real body against FAR overflows
// to inf and rsqrtf(inf) = 0 (or rsqrtf(r2)^3 underflows to 0), so pads
// contribute exactly zero in both modes, as the FAR/zero-mass padding does in
// the Pallas kernel. Rows past Ni compute and are not written, and K5's
// epilogue sits inside the same bounds test. K5 is one template flag on K1
// rather than a second file, so its force loop is K1's instruction for
// instruction; its epilogue rounds with __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA, so it rounds as the unfused step's PyTorch
// update does (dt * F, then the add). The output is out of place, as in JAX.
//
// Built without --use_fast_math: rsqrtf is already approximate and
// flush-to-zero or approximate division would widen the gap to the plain
// version. nvcc contracts the mul/add pairs of the force loop into FMAs,
// which the plain PyTorch version does not do; the difference is a rounding
// in the last bit.

#include <cuda_runtime.h>

namespace {

constexpr float kFar = 1.0e18f;

// kEuler: pos_i is pos_j (ni == nj), `out` is pos' and `vel_out` vel'.
template <bool kMass, bool kFast, bool kEuler>
__global__ void direct_force_kernel(const float* __restrict__ pos_i, int ni,
                                    const float* __restrict__ pos_j,
                                    const float* __restrict__ mass_j, int nj,
                                    float* __restrict__ out, float softening,
                                    const float* __restrict__ vel,
                                    float* __restrict__ vel_out, float dt) {
  extern __shared__ float4 sj[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < ni) {
    xi = pos_i[3 * i];
    yi = pos_i[3 * i + 1];
    zi = pos_i[3 * i + 2];
  }
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int base = 0; base < nj; base += blockDim.x) {
    const int j = base + threadIdx.x;
    float4 p = make_float4(kFar, kFar, kFar, 0.f);
    if (j < nj) {
      p.x = pos_j[3 * j];
      p.y = pos_j[3 * j + 1];
      p.z = pos_j[3 * j + 2];
      p.w = kMass ? mass_j[j] : 1.f;
    }
    __syncthreads();  // every thread is done with the previous tile
    sj[threadIdx.x] = p;
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < blockDim.x; ++k) {
      const float4 q = sj[k];
      const float dx = q.x - xi;
      const float dy = q.y - yi;
      const float dz = q.z - zi;
      const float r2 = dx * dx + dy * dy + (dz * dz + softening);
      float w;
      if (kFast) {
        w = rsqrtf((r2 * r2) * r2);
      } else {
        const float inv = rsqrtf(r2);
        w = (inv * inv) * inv;
      }
      if (kMass) w *= q.w;
      fx += dx * w;
      fy += dy * w;
      fz += dz * w;
    }
  }
  if (i < ni) {
    if (kEuler) {
      const float vx = __fadd_rn(vel[3 * i], __fmul_rn(dt, fx));
      const float vy = __fadd_rn(vel[3 * i + 1], __fmul_rn(dt, fy));
      const float vz = __fadd_rn(vel[3 * i + 2], __fmul_rn(dt, fz));
      vel_out[3 * i] = vx;
      vel_out[3 * i + 1] = vy;
      vel_out[3 * i + 2] = vz;
      out[3 * i] = __fadd_rn(xi, __fmul_rn(dt, vx));
      out[3 * i + 1] = __fadd_rn(yi, __fmul_rn(dt, vy));
      out[3 * i + 2] = __fadd_rn(zi, __fmul_rn(dt, vz));
    } else {
      out[3 * i] = fx;
      out[3 * i + 1] = fy;
      out[3 * i + 2] = fz;
    }
  }
}

template <bool kMass, bool kFast, bool kEuler>
void launch(const float* pos_i, int ni, const float* pos_j,
            const float* mass_j, int nj, float* out, float softening,
            const float* vel, float* vel_out, float dt, int block,
            cudaStream_t stream) {
  const int grid = (ni + block - 1) / block;
  direct_force_kernel<kMass, kFast, kEuler>
      <<<grid, block, block * sizeof(float4), stream>>>(
          pos_i, ni, pos_j, mass_j, nj, out, softening, vel, vel_out, dt);
}

template <bool kEuler>
int dispatch(const float* pos_i, int ni, const float* pos_j,
             const float* mass_j, int nj, float* out, float softening,
             const float* vel, float* vel_out, float dt, int fast, int block,
             void* stream) {
  if (block <= 0 || block > 1024 || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ni == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mass_j != nullptr) {
    if (fast)
      launch<true, true, kEuler>(pos_i, ni, pos_j, mass_j, nj, out,
                                 softening, vel, vel_out, dt, block, s);
    else
      launch<true, false, kEuler>(pos_i, ni, pos_j, mass_j, nj, out,
                                  softening, vel, vel_out, dt, block, s);
  } else {
    if (fast)
      launch<false, true, kEuler>(pos_i, ni, pos_j, mass_j, nj, out,
                                  softening, vel, vel_out, dt, block, s);
    else
      launch<false, false, kEuler>(pos_i, ni, pos_j, mass_j, nj, out,
                                   softening, vel, vel_out, dt, block, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. pos_i (ni, 3), pos_j (nj, 3), mass_j (nj,) or NULL for unit masses,
// out (ni, 3): fp32, contiguous, on the current device. block: threads per
// block and j-tile size, a multiple of 32 up to 1024. Returns
// cudaGetLastError() after the launch.
extern "C" int direct_force_launch(const float* pos_i, int ni,
                                   const float* pos_j, const float* mass_j,
                                   int nj, float* out, float softening,
                                   int fast, int block, void* stream) {
  return dispatch<false>(pos_i, ni, pos_j, mass_j, nj, out, softening,
                         nullptr, nullptr, 0.f, fast, block, stream);
}

// K5. pos, vel, pos_out, vel_out (n, 3), mass (n,) or NULL: one fused
// force + semi-implicit Euler step of the self-forces of pos, out of place.
extern "C" int direct_euler_launch(const float* pos, const float* vel,
                                   const float* mass, int n, float* pos_out,
                                   float* vel_out, float softening, float dt,
                                   int fast, int block, void* stream) {
  return dispatch<true>(pos, n, pos, mass, n, pos_out, softening, vel,
                        vel_out, dt, fast, block, stream);
}

extern "C" const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
