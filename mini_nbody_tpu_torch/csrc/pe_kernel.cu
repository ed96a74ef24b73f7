// K4: the softened potential's ordered row sums, fp32, R rows a thread:
// row_i = sum over j != i of m_j rsqrt(|p_j - p_i|^2 + softening). The
// wrapper forms U = -1/2 sum_i m_i row_i as a PyTorch fp32 sum.
//
// Replaces mini_nbody_tpu/ops/pe_kernel.py:31 `_pe_kernel` (reached through
// `potential_energy_pallas`, pe_kernel.py:71-137) and computes what it
// computes: ordered pairs, the diagonal masked by GLOBAL INDEX, not by
// d2 == 0, so two distinct coincident bodies keep their softening^-1/2
// term (pe_kernel.py:42-50). The pair-once potential is later work.
//
// What bounds it on an H100: the rsqrt unit and the issue rate, close to
// even. A pair is 3 FADD for d, 4 instructions for r2, one MUFU.RSQ and one
// FFMA into the row's sum, plus a shared-memory load per R pairs: ~9
// thread-instructions against the SM's 128 a clock, and one rsqrt against
// the rsqrt unit's 16 a clock (8 instructions' worth). The j stream is 16
// bytes per body per CTA from L2.
//
// Design (K1's, csrc/direct_force.cu): each CTA keeps R * T i-bodies in
// registers, thread t rows i0 + t + T r, and stages the j-bodies through
// shared memory as (x, y, z, m) float4 tiles of R * T, two deep (the next
// tile read into registers while this one computes), so one broadcast load
// serves R pairs; every row adds its terms in j order into one running sum,
// so the bits do not depend on R or the tile. The j tile and the CTA's rows
// have one size, so only the CTA's own tile holds the diagonal: that tile
// runs the body with the global-index select, every other tile a body with
// no index compare. rsqrt is rsqrt.approx.ftz (slot_body.cuh rsqrt_normal,
// no denormal rescaling) when softening >= FLT_MIN, since r2 >= softening;
// below it the host picks the rsqrtf instantiation. The trap of this
// function is that rsqrt(r2) does NOT underflow at FAR, so FAR padding (the
// force kernels' trick) would add a nonzero term per pad: the ragged j tile
// is padded with (0, 0, 0, mass 0) instead, which adds exactly 0 whatever
// the distance, so the inner loop keeps no bounds test. Rows past n compute
// and are not written.
//
// Built without --use_fast_math (see direct_force.cu).

#include <cfloat>

#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

// The pairs of U staged sources (k0 .. k0 + U - 1) with the R rows, each
// source one broadcast load, each row's sum in k order. kDiag: the tile is
// the CTA's own rows, so row r selects 0 for the rsqrt of column
// threadIdx.x + T r (its own index).
template <int R, int U, bool kNormal, bool kDiag>
__device__ __forceinline__ void pe_group(const float4* __restrict__ sj,
                                         int k0, const float (&xi)[R],
                                         const float (&yi)[R],
                                         const float (&zi)[R],
                                         float (&acc)[R], float softening) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 q = sj[k0 + u];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dx = q.x - xi[r];
      const float dy = q.y - yi[r];
      const float dz = q.z - zi[r];
      const float r2 = dx * dx + dy * dy + (dz * dz + softening);
      const float inv =
          kDiag && k0 + u == static_cast<int>(threadIdx.x + r * blockDim.x)
              ? 0.f
              : (kNormal ? slot_body::rsqrt_normal(r2) : rsqrtf(r2));
      acc[r] += q.w * inv;
    }
  }
}

// This thread's R sources of the j tile at `base`, (x, y, z, m) or the
// (0, 0, 0, 0) pad past n: entries t + T q of the tile, q < R.
template <int R>
__device__ __forceinline__ void load_sources(const float* __restrict__ pos,
                                             const float* __restrict__ mass,
                                             int n, int base,
                                             float4 (&p)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = base + threadIdx.x + q * blockDim.x;
    p[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n)
      p[q] = make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                         mass != nullptr ? mass[j] : 1.f);
  }
}

// blockDim.x = T threads, R * T rows a CTA and j tile; two tiles of shared
// memory, the next one's sources read into registers while this one
// computes.
template <int R, bool kNormal>
__global__ void __launch_bounds__(1024 / R)
    pe_rows_kernel(const float* __restrict__ pos,
                   const float* __restrict__ mass, int n,
                   float* __restrict__ rows, float softening) {
  constexpr int U = 8 / R;  // sources a pair group
  extern __shared__ float4 smem[];
  const int threads = blockDim.x, tile = R * threads;
  const int c0 = blockIdx.x * tile;
  float xi[R], yi[R], zi[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = c0 + threadIdx.x + r * threads;
    xi[r] = yi[r] = zi[r] = 0.f;
    if (i < n) {
      xi[r] = pos[3 * i];
      yi[r] = pos[3 * i + 1];
      zi[r] = pos[3 * i + 2];
    }
    acc[r] = 0.f;
  }
  float4 next[R];
  load_sources<R>(pos, mass, n, 0, next);
  for (int base = 0, t = 0; base < n; base += tile, ++t) {
    float4* sj = smem + (t & 1) * tile;
#pragma unroll
    for (int q = 0; q < R; ++q) sj[threadIdx.x + q * threads] = next[q];
    // The tile is staged, and every thread is done with the tile before
    // last, this buffer's previous use.
    __syncthreads();
    if (base + tile < n) load_sources<R>(pos, mass, n, base + tile, next);
    if (base == c0) {
#pragma unroll 1
      for (int k = 0; k < tile; k += U)
        pe_group<R, U, kNormal, true>(sj, k, xi, yi, zi, acc, softening);
    } else {
#pragma unroll 1
      for (int k = 0; k < tile; k += U)
        pe_group<R, U, kNormal, false>(sj, k, xi, yi, zi, acc, softening);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = c0 + threadIdx.x + r * threads;
    if (i < n) rows[i] = acc[r];
  }
}

using Kernel = void (*)(const float*, const float*, int, float*, float);

// K4's kernel of (r, normal) and its threads per CTA for `rows` rows a
// CTA, or nullptr: r in {1, 2, 4}, rows a multiple of 32 r up to 1024.
Kernel pick(int r, int rows, bool normal, int* threads) {
  if ((r != 1 && r != 2 && r != 4) || rows <= 0 || rows > 1024 ||
      rows % (32 * r) != 0)
    return nullptr;
  *threads = rows / r;
  if (r == 4)
    return normal ? pe_rows_kernel<4, true> : pe_rows_kernel<4, false>;
  if (r == 2)
    return normal ? pe_rows_kernel<2, true> : pe_rows_kernel<2, false>;
  return normal ? pe_rows_kernel<1, true> : pe_rows_kernel<1, false>;
}

}  // namespace

// pos (n, 3), mass (n,) or NULL for unit masses, rows (n,): fp32,
// contiguous, on the current device. normal: rsqrt.approx.ftz, refused
// unless softening >= FLT_MIN (else rsqrtf); r rows a thread, rows a CTA
// and j tile (a multiple of 32 r up to 1024). Returns cudaGetLastError()
// after the launch.
extern "C" int pe_rows_launch(const float* pos, const float* mass, int n,
                              float* rows, float softening, int normal,
                              int r, int rows_per_cta, void* stream) {
  int threads = 0;
  const Kernel kernel = pick(r, rows_per_cta, normal != 0, &threads);
  if (kernel == nullptr || (normal != 0 && !(softening >= FLT_MIN)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  kernel<<<(n + rows_per_cta - 1) / rows_per_cta, threads,
           2 * rows_per_cta * sizeof(float4),
           static_cast<cudaStream_t>(stream)>>>(
      pos, mass, n, rows, softening);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers per thread, local bytes per thread, CTAs per SM and
// threads per CTA of K4's kernel at (r, rows, normal).
extern "C" int pe_rows_info(int r, int rows_per_cta, int normal, int* out) {
  int threads = 0;
  const void* kernel = reinterpret_cast<const void*>(
      pick(r, rows_per_cta, normal != 0, &threads));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, threads, 2 * rows_per_cta * sizeof(float4));
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = threads;
  return static_cast<int>(err);
}
