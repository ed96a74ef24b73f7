// K4: the softened potential's ordered row sums, fp32, one thread per i-body:
// row_i = sum over j != i of m_j rsqrt(|p_j - p_i|^2 + softening). The
// wrapper forms U = -1/2 sum_i m_i row_i as a PyTorch fp32 sum.
//
// Replaces mini_nbody_tpu/ops/pe_kernel.py:31 `_pe_kernel` (reached through
// `potential_energy_pallas`, pe_kernel.py:71-137) and computes what it
// computes: ordered pairs, the diagonal masked by GLOBAL INDEX, not by
// d2 == 0, so two distinct coincident bodies keep their softening^-1/2
// term (pe_kernel.py:42-50). The pair-once potential is later work.
//
// What bounds it on an H100: arithmetic. Each ordered pair is ~8 fp32
// instructions (3 sub, 3 FMA for r2, 1 FMA to accumulate, a select for the
// diagonal) and one rsqrt on the special-function unit, whose rate is an
// eighth of the FMA rate, so the rsqrt unit and the FMA pipe are close to
// even; the j stream is 16 bytes per body per block from L2.
//
// Design: K1's shape (csrc/direct_force.cu, GPU Gems 3 ch. 31): each block
// keeps its i-bodies in registers and stages the j-bodies through shared
// memory as float4 (x, y, z, m) tiles of blockDim.x. The trap of this
// function is that rsqrt(r2) does NOT underflow at FAR, so FAR padding (the
// force kernels' trick) would add a nonzero term per pad: the ragged j tile
// is padded with (0, 0, 0, mass 0) instead, which adds exactly 0 whatever
// the distance, so the inner loop keeps no bounds test. Rows past n compute
// and are not written.
//
// Built without --use_fast_math (see direct_force.cu).

#include <cuda_runtime.h>

namespace {

template <bool kMass>
__global__ void pe_rows_kernel(const float* __restrict__ pos,
                               const float* __restrict__ mass, int n,
                               float* __restrict__ rows, float softening) {
  extern __shared__ float4 sj[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < n) {
    xi = pos[3 * i];
    yi = pos[3 * i + 1];
    zi = pos[3 * i + 2];
  }
  float acc = 0.f;
  for (int base = 0; base < n; base += blockDim.x) {
    const int j = base + threadIdx.x;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) {
      p.x = pos[3 * j];
      p.y = pos[3 * j + 1];
      p.z = pos[3 * j + 2];
      p.w = kMass ? mass[j] : 1.f;
    }
    __syncthreads();  // every thread is done with the previous tile
    sj[threadIdx.x] = p;
    __syncthreads();
    const int self = i - base;  // this row's own column in the tile, if any
#pragma unroll 8
    for (int k = 0; k < blockDim.x; ++k) {
      const float4 q = sj[k];
      const float dx = q.x - xi;
      const float dy = q.y - yi;
      const float dz = q.z - zi;
      const float r2 = dx * dx + dy * dy + (dz * dz + softening);
      const float inv = k == self ? 0.f : rsqrtf(r2);
      acc += q.w * inv;
    }
  }
  if (i < n) rows[i] = acc;
}

}  // namespace

// pos (n, 3), mass (n,) or NULL for unit masses, rows (n,): fp32,
// contiguous, on the current device. block: threads per block and j-tile
// size, a multiple of 32 up to 1024. Returns cudaGetLastError() after the
// launch.
extern "C" int pe_rows_launch(const float* pos, const float* mass, int n,
                              float* rows, float softening, int block,
                              void* stream) {
  if (block <= 0 || block > 1024 || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + block - 1) / block;
  const size_t smem = block * sizeof(float4);
  if (mass != nullptr)
    pe_rows_kernel<true><<<grid, block, smem, s>>>(pos, mass, n, rows,
                                                   softening);
  else
    pe_rows_kernel<false><<<grid, block, smem, s>>>(pos, mass, n, rows,
                                                    softening);
  return static_cast<int>(cudaGetLastError());
}
