// K3: fp32 pair-once force, each unordered pair's weight w computed once and
// scattered to both bodies: rows F_i += sum_j d w (m_j), reactions
// F_j -= sum_i d w (m_i), with d = p_j - p_i, r2 = |d|^2 + softening and
// w = rsqrt(r2^3) when fast_rsqrt_cube(softening) holds, else rsqrt(r2)^3.
//
// Replaces both Pallas kernels of mini_nbody_tpu/ops/symmetric_force.py:
//   :107 `_tri_kernel`   (self chunk, band traversal)      -> "tri mode"
//   :155 `_cross_kernel` (chunk pair a != b, and body_force_pair at :635)
//                                                          -> "cross mode"
// The two modes are one kernel over a slot list; they differ only in the
// list and the base pointers the wrapper passes (tri: pos_a == pos_b, one
// accumulator).
//
// Geometry: the slot + fold geometry of K2 (csrc/slot_pipe.cu,
// ops/slot_pipe.py tri_slot_list), not the TPU band. One CTA of 2T threads
// per slot (kind, bi, bj) from a device int32 (S, 3) list; rows are block bi
// of chunk a, columns block bj of chunk b:
//   DIAG  (bi == bj): row sums only; the T x T diagonal block's rows
//         already cover both orders of each pair (adding its column sums
//         would count every pair twice). d = 0 on the diagonal gives 0.
//   CROSS: rows to block bi (side a), reactions to block bj (side b).
//   FOLD  (bj == bi + 1, tri mode): entry (r, c) is pair (a_r, a_c) for
//         c < r and (b_r, b_c) for c > r; each side's rows and reactions go
//         to its own block. Fold slots are nb/2 of ~nb^2/2, so their
//         divergent split loops cost nothing measurable.
// The wrapper keeps the chunk loop (at N = 2^20 and chunk 131072: 8 tri + 28
// cross launches per pass) rather than one slot table over all N, which at
// T = 128 would hold ~33.6 M slots (~400 MB of int32 triples).
//
// What bounds it on an H100: fp32 arithmetic. Per unordered pair: ~11 flops
// and one rsqrt on the special-function unit for w, then 6 flops (7 with a
// mass) for each side's sum with d recomputed from the staged positions, as
// JAX's mass mode recomputes it (symmetric_force.py:77-92). Shared memory
// carries one 4-byte store and two 4-byte loads per pair.
//
// Design (simple first; the slot body is slot_body::fp32_slot in
// csrc/slot_body.cuh, which B15 shares): stage block bi and block bj (x, y,
// z[, m]) in shared
// memory, compute the T x T w tile once into shared memory (rows padded to
// T + 1 floats, so both the row pass, one thread per row, and the column
// pass, one thread per column, read it without bank conflicts), then run the
// row pass on threads [0, T) and the column pass on threads [T, 2T) at the
// same time. At T = 128 the tile and the positions take 70,144 bytes, above
// the 48 KB default, so the launch raises the dynamic shared-memory limit
// first and returns cudaGetLastError(); a refused launch never runs.
//
// Cross-block sums: the TPU carries the whole-chunk reaction buffer across
// its sequential grid; CTAs here run in no order, so each CTA stores its two
// T x 3 partials (side 0: block bi, side 1: block bj) to the slot's scratch
// tiles and csrc/slot_reduce.cu adds each block's partials in slot order:
// every output bit is the same on every run. A FOLD slot's row and column
// sums meet in one tile per side: the row pass stores, and after a barrier
// the column pass adds its (negated) sums to the same elements.
//
// Systems: blockIdx.y is the system of an ensemble launch (B9b, the tri mode
// of mini_nbody_tpu/ops/symmetric_force.py:488 `_build_tri_ensemble` with a
// system axis, on the slot list instead of the band). Every system runs the
// same system-local slot list over its own rows, sys_rows rows after the
// previous system's; a standalone call is the same kernel with one system.
// gridDim.y is at most 65,535.
//
// Padding: FAR tails. A real body against a FAR pad gets w = 0 exactly
// (r2^3 overflows and rsqrtf(inf) = 0, or rsqrtf(r2)^3 underflows), and a
// pad-vs-pad pair has d = 0, so pads add exactly zero; mass mode also pads
// with zero mass (symmetric_force.py:211-221). The TPU's 896 mass-mode tile
// cap and 128-lane alignment are VMEM rules and are not carried over.
//
// Built without --use_fast_math (see direct_force.cu); nvcc contracts the
// mul/add pairs into FMAs, which the plain PyTorch version does not do.

#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

// pos_a / pos_b: (c, K) rows (x, y, z[, m]); part: 2 (T, 3) tiles per slot
// and system. The slot body is slot_body::fp32_slot, which B15 shares.
template <int T, int K, bool kFast>
__global__ void __launch_bounds__(2 * T)
    symmetric_force_kernel(const int* __restrict__ slots,
                           const float* __restrict__ pos_a,
                           const float* __restrict__ pos_b, float* part,
                           long long sys_rows, float softening) {
  extern __shared__ float smem[];
  const int kind = slots[3 * blockIdx.x];
  const int bi = slots[3 * blockIdx.x + 1];
  const int bj = slots[3 * blockIdx.x + 2];
  const long long sys = blockIdx.y;
  // Side 0's tile (block bi), then side 1's (block bj).
  float* out = part + (sys * gridDim.x + blockIdx.x) * 2 * T * 3;
  slot_body::fp32_slot<T, K, kFast, false>(
      kind, bi, bj, pos_a + sys * sys_rows * K, pos_b + sys * sys_rows * K,
      out, softening, 0, smem);
}

template <int T, int K, bool kFast>
int launch(const int* slots, int n_slots, int n_sys, long long sys_rows,
           const float* pos_a, const float* pos_b, float* part,
           float softening, cudaStream_t stream) {
  constexpr size_t smem = slot_body::fp32_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      symmetric_force_kernel<T, K, kFast>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  symmetric_force_kernel<T, K, kFast>
      <<<dim3(n_slots, n_sys), 2 * T, smem, stream>>>(
          slots, pos_a, pos_b, part, sys_rows, softening);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int dispatch(const int* slots, int n_slots, int n_sys, long long sys_rows,
             const float* pos_a, const float* pos_b, float* part, int k,
             float softening, int fast, cudaStream_t s) {
#define NBODY_SYM_LAUNCH(K, FAST)                                        \
  launch<T, K, FAST>(slots, n_slots, n_sys, sys_rows, pos_a, pos_b, part, \
                     softening, s)
  if (k == 3 && fast) return NBODY_SYM_LAUNCH(3, true);
  if (k == 3) return NBODY_SYM_LAUNCH(3, false);
  if (k == 4 && fast) return NBODY_SYM_LAUNCH(4, true);
  if (k == 4) return NBODY_SYM_LAUNCH(4, false);
#undef NBODY_SYM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// slots (n_slots, 3) int32 (kind, bi, bj); pos_a / pos_b (rows, k) fp32 with
// k = 3 (unit masses) or 4 (x, y, z, m), rows a multiple of tile; n_sys
// systems of such rows, sys_rows rows apart (tri mode; 1 system in cross
// mode); all contiguous on the current device. part: n_sys x n_slots x 2
// tiles of (tile, 3) fp32, written (side 0 of slot s: block bi's sums; side
// 1: block bj's; a DIAG slot writes side 0 only) for slot_reduce_launch.
// tile: 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int symmetric_force_launch(const int* slots, int n_slots,
                                      int n_sys, long long sys_rows,
                                      const float* pos_a, const float* pos_b,
                                      float* part, int k, int tile,
                                      float softening, int fast,
                                      void* stream) {
  if (n_slots == 0 || n_sys == 0) return 0;
  if (n_sys > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64)
    return dispatch<64>(slots, n_slots, n_sys, sys_rows, pos_a, pos_b, part,
                        k, softening, fast, s);
  if (tile == 128)
    return dispatch<128>(slots, n_slots, n_sys, sys_rows, pos_a, pos_b,
                         part, k, softening, fast, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
