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
// ops/slot_pipe.py tri_slot_list), not the TPU band. A CTA of (T/8)^2
// threads computes one slot (kind, bi, bj) of a device int32 (S, 3) list at
// a time; rows are block bi of chunk a, columns block bj of chunk b:
//   DIAG  (bi == bj): row sums only; the T x T diagonal block's rows
//         already cover both orders of each pair (adding its column sums
//         would count every pair twice). d = 0 on the diagonal gives 0.
//   CROSS: rows to block bi (side a), reactions to block bj (side b).
//   FOLD  (bj == bi + 1, tri mode): entry (r, c) is pair (a_r, a_c) for
//         c < r and (b_r, b_c) for c > r; each side's rows and reactions go
//         to its own block. Fold slots are nb/2 of ~nb^2/2, so their
//         two full-tile passes cost nothing measurable.
// The wrapper keeps the chunk loop (at N = 2^20 and chunk 131072: 8 tri + 28
// cross launches per pass) rather than one slot table over all N, which at
// T = 128 would hold ~33.6 M slots (~400 MB of int32 triples).
//
// What bounds it on an H100: fp32 arithmetic. Per unordered pair: 3 subtracts
// for d, 4 operations for r2, 2 multiplies and one rsqrt on the
// special-function unit for w, 3 fused multiply-adds for each side's sum
// (and one multiply each by the partner's mass): ~15-17 fp32 instructions
// at 128 lanes per clock per SM, against one rsqrt at 16 (PERF.md §6).
//
// Design (the slot body is slot_body::fp32_compute in csrc/slot_body.cuh, which
// B15 shares): stage block bi and block bj (x, y, z[, m]) in shared memory as
// one float4 per body, then each of the CTA's (T/8)^2 threads computes an 8 x 8
// register micro-tile of pairs (rows ty + G i, columns tx + G j, G = T / 8):
// its rows stay in registers, each column is one broadcast load per 8 pairs,
// and w, d and both sides' sums never leave registers. After the walk the row
// sums of the G lanes that share a row, and the column sums of the lanes and
// warps that share a column, are added in a fixed order: a halving exchange of
// shuffles inside each warp, then the warps' column partials through shared
// memory in increasing warp index. At T = 128 the CTA takes 256 threads and
// 17,920 bytes of shared memory. The grid holds as many CTAs as the card runs
// at once (slot_body::stream_width); each walks its slots and loads the next
// slot's blocks into registers while it computes one.
//
// Cross-block sums: the TPU carries the whole-chunk reaction buffer across
// its sequential grid; CTAs here run in no order, so each CTA stores its two
// T x 3 partials (side 0: block bi, side 1: block bj) to the slot's scratch
// tiles and csrc/slot_reduce.cu adds each block's partials in slot order:
// every output bit is the same on every run. A FOLD slot runs two passes
// over the full tile, one per side with w zeroed off its triangle, and
// stores rows - reactions for each side.
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
// and system. Each CTA walks its slots (slot_body::walk_slots) on the slot
// body's fp32 stage and compute, which B15 shares.
template <int T, int K, bool kFast>
__global__ void __launch_bounds__(
    slot_body::fp32_threads<T>(),
    slot_body::stream_min_ctas(slot_body::fp32_threads<T>(),
                               slot_body::kFp32Warps))
    symmetric_force_kernel(const int* __restrict__ slots, int n_slots,
                           const float* __restrict__ pos_a,
                           const float* __restrict__ pos_b, float* part,
                           long long sys_rows, float softening) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.y;
  pos_a += sys * sys_rows * K;
  pos_b += sys * sys_rows * K;
  slot_body::Fp32Stage<T, K> stage;
  slot_body::walk_slots(
      slots, n_slots,
      [&](const slot_body::Slot& sl) {
        stage.load(sl.bi, sl.bj, pos_a, pos_b);
      },
      [&] { stage.store(smem); },
      [&](const slot_body::Slot& sl, int s) {
        // Side 0's tile (block bi), then side 1's (block bj).
        float* out = part + (sys * n_slots + s) * 2 * T * 3;
        slot_body::fp32_compute<T, K, kFast>(sl.kind, out, softening, smem);
      });
}

template <int T, int K, bool kFast>
int launch(const int* slots, int n_slots, int n_sys, long long sys_rows,
           const float* pos_a, const float* pos_b, float* part,
           float softening, cudaStream_t stream) {
  auto kernel = symmetric_force_kernel<T, K, kFast>;
  constexpr int threads = slot_body::fp32_threads<T>();
  constexpr size_t smem = slot_body::fp32_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int width = 0;
  err = slot_body::stream_width(kernel, threads, smem, n_slots, n_sys,
                                &width);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(width, n_sys), threads, smem, stream>>>(
      slots, n_slots, pos_a, pos_b, part, sys_rows, softening);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local memory bytes per thread (spills) and CTAs per
// SM of one instantiation, at its launch's shared memory.
template <int T, int K, bool kFast>
int info(int* out) {
  auto kernel = symmetric_force_kernel<T, K, kFast>;
  constexpr size_t smem = slot_body::fp32_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, slot_body::fp32_threads<T>(), smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
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

// out[3]: registers per thread, local bytes per thread and CTAs per SM of
// the kernel symmetric_force_launch runs for (k, tile, fast).
extern "C" int symmetric_force_info(int k, int tile, int fast, int* out) {
#define NBODY_SYM_INFO(T)                                   \
  if (k == 3 && fast) return info<T, 3, true>(out);         \
  if (k == 3) return info<T, 3, false>(out);                \
  if (k == 4 && fast) return info<T, 4, true>(out);         \
  if (k == 4) return info<T, 4, false>(out);
  if (tile == 64) { NBODY_SYM_INFO(64) }
  if (tile == 128) { NBODY_SYM_INFO(128) }
#undef NBODY_SYM_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}
