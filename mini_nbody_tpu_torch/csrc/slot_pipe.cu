// K2: pair-once sym_mxu slot kernel: the pair weight w once per unordered
// pair in fp32, the row and reaction sums as bf16 tensor-core products with
// fp32 accumulation.
//
// Replaces both Pallas slot kernels of mini_nbody_tpu/ops/slot_pipe.py:
//   :165 `_tri_slot_kernel`   (build_tri_slot_call, self chunk, DIAG /
//                              CROSS / FOLD slots)        -> "tri mode"
//   :210 `_cross_pair_kernel` (build_cross_slot_call, chunk pair a != b,
//                              CROSS slots only)          -> "cross mode"
// and, in cross mode over a rectangle of two disjoint sets of different
// lengths, mini_nbody_tpu/ops/sym_mxu_force.py:267 `_cross_kernel` as
// `body_force_pair_mxu` calls it (:734 `_pair_call`)     -> B4.
// The modes are the same kernel; they differ only in the base pointers and
// the slot list the wrapper passes (tri: pos_a == pos_b, v_a == v_b, one
// accumulator). Side a is indexed by the slot's bi and side b by its bj
// alone, so the two sides may hold different numbers of blocks.
//
// A CTA of T threads computes one slot (kind, bi, bj) of a device int32
// (S, 3) slot list at a time. Rows index block bi of chunk a, columns block
// bj of chunk b:
//   DIAG  (bi == bj): w masked where d2 == 0 (self pairs) -> acc_a[bi] +=
//         W @ v_b[bj] (rows cover both pair orders).
//   CROSS: w masked where d2 == 0 iff mask_offdiag -> acc_a[bi] += W @
//         v_b[bj], acc_b[bj] += W^T @ v_a[bi].
//   FOLD  (bj == bi + 1, tri mode): entry (r, c) is pair (a_r, a_c) where
//         c < r (W_lo) and (b_r, b_c) where c > r (W_hi);
//         c == r is always masked, d2 == 0 iff mask_offdiag (the geometry of
//         slot_pipe.py:125-157) -> acc_a[bi] += W_lo @ v_a + W_lo^T @ v_a,
//         acc_b[bj] += W_hi @ v_b + W_hi^T @ v_b.
// v = [vhi | vlo] (T, 8) is the compensated operand split built by the
// wrapper; the kernel rounds it to bf16 as the MXU does (vhi is exact).
//
// What bounds it on an H100: the fp32 w pipeline, ~12 fp32 instructions
// and one rsqrt on the special-function unit per pair (16 results per clock
// per SM: ~131 ms of rsqrt per N = 2^20 pass). The tensor-core products are
// tiny (N = 8): ~6% of that.
//
// Design (the slot body is slot_body::mxu_compute in csrc/slot_body.cuh,
// which B15 shares): one CTA of T threads, T / 32 warps, warp m owning the rows
// [32 m, 32 m + 32) as two 16-row strips. For each 16-column step each lane
// computes in fp32 the 8 weights its mma.sync m16n8k16 A fragment holds in
// each strip, packs them to bf16 pairs and runs the row product W @ v_b at
// once; the same registers, transposed 8 x 8 block by 8 x 8 block with
// movmatrix, are W^T's A fragment for the reaction product W^T @ v_a. No w
// touches shared memory. The Pallas grid's sequential carry of the (8, C)
// accumulator becomes a partial per slot: each strip's row product is one
// fresh accumulator per slot, stored straight from the fragment to the
// slot's scratch tile (side 0: block bi); the warps' reaction partials
// meet in shared memory and are
// added in increasing warp index into side 1's tile (block bj); and
// csrc/slot_reduce.cu adds each block's partials in slot order, so every
// output bit is the same on every run. split_w adds the products of w's
// bf16 remainder. A FOLD slot runs two passes over the full tile, one per
// side with w zeroed off its triangle. The grid holds as many CTAs as the
// card runs at once (slot_body::stream_width); each walks its slots and
// loads the next slot's blocks into registers while it computes one.
//
// Systems: blockIdx.y is the system of an ensemble launch (B9a, the tri mode
// of mini_nbody_tpu/ops/slot_pipe.py:305 `_tri_slot_ensemble_kernel` with a
// system axis). Every system runs the same system-local slot list over its
// own rows, sys_rows rows after the previous system's; a standalone call is
// the same kernel with one system. gridDim.y is at most 65,535.
//
// Pad pairs: FAR-vs-FAR pairs in unmasked CROSS and FOLD tiles get w =
// softening^-1.5 (~3e13); their products are finite and land only in pad
// rows, which the wrapper slices off. A real body against a FAR pad gets
// w = 0 exactly (r2^3 overflows, rsqrtf(inf) = 0), so no inf or NaN reaches
// a real row. The fold's self diagonal is masked unconditionally.
//
// Built without --use_fast_math. nvcc contracts d2's mul/add pairs into FMAs;
// the plain version does not, so a w close to a bf16 rounding boundary can
// round one bf16 ulp apart from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

// Each CTA walks its slots (slot_body::walk_slots) on the slot body's bf16
// stage and compute, which B15 shares.
template <int T, bool kSplit>
__global__ void __launch_bounds__(
    slot_body::mxu_threads<T>(),
    slot_body::stream_min_ctas(slot_body::mxu_threads<T>(),
                               slot_body::kMxuWarps))
    slot_pipe_kernel(const int* __restrict__ slots, int n_slots,
                     const float* __restrict__ pos_a,
                     const float* __restrict__ pos_b,
                     const float* __restrict__ v_a,
                     const float* __restrict__ v_b, float* part,
                     long long sys_rows, float softening, int fast,
                     int mask_offdiag) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long sys = blockIdx.y;
  pos_a += sys * sys_rows * 3;
  pos_b += sys * sys_rows * 3;
  v_a += sys * sys_rows * 8;
  v_b += sys * sys_rows * 8;
  slot_body::MxuStage<T> stage;
  slot_body::walk_slots(
      slots, n_slots,
      [&](const slot_body::Slot& sl) {
        stage.load(sl.bi, sl.bj, pos_a, pos_b, v_a, v_b);
      },
      [&] { stage.store(smem); },
      [&](const slot_body::Slot& sl, int s) {
        float* out = part + (sys * n_slots + s) * 2 * T * 8;
        slot_body::mxu_compute<T, kSplit>(sl.kind, out, softening, fast,
                                          mask_offdiag, smem);
      });
}

template <int T, bool kSplit>
int launch(const int* slots, int n_slots, int n_sys, long long sys_rows,
           const float* pos_a, const float* pos_b, const float* v_a,
           const float* v_b, float* part, float softening, int fast,
           int mask_offdiag, cudaStream_t stream) {
  auto kernel = slot_pipe_kernel<T, kSplit>;
  constexpr int threads = slot_body::mxu_threads<T>();
  constexpr size_t smem = slot_body::mxu_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int width = 0;
  err = slot_body::stream_width(kernel, threads, smem, n_slots, n_sys,
                                &width);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(width, n_sys), threads, smem, stream>>>(
      slots, n_slots, pos_a, pos_b, v_a, v_b, part, sys_rows, softening,
      fast, mask_offdiag);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local memory bytes per thread (spills) and CTAs per
// SM of one instantiation, at its launch's shared memory.
template <int T, bool kSplit>
int info(int* out) {
  auto kernel = slot_pipe_kernel<T, kSplit>;
  constexpr size_t smem = slot_body::mxu_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, slot_body::mxu_threads<T>(), smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace

// slots (n_slots, 3) int32 (kind, bi, bj); pos_a (ca, 3), v_a (ca, 8), pos_b
// (cb, 3), v_b (cb, 8), fp32 row-major, with ca and cb multiples of tile
// (equal in tri mode) and every bi < ca / tile, bj < cb / tile; n_sys
// systems of such rows, sys_rows rows apart (tri mode; 1 system in cross
// mode); all contiguous on the current device. part: n_sys x n_slots x 2
// tiles of (tile, 8) fp32, written (side 0 of slot s: the rows of block bi;
// side 1: block bj; a DIAG slot writes side 0 only) for slot_reduce_launch.
// tile: 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int slot_pipe_launch(const int* slots, int n_slots, int n_sys,
                                long long sys_rows, const float* pos_a,
                                const float* pos_b, const float* v_a,
                                const float* v_b, float* part, int tile,
                                float softening, int fast, int split_w,
                                int mask_offdiag, void* stream) {
  if (n_slots == 0 || n_sys == 0) return 0;
  if (n_sys > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NBODY_SLOT_LAUNCH(T, SPLIT)                                        \
  launch<T, SPLIT>(slots, n_slots, n_sys, sys_rows, pos_a, pos_b, v_a, v_b, \
                   part, softening, fast, mask_offdiag, s)
  if (tile == 64 && !split_w) return NBODY_SLOT_LAUNCH(64, false);
  if (tile == 64 && split_w) return NBODY_SLOT_LAUNCH(64, true);
  if (tile == 128 && !split_w) return NBODY_SLOT_LAUNCH(128, false);
  if (tile == 128 && split_w) return NBODY_SLOT_LAUNCH(128, true);
#undef NBODY_SLOT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[3]: registers per thread, local bytes per thread and CTAs per SM of
// the kernel slot_pipe_launch runs for (tile, split_w).
extern "C" int slot_pipe_info(int tile, int split_w, int* out) {
  if (tile == 64) return split_w ? info<64, true>(out) : info<64, false>(out);
  if (tile == 128)
    return split_w ? info<128, true>(out) : info<128, false>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
