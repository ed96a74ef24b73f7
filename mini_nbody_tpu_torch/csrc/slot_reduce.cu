// The deterministic reduction behind the pair-once slot kernels K2
// (csrc/slot_pipe.cu), K3 (csrc/symmetric_force.cu), B11
// (csrc/vjp_kernel.cu) and B13 (csrc/vjp_mxu.cu), and their ensembles.
//
// On the TPU each of those Pallas kernels carries its accumulator across a
// sequential grid, so every output is summed in grid order. Here the CTAs of
// a slot list run in no order. Each CTA writes its two T x K partial tiles
// (side 0: block bi, side 1: block bj) to a scratch buffer indexed by its
// slot, with plain stores; this kernel then adds, for each target block, its
// partials in slot order and adds that sum into the accumulator. The order
// of every add depends only on the system-local slot list and the tile, so
// the result is the same bit for bit on every run and for every number of
// systems in a launch.
//
// The wrapper (ops/slot_pipe.py, run_slot_pieces) builds the plan once per
// slot table: for one piece of the list, the targets (block * 2 + which
// accumulator) that receive partials, and per target the scratch tiles
// (local slot * 2 + side) in slot order, as CSR offsets into `entries`.
//
// One thread per element of a target's T x K tile and system (coalesced
// over the tile's contiguous rows): CTAs of 256 threads, ceil(T K / 256) of
// them per (target, system), so the few targets with long lists (a cross
// piece's row blocks take 1024 partials each) spread over several SMs. A
// thread loads kUnroll partials before it adds them, so a long list costs
// one load latency per kUnroll adds, not per add. What bounds it on an
// H100: device memory, each partial read once (2 T K 4 bytes per slot). The
// sum starts at 0 and adds the partials in list order, however the loads
// are grouped; the kernel is built without --use_fast_math, so nvcc keeps
// that order.

#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    slot_reduce_kernel(const float* __restrict__ part, int tile_elems,
                       int chunks, const int* __restrict__ targets,
                       const int* __restrict__ offsets,
                       const int* __restrict__ entries, float* acc_a,
                       float* acc_b, long long sys_acc_stride,
                       long long sys_part_tiles) {
  const int t = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  if (i >= tile_elems) return;
  const long long sys = blockIdx.y;
  const int target = targets[t];
  float* acc = ((target & 1) ? acc_b : acc_a) + sys * sys_acc_stride +
               static_cast<long long>(target >> 1) * tile_elems;
  const float* base = part + sys * sys_part_tiles * tile_elems + i;
  acc[i] += slot_body::ordered_sum(base, entries, offsets[t], offsets[t + 1],
                                   tile_elems);
}

}  // namespace

// part: n_sys x sys_part_tiles tiles of tile_elems fp32 (the partials of one
// piece); targets (n_targets,), offsets (n_targets + 1,), entries
// (offsets[n_targets],) int32; acc_a / acc_b: the accumulators (rows, K),
// system s's rows starting at s * sys_acc_stride floats. The sums are ADDED
// into acc_a / acc_b. Returns cudaGetLastError() after the launch.
extern "C" int slot_reduce_launch(const float* part, int tile_elems,
                                  int n_targets, const int* targets,
                                  const int* offsets, const int* entries,
                                  float* acc_a, float* acc_b, int n_sys,
                                  long long sys_acc_stride,
                                  long long sys_part_tiles, void* stream) {
  if (n_targets == 0 || n_sys == 0) return 0;
  if (n_sys > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (tile_elems + kThreads - 1) / kThreads;
  dim3 grid(n_targets * chunks, n_sys);
  slot_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part, tile_elems, chunks, targets, offsets, entries, acc_a, acc_b,
      sys_acc_stride, sys_part_tiles);
  return static_cast<int>(cudaGetLastError());
}
