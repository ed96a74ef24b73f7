// The deterministic reduction behind the pair-once slot kernels K2
// (csrc/slot_pipe.cu), K3 (csrc/symmetric_force.cu), B11 and B12
// (csrc/vjp_kernel.cu) and B13 (csrc/vjp_mxu.cu), their ensembles, and
// B16's column partials (csrc/band_mxu.cu).
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
// (local slot * 2 + side) in slot order, as CSR offsets into `entries`,
// and the order to start the targets in (longest list first).
//
// What bounds it on an H100: device memory, each partial read once (2 T K 4
// bytes per slot). A K3 cross piece at chunk 131,072 (64 row blocks x 1024
// column blocks) is 201 MB, half of it in the 64 row blocks' lists of 1024
// tiles each, so a few CTAs have to stream megabytes: a list is a chain of
// dependent adds, and it runs at the rate its loads arrive. The design:
//   - one CTA per (target, system) of T K / 4 threads, each owning one
//     float4 of the tile (every tile is T K 4 bytes, a multiple of 16), so
//     no thread idles and each load is 16 bytes;
//   - a ring of S tiles in shared memory per CTA, filled by 16-byte
//     cp.async copies S tiles ahead of the adds (S x the tile's bytes, up
//     to 48 KB in flight a CTA); each thread copies and reads only its own
//     float4 of every stage, so the ring needs no barrier;
//   - the target's entries staged in shared memory (in windows of kWindow),
//     so no copy waits on an index load;
//   - CTAs launched longest list first (the plan's order).
// Each output element is 0 + p_0 + p_1 + ... in list order, added into
// the accumulator; the kernel is built without --use_fast_math, so nvcc
// keeps that order, and every bit is the plain version's
// (ops/slot_pipe.slot_reduce_plain) and B15's (slot_body::ordered_sum).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Bytes of partials in flight per CTA: the ring holds this many bytes of
// tiles, a power of two of them between kMinStages and kMaxStages.
constexpr int kInflightBytes = 49152;
constexpr int kMinStages = 4, kMaxStages = 32;
// Entries of a target's list staged in shared memory at a time; the ring
// drains at the end of each window (lists are at most nb_b <= 2048 long
// on the default paths, one window).
constexpr int kWindow = 2048;

__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One CTA per (target order[blockIdx.x], system blockIdx.y): thread
// v sums float4 v of the target's tiles in list order through a ring of S
// stages, then adds the sum into the accumulator.
template <int S>
__global__ void slot_reduce_kernel(const float* __restrict__ part,
                                   int tile_elems,
                                   const int* __restrict__ targets,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ entries,
                                   const int* __restrict__ order, float* acc_a,
                                   float* acc_b, long long sys_acc_stride,
                                   long long sys_part_tiles) {
  extern __shared__ __align__(16) float4 smem4[];
  const int threads = blockDim.x, v = threadIdx.x;
  float4* ring = smem4;  // stage k of thread v: ring[k * threads + v]
  int* idx = reinterpret_cast<int*>(smem4 + S * threads);
  const int t = order[blockIdx.x];
  const long long sys = blockIdx.y;
  const long long quads = tile_elems / 4;
  const float4* base =
      reinterpret_cast<const float4*>(part + sys * sys_part_tiles *
                                                 tile_elems) + v;
  const int e0 = offsets[t], e1 = offsets[t + 1];
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w0 = e0; w0 < e1; w0 += kWindow) {
    const int n = min(kWindow, e1 - w0);
    __syncthreads();  // every thread is done with the last window's entries
    for (int i = v; i < n; i += threads) idx[i] = entries[w0 + i];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (k < n) copy16(&ring[k * threads + v], base + idx[k] * quads);
      commit();  // one group per stage, empty or not
    }
    int stage = 0;
    for (int i = 0; i < n; ++i) {
      wait_groups<S - 1>();  // tile i has landed
      const float4 x = ring[stage * threads + v];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
      if (i + S < n)
        copy16(&ring[stage * threads + v], base + idx[i + S] * quads);
      commit();
      stage = stage + 1 == S ? 0 : stage + 1;
    }
  }
  const int target = targets[t];
  float4* acc = reinterpret_cast<float4*>(
                    ((target & 1) ? acc_b : acc_a) + sys * sys_acc_stride +
                    static_cast<long long>(target >> 1) * tile_elems) + v;
  float4 a = *acc;
  a.x += s.x;
  a.y += s.y;
  a.z += s.z;
  a.w += s.w;
  *acc = a;
}

using ReduceKernel = void (*)(const float*, int, const int*, const int*,
                              const int*, const int*, float*, float*,
                              long long, long long);

// The ring depth for a tile of `bytes`: kInflightBytes of tiles, rounded
// down to a power of two in [kMinStages, kMaxStages].
ReduceKernel pick_stages(int bytes, int* stages) {
  int s = kMaxStages;
  while (s > kMinStages && s * bytes > kInflightBytes) s /= 2;
  *stages = s;
  switch (s) {
    case 32:
      return slot_reduce_kernel<32>;
    case 16:
      return slot_reduce_kernel<16>;
    case 8:
      return slot_reduce_kernel<8>;
    default:
      return slot_reduce_kernel<4>;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// part: n_sys x sys_part_tiles tiles of tile_elems fp32 (the partials of one
// piece); targets (n_targets,), offsets (n_targets + 1,), entries
// (offsets[n_targets],) int32; order (n_targets,) int32, the targets in the
// order to start them; acc_a / acc_b: the accumulators (rows, K), system
// s's rows starting at s * sys_acc_stride floats. The sums are ADDED into
// acc_a / acc_b. tile_elems must be a
// multiple of 4 and at most 2048 (the ring and the entries then fit 56 KB
// of shared memory), part, acc_a and acc_b 16-byte aligned and
// sys_acc_stride a multiple of 4: a call that is not is refused with
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
extern "C" int slot_reduce_launch(const float* part, int tile_elems,
                                  int n_targets, const int* targets,
                                  const int* offsets, const int* entries,
                                  const int* order, float* acc_a,
                                  float* acc_b, int n_sys,
                                  long long sys_acc_stride,
                                  long long sys_part_tiles, void* stream) {
  if (tile_elems <= 0 || tile_elems % 4 != 0 || tile_elems > 2048 ||
      n_sys > 65535 || sys_acc_stride % 4 != 0 || !aligned16(part) ||
      !aligned16(acc_a) || !aligned16(acc_b))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_targets == 0 || n_sys == 0) return 0;
  const int threads = tile_elems / 4;
  int stages = 0;
  const ReduceKernel kernel = pick_stages(tile_elems * 4, &stages);
  const size_t smem =
      static_cast<size_t>(stages) * threads * sizeof(float4) +
      kWindow * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_targets, n_sys), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      part, tile_elems, targets, offsets, entries, order, acc_a, acc_b,
      sys_acc_stride, sys_part_tiles);
  return static_cast<int>(cudaGetLastError());
}
