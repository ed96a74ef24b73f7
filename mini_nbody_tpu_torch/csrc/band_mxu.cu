// B16: the band traversal of the pair-once sym_mxu force. Each pair's weight
// w once in fp32, the row and reaction sums as bf16 tensor-core products
// with fp32 accumulation, row sums and reaction sums kept apart until the
// epilogue (the wrapper adds them).
//
// Replaces the three band kernels of mini_nbody_tpu/ops/sym_mxu_force.py:
//   :226 `_tri_kernel` through `_build_calls` (:309, pallas_call :317):
//        one self chunk on the band grid (nb, nb/2 + 1)    -> "tri mode"
//   :267 `_cross_kernel` through `_build_calls` (pallas_call :343): one
//        chunk pair a != b on the (nb, nb) grid            -> "cross mode"
//   :368 `_build_tri_ensemble` (pallas_call :384): the tri kernel under a
//        leading system axis                               -> "ensemble"
// The ensemble is the tri mode with the system on blockIdx.y (system s's
// rows sys_rows rows after system s - 1's); a standalone call is the same
// kernel with one system.
//
// What the band computes. Grid step (i, d) of the TPU kernel takes the
// block pair (i, j), j = (i + d) mod nb in tri mode, j = d in cross mode:
//   rows[i]  += W @ v_j   (d == 0, tri: the diagonal block, W masked where
//                          d2 == 0, both orders of each pair in its rows)
//   colsT[j] += v_i^T W   (every tile off the diagonal)
// with W masked where d2 == 0 off the diagonal iff mask_offdiag. When nb is
// even, the wrap band d = nb / 2 is active only for i < nb / 2 (each block
// pair once). v = [vhi | vlo] (T, 8) is the compensated operand split built
// by the wrapper; the kernel rounds it to bf16 as the MXU does (vhi is
// exact).
//
// Hopper has no sequential grid, so the TPU's carry of rows[i] across
// consecutive d and of colsT across the whole grid becomes:
//   - one CTA per row block i (per system, per piece) that walks its band
//     with a loop: the row sums stay in fp32 registers for the whole walk
//     and are added into the row accumulator once, at the end. Each tile's
//     product starts from a fresh tensor-core fragment and is added into the
//     register sums with round-to-nearest fp32 adds (a fragment carried over
//     hundreds of tiles drifts: the MMA's own fp32 adds do not round to
//     nearest);
//   - every off-diagonal tile stores its (T, 8) column partial to scratch,
//     at (local row block, d), with plain stores, and csrc/slot_reduce.cu
//     then adds each column block's partials in increasing i, the TPU
//     grid's order (the wrapper builds that plan). No atomics: every output
//     bit is the same on every run, and an ensemble system is bitwise its
//     standalone call.
//
// What bounds it on an H100: as K2 (csrc/slot_pipe.cu), the fp32 w pipeline,
// ~12 fp32 instructions and one rsqrt per pair; the products are tiny
// (N = 8). Against K2 it stores one partial tile per block pair instead of
// two (the rows never leave the registers) and launches one CTA per row
// block instead of one per slot: 1024 per tri call at c = 131,072 and
// T = 128.
//
// Design (K2's slot body on the band walk, csrc/slot_body.cuh `mxu_steps`):
// one CTA of T threads, T / 32 warps, warp m owning the rows [32 m, 32 m +
// 32) of block i as two 16-row strips. Each lane holds its rows g and g + 8
// of each strip (positions, and the strip's v_i B fragment for the
// reactions) in registers for the whole walk. Per tile, block j's positions
// (float4) and v_j^T in bf16 are staged in shared memory from registers
// loaded while the tile before computed; for each 16-column step each lane
// computes in fp32 the 8 weights its mma.sync m16n8k16 A fragment holds in
// each strip, packs them to bf16 pairs and runs the row product W @ v_j at
// once; movmatrix transposes the same registers into W^T's A fragment for
// the column product W^T @ v_i. No w touches shared memory. Each step's
// column fragment goes to shared memory, and after the tile the warps'
// partials are added in increasing warp index into the tile's (T, 8) column
// partial. split_w adds the products of w's bf16 remainder. Two barriers
// per tile. A launch's last wave of CTAs costs about its share of the
// CTAs (ab_slots.py on an H100: a tri launch at c = 131,072 takes
// 2.49-2.55 ms over its first 528 row blocks, one full wave at 4 CTAs per
// SM, and 4.81-4.84 ms over all 1024), so the walk is not split into
// segments.
//
// Pad pairs: as K2. A FAR-vs-FAR pair in an unmasked off-diagonal tile gets
// w = softening^-1.5; it lands only in pad rows and columns, which the
// wrapper slices off. A real body against a FAR pad gets w = 0 exactly
// (r2^3 overflows, rsqrt(inf) = 0).
//
// Built without --use_fast_math. nvcc contracts d2's mul/add pairs into
// FMAs; the plain version does not, so a w close to a bf16 rounding boundary
// can round one bf16 ulp apart from it. Both forms of w take
// rsqrt.approx.ftz: rsqrt(r2^3) as K2 does (softening >= 1e-12 keeps r2^3
// normal), and rsqrt(r2)^3 without rsqrtf's rescaling of a denormal input
// (which spilled at 168 registers): a denormal r2, which only a softening
// below 2^-126 lets through, gives w = inf either way (inv > 2^63, so inv^3
// overflows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

using slot_body::kMxuStrips;
using slot_body::mxu_threads;

// One tile's products: rows into acc (a fresh fragment), with kCols the
// column fragments to cw. kD2 masks d2 == 0.
template <int T, bool kSplit, bool kFast, bool kCols, bool kD2>
__device__ __forceinline__ void band_tile(const slot_body::MxuRows& rw,
                                          const float4* Q,
                                          const __nv_bfloat16* vt,
                                          float softening,
                                          float (&acc)[kMxuStrips][4],
                                          float* cw) {
  const int g = (threadIdx.x & 31) >> 2;
  auto weight = [softening](const float4& p, const float4& q, int,
                            int) {
    const float dx = q.x - p.x;
    const float dy = q.y - p.y;
    const float dz = q.z - p.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float r2 = d2 + softening;
    float w;
    if (kFast) {
      w = slot_body::rsqrt_normal((r2 * r2) * r2);
    } else {
      const float inv = slot_body::rsqrt_normal(r2);
      w = (inv * inv) * inv;
    }
    if (kD2 && d2 == 0.f) w = 0.f;
    return w;
  };
#pragma unroll
  for (int h = 0; h < kMxuStrips; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
  slot_body::mxu_steps<T, kSplit, kCols>(
      rw, Q, reinterpret_cast<const uint32_t*>(vt + g * (T + 8)), acc, cw,
      weight);
}

// Warps per SM the kernel is compiled for: 16 (128 registers) without
// split_w, 12 (168) with it, whose remainder fragments need the registers.
template <bool kSplit>
constexpr int band_warps() {
  return kSplit ? 12 : 16;
}

template <int T, bool kSplit, bool kFast>
__global__ void __launch_bounds__(
    mxu_threads<T>(),
    slot_body::stream_min_ctas(mxu_threads<T>(), band_warps<kSplit>()))
    band_mxu_kernel(const float* __restrict__ pos_a,
                    const float* __restrict__ pos_b,
                    const float* __restrict__ v_a,
                    const float* __restrict__ v_b, float* rows, float* part,
                    int nb, int i0, int cross, long long sys_rows,
                    float softening, int mask_offdiag) {
  constexpr int kThreads = mxu_threads<T>();
  constexpr int kWarps = kThreads / 32;
  constexpr int H = kMxuStrips;
  __shared__ __align__(16) float4 Q[T];
  __shared__ __align__(16) __nv_bfloat16 VT[8 * (T + 8)];
  __shared__ __align__(16) float cols[kWarps * T * 8];

  // Pointers into the system's rows are formed where they are used, from
  // the kernel's parameters, so the walk keeps none of them in registers.
  const int i = i0 + blockIdx.x;
  const int steps = cross ? nb : nb / 2 + 1;
  const long long row_i =
      blockIdx.y * sys_rows + static_cast<long long>(i) * T;

  // The lane's rows of block i, and its strips' v_i B fragments (k = the
  // strip's rows, n = g), for the whole walk.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* pi = pos_a + row_i * 3;
  const float* vi = v_a + row_i * 8;
  slot_body::MxuRows rw;
  float row_sum[H][4];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int strip = 16 * (H * warp + h);
    rw.r0[h] = strip + g;
    const float* p0 = pi + rw.r0[h] * 3;
    const float* p1 = p0 + 8 * 3;
    rw.p0[h] = make_float4(p0[0], p0[1], p0[2], 0.f);
    rw.p1[h] = make_float4(p1[0], p1[1], p1[2], 0.f);
    const float* k0 = vi + (strip + 2 * t) * 8 + g;
    rw.bp0[h] = slot_body::pack_bf16x2(k0[0], k0[8]);
    rw.bp1[h] = slot_body::pack_bf16x2(k0[64], k0[72]);
    row_sum[h][0] = row_sum[h][1] = row_sum[h][2] = row_sum[h][3] = 0.f;
  }
  float* cw = cols + warp * T * 8;  // this warp's column partials

  // Band steps d = 0 .. n_steps - 1 take block pair (i, j): j = d in cross
  // mode, (i + d) mod nb in tri mode, where the wrap band d = nb / 2 of an
  // even nb is active only for i < nb / 2.
  const int n_steps = steps - (!cross && 2 * (steps - 1) == nb && 2 * i >= nb);
  auto load = [&](slot_body::MxuBlock<T>& stage, int d) {
    const long long row = blockIdx.y * sys_rows +
                          static_cast<long long>(cross ? d : (i + d) % nb) * T;
    stage.load(pos_b + row * 3, v_b + row * 8);
  };
  slot_body::MxuBlock<T> stage;
  load(stage, 0);
  for (int d = 0; d < n_steps; ++d) {
    // The previous tile's products and column totals are done.
    stage.store(reinterpret_cast<float*>(Q), VT);
    __syncthreads();
    if (d + 1 < n_steps) load(stage, d + 1);
    float acc[H][4];
    const bool diag = !cross && d == 0;
    if (diag)
      band_tile<T, kSplit, kFast, false, true>(rw, Q, VT, softening, acc, cw);
    else if (mask_offdiag)
      band_tile<T, kSplit, kFast, true, true>(rw, Q, VT, softening, acc, cw);
    else
      band_tile<T, kSplit, kFast, true, false>(rw, Q, VT, softening, acc, cw);
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) row_sum[h][q] += acc[h][q];
    __syncthreads();
    if (!diag) {
      // The tile's column partial: the warps' in increasing warp index.
      float4* out4 = reinterpret_cast<float4*>(
          part + ((static_cast<long long>(blockIdx.y) * gridDim.x +
                   blockIdx.x) *
                      static_cast<long long>(steps) + d) * T * 8);
      for (int e = threadIdx.x; e < 2 * T; e += kThreads)
        out4[e] = slot_body::warp_total4<T>(cols, e);
    }
  }

  // rows[i] = rows[i] + the walk's sums (the JAX chunk loop's cur + r).
  // C fragments: (row g, columns 2t, 2t + 1), (row g + 8, the same).
  rows += row_i * 8;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float2* r0 = reinterpret_cast<float2*>(rows + rw.r0[h] * 8 + 2 * t);
    float2* r1 = reinterpret_cast<float2*>(rows + (rw.r0[h] + 8) * 8 + 2 * t);
    const float2 c0 = *r0, c1 = *r1;
    *r0 = make_float2(c0.x + row_sum[h][0], c0.y + row_sum[h][1]);
    *r1 = make_float2(c1.x + row_sum[h][2], c1.y + row_sum[h][3]);
  }
}

template <int T, bool kSplit, bool kFast>
int launch(const float* pos_a, const float* pos_b, const float* v_a,
           const float* v_b, float* rows, float* part, int nb, int i0,
           int n_rows, int cross, int n_sys, long long sys_rows,
           float softening, int mask_offdiag, cudaStream_t stream) {
  band_mxu_kernel<T, kSplit, kFast>
      <<<dim3(n_rows, n_sys), mxu_threads<T>(), 0, stream>>>(
          pos_a, pos_b, v_a, v_b, rows, part, nb, i0, cross, sys_rows,
          softening, mask_offdiag);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local memory bytes per thread (spills) and CTAs per
// SM of one instantiation.
template <int T, bool kSplit, bool kFast>
int info(int* out) {
  auto kernel = band_mxu_kernel<T, kSplit, kFast>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      mxu_threads<T>(), 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace

// pos_a / pos_b (nb tile, 3), v_a / v_b (nb tile, 8) fp32 row-major (the
// same chunk in tri mode), n_sys systems of such rows, sys_rows rows apart
// (tri mode; one system in cross mode); rows: the row accumulator of side a
// (same layout, 8 columns), to which block i's row sums are ADDED; part:
// n_sys x n_rows x steps tiles of (tile, 8) fp32, steps = nb / 2 + 1 (tri) or
// nb (cross), of which tile (local row, d) of each off-diagonal block pair is
// written. Row blocks i0 .. i0 + n_rows - 1 run, one CTA each. tile: 64 or
// 128. Returns cudaGetLastError() after the launch.
extern "C" int band_mxu_launch(const float* pos_a, const float* pos_b,
                               const float* v_a, const float* v_b,
                               float* rows, float* part, int nb, int i0,
                               int n_rows, int cross, int n_sys,
                               long long sys_rows, int tile, float softening,
                               int fast, int split_w, int mask_offdiag,
                               void* stream) {
  if (n_rows == 0 || n_sys == 0) return 0;
  if (n_sys > 65535 || i0 < 0 || n_rows < 0 || i0 + n_rows > nb)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NBODY_BAND_LAUNCH(T, SPLIT)                                          \
  (fast ? launch<T, SPLIT, true>(pos_a, pos_b, v_a, v_b, rows, part, nb, i0, \
                                 n_rows, cross, n_sys, sys_rows, softening,  \
                                 mask_offdiag, s)                            \
        : launch<T, SPLIT, false>(pos_a, pos_b, v_a, v_b, rows, part, nb,    \
                                  i0, n_rows, cross, n_sys, sys_rows,        \
                                  softening, mask_offdiag, s))
  if (tile == 64 && !split_w) return NBODY_BAND_LAUNCH(64, false);
  if (tile == 64 && split_w) return NBODY_BAND_LAUNCH(64, true);
  if (tile == 128 && !split_w) return NBODY_BAND_LAUNCH(128, false);
  if (tile == 128 && split_w) return NBODY_BAND_LAUNCH(128, true);
#undef NBODY_BAND_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[3]: registers per thread, local bytes per thread and CTAs per SM of
// the kernel band_mxu_launch runs for (tile, split_w, fast).
extern "C" int band_mxu_info(int tile, int split_w, int fast, int* out) {
#define NBODY_BAND_INFO(T, SPLIT) \
  (fast ? info<T, SPLIT, true>(out) : info<T, SPLIT, false>(out))
  if (tile == 64 && !split_w) return NBODY_BAND_INFO(64, false);
  if (tile == 64 && split_w) return NBODY_BAND_INFO(64, true);
  if (tile == 128 && !split_w) return NBODY_BAND_INFO(128, false);
  if (tile == 128 && split_w) return NBODY_BAND_INFO(128, true);
#undef NBODY_BAND_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}
