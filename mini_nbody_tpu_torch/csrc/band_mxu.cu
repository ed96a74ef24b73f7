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
// What bounds it on an H100: as K2 (csrc/slot_pipe.cu), the fp32 w pipeline
// (~12 fp32 instructions with one rsqrt per pair) and the shared-memory
// traffic of the W tile; the products are tiny (N = 8). Against K2 it
// stores one partial tile per block pair instead of two (the rows never
// leave the registers) and launches one CTA per row block instead of one
// per slot, which leaves fewer CTAs to hide latency: 1024 per tri call at
// c = 131,072 and T = 128, about two waves at four CTAs per SM.
//
// Design: 256 threads. Per tile, block j's positions and operand are
// staged in shared memory, all threads compute the T x T W tile into shared
// memory (bf16, rows padded to T + 8, with split_w a second tile of w's
// bf16 remainder), then warp m < T / 32 runs the m32n8k16 row products
// W[m rows] @ v_j and warp T / 32 + m the column products W^T[m cols] @ v_i
// (a col_major load of the same tile). Block i's own data is staged once.
//
// Pad pairs: as K2. A FAR-vs-FAR pair in an unmasked off-diagonal tile gets
// w = softening^-1.5; it lands only in pad rows and columns, which the
// wrapper slices off. A real body against a FAR pad gets w = 0 exactly
// (r2^3 overflows, rsqrtf(inf) = 0).
//
// Built without --use_fast_math. nvcc contracts d2's mul/add pairs into
// FMAs; the plain version does not, so a w close to a bf16 rounding boundary
// can round one bf16 ulp apart from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kThreads = 256;

template <int T, bool kSplit>
constexpr size_t smem_bytes() {
  constexpr int kParts = kSplit ? 2 : 1;
  return kParts * T * (T + 8) * sizeof(__nv_bfloat16)  // W tiles
         + 2 * T * 8 * sizeof(__nv_bfloat16)           // v_i, v_j
         + 6 * T * sizeof(float);                      // positions
}

template <int T, bool kSplit>
__global__ void __launch_bounds__(kThreads)
    band_mxu_kernel(const float* __restrict__ pos_a,
                    const float* __restrict__ pos_b,
                    const float* __restrict__ v_a,
                    const float* __restrict__ v_b, float* rows, float* part,
                    int nb, int i0, int cross, long long sys_rows,
                    float softening, int fast, int mask_offdiag) {
  using namespace nvcuda;
  constexpr int LD = T + 8;
  constexpr int kParts = kSplit ? 2 : 1;
  constexpr int kTile = T * LD;
  constexpr int kMTiles = T / 32;
  static_assert(2 * kMTiles <= kThreads / 32, "one warp per output tile");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vi = W + kParts * kTile;
  __nv_bfloat16* Vj = Vi + T * 8;
  float* xi = reinterpret_cast<float*>(Vj + T * 8);
  float* yi = xi + T;
  float* zi = yi + T;
  float* xj = zi + T;
  float* yj = xj + T;
  float* zj = yj + T;

  const long long sys = blockIdx.y;
  const int i = i0 + blockIdx.x;
  const int steps = cross ? nb : nb / 2 + 1;
  pos_a += sys * sys_rows * 3;
  pos_b += sys * sys_rows * 3;
  v_a += sys * sys_rows * 8;
  v_b += sys * sys_rows * 8;
  rows += (sys * sys_rows + static_cast<long long>(i) * T) * 8;
  part += (sys * gridDim.x + blockIdx.x) * static_cast<long long>(steps) *
          T * 8;

  const float* pi = pos_a + static_cast<size_t>(i) * T * 3;
  const float* vi = v_a + static_cast<size_t>(i) * T * 8;
  for (int t = threadIdx.x; t < T * 3; t += kThreads) {
    const int r = t / 3, k = t - 3 * (t / 3);
    xi[k * T + r] = pi[t];
  }
  for (int t = threadIdx.x; t < T * 8; t += kThreads)
    Vi[t] = __float2bfloat16_rn(vi[t]);

  // Warp -> (side, 32-row output tile): side 0 the rows of block i, side 1
  // the column partial of block j; warps past 2 kMTiles (T = 64) only help
  // with W.
  const int warp = threadIdx.x / 32;
  const int side = warp / kMTiles, m = warp % kMTiles;
  wmma::fragment<wmma::accumulator, 32, 8, 16, float> row_sum;
  wmma::fill_fragment(row_sum, 0.f);

  for (int d = 0; d < steps; ++d) {
    if (!cross && 2 * d == nb && 2 * i >= nb) continue;  // the wrap band
    const int j = cross ? d : (i + d) % nb;
    const bool diag = !cross && d == 0;
    const bool mask = diag || mask_offdiag;

    __syncthreads();  // the previous tile's products are done with W, Vj
    const float* pj = pos_b + static_cast<size_t>(j) * T * 3;
    const float* vj = v_b + static_cast<size_t>(j) * T * 8;
    for (int t = threadIdx.x; t < T * 3; t += kThreads) {
      const int r = t / 3, k = t - 3 * (t / 3);
      xj[k * T + r] = pj[t];
    }
    for (int t = threadIdx.x; t < T * 8; t += kThreads)
      Vj[t] = __float2bfloat16_rn(vj[t]);
    __syncthreads();

    for (int e = threadIdx.x; e < T * T; e += kThreads) {
      const int r = e / T, c = e % T;
      const float dx = xj[c] - xi[r];
      const float dy = yj[c] - yi[r];
      const float dz = zj[c] - zi[r];
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float r2 = d2 + softening;
      float w;
      if (fast) {
        w = rsqrtf((r2 * r2) * r2);
      } else {
        const float inv = rsqrtf(r2);
        w = (inv * inv) * inv;
      }
      if (mask && d2 == 0.f) w = 0.f;
      const __nv_bfloat16 hi = __float2bfloat16_rn(w);
      W[r * LD + c] = hi;
      if (kSplit) W[kTile + r * LD + c] =
          __float2bfloat16_rn(w - __bfloat162float(hi));
    }
    __syncthreads();

    if (side > 1 || (side == 1 && diag)) continue;
    // A fresh fragment for this tile's product.
    wmma::fragment<wmma::accumulator, 32, 8, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    const __nv_bfloat16* V = side == 0 ? Vj : Vi;
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const __nv_bfloat16* Wp = W + p * kTile;
#pragma unroll 2
      for (int k = 0; k < T / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 32, 8, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, V + k * 16 * 8, 8);
        if (side == 0) {
          wmma::fragment<wmma::matrix_a, 32, 8, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(a, Wp + m * 32 * LD + k * 16, LD);
          wmma::mma_sync(acc, a, b, acc);
        } else {
          wmma::fragment<wmma::matrix_a, 32, 8, 16, __nv_bfloat16,
                         wmma::col_major> at;
          wmma::load_matrix_sync(at, Wp + k * 16 * LD + m * 32, LD);
          wmma::mma_sync(acc, at, b, acc);
        }
      }
    }
    if (side == 0) {
      // Same fragment type, same element mapping: element-wise fp32 adds.
#pragma unroll
      for (int t = 0; t < row_sum.num_elements; ++t) row_sum.x[t] += acc.x[t];
    } else {
      wmma::store_matrix_sync(part + (static_cast<long long>(d) * T + m * 32)
                                         * 8,
                              acc, 8, wmma::mem_row_major);
    }
  }

  // rows[i] = rows[i] + the walk's sums (the JAX chunk loop's cur + r).
  if (side == 0) {
    wmma::fragment<wmma::accumulator, 32, 8, 16, float> cur;
    float* dst = rows + m * 32 * 8;
    wmma::load_matrix_sync(cur, dst, 8, wmma::mem_row_major);
#pragma unroll
    for (int t = 0; t < cur.num_elements; ++t) cur.x[t] += row_sum.x[t];
    wmma::store_matrix_sync(dst, cur, 8, wmma::mem_row_major);
  }
}

template <int T, bool kSplit>
int launch(const float* pos_a, const float* pos_b, const float* v_a,
           const float* v_b, float* rows, float* part, int nb, int i0,
           int n_rows, int cross, int n_sys, long long sys_rows,
           float softening, int fast, int mask_offdiag,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, kSplit>();
  cudaError_t err = cudaFuncSetAttribute(
      band_mxu_kernel<T, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_mxu_kernel<T, kSplit><<<dim3(n_rows, n_sys), kThreads, smem, stream>>>(
      pos_a, pos_b, v_a, v_b, rows, part, nb, i0, cross, sys_rows, softening,
      fast, mask_offdiag);
  return static_cast<int>(cudaGetLastError());
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
#define NBODY_BAND_LAUNCH(T, SPLIT)                                        \
  launch<T, SPLIT>(pos_a, pos_b, v_a, v_b, rows, part, nb, i0, n_rows,     \
                   cross, n_sys, sys_rows, softening, fast, mask_offdiag, s)
  if (tile == 64 && !split_w) return NBODY_BAND_LAUNCH(64, false);
  if (tile == 64 && split_w) return NBODY_BAND_LAUNCH(64, true);
  if (tile == 128 && !split_w) return NBODY_BAND_LAUNCH(128, false);
  if (tile == 128 && split_w) return NBODY_BAND_LAUNCH(128, true);
#undef NBODY_BAND_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
