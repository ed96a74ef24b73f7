// K2: pair-once sym_mxu slot kernel: the pair weight w once per unordered
// pair in fp32, the row and reaction sums as bf16 tensor-core products with
// fp32 accumulation.
//
// Replaces both Pallas slot kernels of mini_nbody_tpu/ops/slot_pipe.py:
//   :165 `_tri_slot_kernel`   (build_tri_slot_call, self chunk, DIAG /
//                              CROSS / FOLD slots)        -> "tri mode"
//   :210 `_cross_pair_kernel` (build_cross_slot_call, chunk pair a != b,
//                              CROSS slots only)          -> "cross mode"
// The two modes are the same kernel; they differ only in the base pointers
// the wrapper passes (tri: pos_a == pos_b, v_a == v_b, acc_a == acc_b).
//
// One CTA of 256 threads per slot (kind, bi, bj), read from a device
// int32 (S, 3) slot list. Rows index block bi of chunk a, columns block bj
// of chunk b:
//   DIAG  (bi == bj): w masked where d2 == 0 (self pairs) -> acc_a[bi] +=
//         W @ v_b[bj] (rows cover both pair orders).
//   CROSS: w masked where d2 == 0 iff mask_offdiag -> acc_a[bi] += W @
//         v_b[bj], acc_b[bj] += W^T @ v_a[bi].
//   FOLD  (bj == bi + 1, tri mode): entry (r, c) is pair (a_r, a_c) where
//         c < r (tile 0, W_lo) and (b_r, b_c) where c > r (tile 1, W_hi);
//         c == r is always masked, d2 == 0 iff mask_offdiag (the geometry of
//         slot_pipe.py:125-157) -> acc_a[bi] += W_lo @ v_a + W_lo^T @ v_a,
//         acc_b[bj] += W_hi @ v_b + W_hi^T @ v_b.
// v = [vhi | vlo] (T, 8) is the compensated operand split built by the
// wrapper; the kernel rounds it to bf16 as the MXU does (vhi is exact).
//
// What bounds it on an H100: the fp32 w pipeline (~10 fp32 instructions and
// one rsqrt on the special-function unit per pair), then shared-memory
// traffic: the bf16 W tile is written once and read twice by the wmma loads
// (rows, and reactions through a col_major load of the same tile, so W^T
// costs no second rsqrt). The products are tiny (N = 8) and the tensor cores
// idle most of the time.
//
// Design: W for the whole T x T slot tile is computed by all 256 threads into
// shared memory (bf16, rows padded to T + 8 to spread banks), then each warp
// owns one 32-row output tile of one side and runs m32n8k16 wmma products
// over the tile's K = T columns. The Pallas grid's sequential carry of the
// (8, C) accumulator becomes atomicAdd of each warp's 32 x 8 result into the
// (C, 8) fp32 accumulator in device memory: 16 atomics per body per slot
// against T^2 pair evaluations. Atomic order varies from run to run, so
// results are not bitwise reproducible (a deterministic reduction is ROADMAP
// work). split_w adds the second product pass on the bf16 remainder of w.
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
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kSlotDiag = 0;
constexpr int kSlotFold = 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int T, bool kSplit>
constexpr size_t smem_bytes() {
  constexpr int kParts = kSplit ? 2 : 1;
  return 2 * kParts * T * (T + 8) * sizeof(__nv_bfloat16)  // W tiles
         + 2 * T * 8 * sizeof(__nv_bfloat16)               // v_a, v_b
         + kWarps * 32 * 8 * sizeof(float)                 // per-warp C
         + 6 * T * sizeof(float);                          // positions
}

template <int T, bool kSplit>
__global__ void __launch_bounds__(kThreads)
    slot_pipe_kernel(const int* __restrict__ slots,
                     const float* __restrict__ pos_a,
                     const float* __restrict__ pos_b,
                     const float* __restrict__ v_a,
                     const float* __restrict__ v_b, float* acc_a,
                     float* acc_b, float softening, int fast,
                     int mask_offdiag) {
  constexpr int LD = T + 8;
  constexpr int kParts = kSplit ? 2 : 1;
  constexpr int kTile = T * LD;
  constexpr int kMTiles = T / 32;
  static_assert(2 * kMTiles <= kWarps, "one warp per 32-row output tile");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Va = W + 2 * kParts * kTile;
  __nv_bfloat16* Vb = Va + T * 8;
  float* scratch = reinterpret_cast<float*>(Vb + T * 8);
  float* xa = scratch + kWarps * 32 * 8;
  float* ya = xa + T;
  float* za = ya + T;
  float* xb = za + T;
  float* yb = xb + T;
  float* zb = yb + T;

  const int kind = slots[3 * blockIdx.x];
  const int bi = slots[3 * blockIdx.x + 1];
  const int bj = slots[3 * blockIdx.x + 2];
  const bool fold = kind == kSlotFold;
  const bool mask = kind == kSlotDiag || mask_offdiag;

  const float* pa = pos_a + static_cast<size_t>(bi) * T * 3;
  const float* pb = pos_b + static_cast<size_t>(bj) * T * 3;
  for (int t = threadIdx.x; t < T * 3; t += kThreads) {
    const int r = t / 3, k = t - 3 * (t / 3);
    xa[k * T + r] = pa[t];
    xb[k * T + r] = pb[t];
  }
  const float* va = v_a + static_cast<size_t>(bi) * T * 8;
  const float* vb = v_b + static_cast<size_t>(bj) * T * 8;
  for (int t = threadIdx.x; t < T * 8; t += kThreads) {
    Va[t] = __float2bfloat16_rn(va[t]);
    Vb[t] = __float2bfloat16_rn(vb[t]);
  }
  __syncthreads();

  // Pair weights. Tile 0 holds W (DIAG, CROSS) or W_lo (FOLD); tile 1 holds
  // W_hi (FOLD only).
  for (int e = threadIdx.x; e < T * T; e += kThreads) {
    const int r = e / T, c = e % T;
    const bool upper = fold && c > r;
    float dx, dy, dz;
    if (!fold) {
      dx = xb[c] - xa[r];
      dy = yb[c] - ya[r];
      dz = zb[c] - za[r];
    } else if (upper) {
      dx = xb[c] - xb[r];
      dy = yb[c] - yb[r];
      dz = zb[c] - zb[r];
    } else {
      dx = xa[c] - xa[r];
      dy = ya[c] - ya[r];
      dz = za[c] - za[r];
    }
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float r2 = d2 + softening;
    float w;
    if (fast) {
      w = rsqrtf((r2 * r2) * r2);
    } else {
      const float inv = rsqrtf(r2);
      w = (inv * inv) * inv;
    }
    if ((fold && r == c) || (mask && d2 == 0.f)) w = 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(w);
    __nv_bfloat16* dst = W + (upper ? kParts * kTile : 0) + r * LD + c;
    dst[0] = hi;
    if (kSplit) dst[kTile] = __float2bfloat16_rn(w - __bfloat162float(hi));
    if (fold) {
      __nv_bfloat16* other = W + (upper ? 0 : kParts * kTile) + r * LD + c;
      other[0] = __float2bfloat16_rn(0.f);
      if (kSplit) other[kTile] = __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();

  // Warp -> (side, 32-row output tile). Side 0 accumulates into block bi of
  // acc_a, side 1 into block bj of acc_b.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int side = warp / kMTiles, m = warp % kMTiles;
  if (side > 1 || (kind == kSlotDiag && side == 1)) return;
  const bool rows = fold || side == 0;  // W @ v
  const bool cols = fold || side == 1;  // W^T @ v
  const __nv_bfloat16* Wt = W + (fold && side == 1 ? kParts * kTile : 0);
  // FOLD: each side multiplies its own block's v; DIAG/CROSS: rows take
  // v_b (the column bodies), reactions v_a (the row bodies).
  const __nv_bfloat16* V = ((side == 0) == fold) ? Va : Vb;

  wmma::fragment<wmma::accumulator, 32, 8, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const __nv_bfloat16* Wp = Wt + p * kTile;
#pragma unroll 2
    for (int k = 0; k < T / 16; ++k) {
      wmma::fragment<wmma::matrix_b, 32, 8, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, V + k * 16 * 8, 8);
      if (rows) {
        wmma::fragment<wmma::matrix_a, 32, 8, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Wp + m * 32 * LD + k * 16, LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      if (cols) {
        wmma::fragment<wmma::matrix_a, 32, 8, 16, __nv_bfloat16,
                       wmma::col_major> at;
        wmma::load_matrix_sync(at, Wp + k * 16 * LD + m * 32, LD);
        wmma::mma_sync(acc, at, b, acc);
      }
    }
  }
  float* c_tile = scratch + warp * 32 * 8;
  wmma::store_matrix_sync(c_tile, acc, 8, wmma::mem_row_major);
  __syncwarp();
  float* dst = (side == 0 ? acc_a + static_cast<size_t>(bi) * T * 8
                          : acc_b + static_cast<size_t>(bj) * T * 8) +
               m * 32 * 8;
  for (int t = lane; t < 32 * 8; t += 32) atomicAdd(dst + t, c_tile[t]);
}

template <int T, bool kSplit>
int launch(const int* slots, int n_slots, const float* pos_a,
           const float* pos_b, const float* v_a, const float* v_b,
           float* acc_a, float* acc_b, float softening, int fast,
           int mask_offdiag, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, kSplit>();
  cudaError_t err = cudaFuncSetAttribute(
      slot_pipe_kernel<T, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  slot_pipe_kernel<T, kSplit><<<n_slots, kThreads, smem, stream>>>(
      slots, pos_a, pos_b, v_a, v_b, acc_a, acc_b, softening, fast,
      mask_offdiag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// slots (n_slots, 3) int32 (kind, bi, bj); pos_a/pos_b (c, 3), v_a/v_b
// (c, 8), acc_a/acc_b (c, 8) fp32 row-major with c a multiple of tile; all
// contiguous on the current device. The sums are ADDED into acc_a/acc_b.
// tile: 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int slot_pipe_launch(const int* slots, int n_slots,
                                const float* pos_a, const float* pos_b,
                                const float* v_a, const float* v_b,
                                float* acc_a, float* acc_b, int tile,
                                float softening, int fast, int split_w,
                                int mask_offdiag, void* stream) {
  if (n_slots == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64 && !split_w)
    return launch<64, false>(slots, n_slots, pos_a, pos_b, v_a, v_b, acc_a,
                             acc_b, softening, fast, mask_offdiag, s);
  if (tile == 64 && split_w)
    return launch<64, true>(slots, n_slots, pos_a, pos_b, v_a, v_b, acc_a,
                            acc_b, softening, fast, mask_offdiag, s);
  if (tile == 128 && !split_w)
    return launch<128, false>(slots, n_slots, pos_a, pos_b, v_a, v_b, acc_a,
                              acc_b, softening, fast, mask_offdiag, s);
  if (tile == 128 && split_w)
    return launch<128, true>(slots, n_slots, pos_a, pos_b, v_a, v_b, acc_a,
                             acc_b, softening, fast, mask_offdiag, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
