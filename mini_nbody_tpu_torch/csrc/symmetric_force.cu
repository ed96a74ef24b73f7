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
// list and the base pointers the wrapper passes (tri: pos_a == pos_b,
// acc_a == acc_b).
//
// Geometry: the slot + fold geometry of K2 (csrc/slot_pipe.cu,
// ops/slot_pipe.py tri_slot_list), not the TPU band. One CTA of 2T threads
// per slot (kind, bi, bj) from a device int32 (S, 3) list; rows are block bi
// of chunk a, columns block bj of chunk b:
//   DIAG  (bi == bj): row sums only; the T x T diagonal block's rows
//         already cover both orders of each pair (adding its column sums
//         would count every pair twice). d = 0 on the diagonal gives 0.
//   CROSS: rows into acc_a[bi], reactions into acc_b[bj].
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
// Design (simple first): stage block bi and block bj (x, y, z[, m]) in shared
// memory, compute the T x T w tile once into shared memory (rows padded to
// T + 1 floats, so both the row pass, one thread per row, and the column
// pass, one thread per column, read it without bank conflicts), then run the
// row pass on threads [0, T) and the column pass on threads [T, 2T) at the
// same time. At T = 128 the tile and the positions take 70,144 bytes, above
// the 48 KB default, so the launch raises the dynamic shared-memory limit
// first and returns cudaGetLastError(); a refused launch never runs.
//
// Cross-block sums: the TPU carries the whole-chunk reaction buffer across
// its sequential grid; CTAs here run in no order, so each CTA adds its row
// and reaction sums into the (c, 3) fp32 accumulators with atomicAdd
// (6T atomics per slot against T^2 pairs). The order of the atomics changes
// from run to run, so results are not bitwise reproducible; a deterministic
// reduction is ROADMAP B17.
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

namespace {

constexpr int kSlotDiag = 0;
constexpr int kSlotFold = 2;

template <int T>
constexpr size_t smem_bytes() {
  return (T * (T + 1) + 8 * T) * sizeof(float);  // w tile + two 4 x T blocks
}

// f += sum over c in [c0, c1) of (Q[c] - P[r]) w(r, c) [* m_Q[c]]: the row
// sums of body P[r] against partners Q[c]. P, Q: 4 x T (x, y, z, m).
template <int T, bool kMass>
__device__ __forceinline__ void row_sums(const float* Wr, const float* P,
                                         const float* Q, int r, int c0,
                                         int c1, float* f) {
  const float x = P[r], y = P[T + r], z = P[2 * T + r];
  for (int c = c0; c < c1; ++c) {
    float w = Wr[c];
    if (kMass) w *= Q[3 * T + c];
    f[0] += (Q[c] - x) * w;
    f[1] += (Q[T + c] - y) * w;
    f[2] += (Q[2 * T + c] - z) * w;
  }
}

// g += sum over r in [r0, r1) of (Q[c] - P[r]) w(r, c) [* m_P[r]]: the
// reaction sums of body Q[c] (to be subtracted) against partners P[r].
template <int T, bool kMass>
__device__ __forceinline__ void col_sums(const float* W, const float* P,
                                         const float* Q, int c, int r0,
                                         int r1, float* g) {
  constexpr int LD = T + 1;
  const float x = Q[c], y = Q[T + c], z = Q[2 * T + c];
  for (int r = r0; r < r1; ++r) {
    float w = W[r * LD + c];
    if (kMass) w *= P[3 * T + r];
    g[0] += (x - P[r]) * w;
    g[1] += (y - P[T + r]) * w;
    g[2] += (z - P[2 * T + r]) * w;
  }
}

__device__ __forceinline__ void add3(float* dst, const float* v, float s) {
  atomicAdd(dst, s * v[0]);
  atomicAdd(dst + 1, s * v[1]);
  atomicAdd(dst + 2, s * v[2]);
}

// pos_a / pos_b: (c, K) rows (x, y, z[, m]); acc_a / acc_b: (c, 3).
template <int T, int K, bool kFast>
__global__ void __launch_bounds__(2 * T)
    symmetric_force_kernel(const int* __restrict__ slots,
                           const float* __restrict__ pos_a,
                           const float* __restrict__ pos_b, float* acc_a,
                           float* acc_b, float softening) {
  constexpr int LD = T + 1;
  constexpr bool kMass = K == 4;
  extern __shared__ float smem[];
  float* W = smem;          // T x LD
  float* pa = W + T * LD;   // 4 x T, block bi
  float* pb = pa + 4 * T;   // 4 x T, block bj

  const int kind = slots[3 * blockIdx.x];
  const int bi = slots[3 * blockIdx.x + 1];
  const int bj = slots[3 * blockIdx.x + 2];
  const bool fold = kind == kSlotFold;

  const float* ga = pos_a + static_cast<size_t>(bi) * T * K;
  const float* gb = pos_b + static_cast<size_t>(bj) * T * K;
  for (int t = threadIdx.x; t < T * K; t += 2 * T) {
    const int r = t / K, k = t - K * (t / K);
    pa[k * T + r] = ga[t];
    pb[k * T + r] = gb[t];
  }
  __syncthreads();

  // w once per (r, c). Rows are block a and columns block b, except in a
  // fold, where both are block a below the diagonal and block b above it.
  for (int e = threadIdx.x; e < T * T; e += 2 * T) {
    const int r = e / T, c = e % T;
    const float* P = (fold && c > r) ? pb : pa;
    const float* Q = fold ? P : pb;
    const float dx = Q[c] - P[r];
    const float dy = Q[T + c] - P[T + r];
    const float dz = Q[2 * T + c] - P[2 * T + r];
    const float r2 = dx * dx + dy * dy + (dz * dz + softening);
    float w;
    if (kFast) {
      w = rsqrtf((r2 * r2) * r2);
    } else {
      const float inv = rsqrtf(r2);
      w = (inv * inv) * inv;
    }
    W[r * LD + c] = w;
  }
  __syncthreads();

  float s[3] = {0.f, 0.f, 0.f};
  if (threadIdx.x < T) {  // row pass
    const int r = threadIdx.x;
    const float* Wr = W + r * LD;
    if (!fold) {
      row_sums<T, kMass>(Wr, pa, pb, r, 0, T, s);
      add3(acc_a + (static_cast<size_t>(bi) * T + r) * 3, s, 1.f);
    } else {
      row_sums<T, kMass>(Wr, pa, pa, r, 0, r, s);
      add3(acc_a + (static_cast<size_t>(bi) * T + r) * 3, s, 1.f);
      s[0] = s[1] = s[2] = 0.f;
      row_sums<T, kMass>(Wr, pb, pb, r, r + 1, T, s);
      add3(acc_b + (static_cast<size_t>(bj) * T + r) * 3, s, 1.f);
    }
  } else if (kind != kSlotDiag) {  // column pass
    const int c = threadIdx.x - T;
    if (!fold) {
      col_sums<T, kMass>(W, pa, pb, c, 0, T, s);
      add3(acc_b + (static_cast<size_t>(bj) * T + c) * 3, s, -1.f);
    } else {
      col_sums<T, kMass>(W, pa, pa, c, c + 1, T, s);
      add3(acc_a + (static_cast<size_t>(bi) * T + c) * 3, s, -1.f);
      s[0] = s[1] = s[2] = 0.f;
      col_sums<T, kMass>(W, pb, pb, c, 0, c, s);
      add3(acc_b + (static_cast<size_t>(bj) * T + c) * 3, s, -1.f);
    }
  }
}

template <int T, int K, bool kFast>
int launch(const int* slots, int n_slots, const float* pos_a,
           const float* pos_b, float* acc_a, float* acc_b, float softening,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      symmetric_force_kernel<T, K, kFast>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  symmetric_force_kernel<T, K, kFast><<<n_slots, 2 * T, smem, stream>>>(
      slots, pos_a, pos_b, acc_a, acc_b, softening);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int dispatch(const int* slots, int n_slots, const float* pos_a,
             const float* pos_b, float* acc_a, float* acc_b, int k,
             float softening, int fast, cudaStream_t s) {
  if (k == 3 && fast)
    return launch<T, 3, true>(slots, n_slots, pos_a, pos_b, acc_a, acc_b,
                              softening, s);
  if (k == 3)
    return launch<T, 3, false>(slots, n_slots, pos_a, pos_b, acc_a, acc_b,
                               softening, s);
  if (k == 4 && fast)
    return launch<T, 4, true>(slots, n_slots, pos_a, pos_b, acc_a, acc_b,
                              softening, s);
  if (k == 4)
    return launch<T, 4, false>(slots, n_slots, pos_a, pos_b, acc_a, acc_b,
                               softening, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// slots (n_slots, 3) int32 (kind, bi, bj); pos_a / pos_b (rows, k) fp32 with
// k = 3 (unit masses) or 4 (x, y, z, m); acc_a / acc_b (rows, 3) fp32; rows
// of each a multiple of tile; all contiguous on the current device. The
// sums are ADDED into acc_a / acc_b. tile: 64 or 128. Returns
// cudaGetLastError() after the launch.
extern "C" int symmetric_force_launch(const int* slots, int n_slots,
                                      const float* pos_a, const float* pos_b,
                                      float* acc_a, float* acc_b, int k,
                                      int tile, float softening, int fast,
                                      void* stream) {
  if (n_slots == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64)
    return dispatch<64>(slots, n_slots, pos_a, pos_b, acc_a, acc_b, k,
                        softening, fast, s);
  if (tile == 128)
    return dispatch<128>(slots, n_slots, pos_a, pos_b, acc_a, acc_b, k,
                         softening, fast, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
