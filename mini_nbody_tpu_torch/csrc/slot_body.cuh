// The per-slot bodies of the pair-once force kernels, shared by K3
// (csrc/symmetric_force.cu, the fp32 class), K2 (csrc/slot_pipe.cu, the
// bf16 class) and B15 (csrc/resident_sym.cu, which runs them every step of
// a trajectory), so the resident forces are the streamed forces' arithmetic.
//
// One slot (kind, bi, bj) of the slot + fold geometry (ops/slot_pipe.py
// tri_slot_list): rows are block bi of side a, columns block bj of side b.
//   DIAG  (bi == bj): row sums only; the diagonal block's rows cover both
//         orders of each pair.
//   CROSS: rows to block bi (side 0), reactions to block bj (side 1).
//   FOLD  (bj == bi + 1): entry (r, c) is pair (a_r, a_c) for c < r and
//         (b_r, b_c) for c > r; each side's rows and reactions go to its own
//         block.
// Each body stores the slot's two partial tiles (side 0: block bi, side 1:
// block bj; a DIAG slot writes side 0 only) at `out`, for the slot-order
// reduction (ordered_sum, in csrc/slot_reduce.cu or B15's reduce phase).
//
// kPads (B15 only): w is zeroed on every pair where either body's
// system-local index is n_real or more. The streamed kernels drop the pad
// rows after every pass; B15 integrates them, so a pad must never gain a
// force. The streamed kernels instantiate kPads = false, which compiles to
// the code they had.
//
// The caller keeps every thread of the CTA in the call (the bodies hold
// __syncthreads) and syncs before it reuses the shared memory for the next
// slot. Built without --use_fast_math: nvcc contracts the mul/add pairs
// into FMAs, which the plain PyTorch versions do not do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace slot_body {

constexpr int kSlotDiag = 0;
constexpr int kSlotFold = 2;

// The slot-order sum of one element of a target's partials: entries[e0 ..
// e1) are its tiles in slot order, base points at the element in tile 0.
// The sum starts at 0 and adds them in list order; kUnroll loads are in
// flight before their adds, so a long list costs one load latency per
// kUnroll adds (csrc/slot_reduce.cu and B15's reduce phase).
constexpr int kUnroll = 8;

__device__ __forceinline__ float ordered_sum(const float* __restrict__ base,
                                             const int* __restrict__ entries,
                                             int e, int e1,
                                             long long tile_elems) {
  float s = 0.f;
  for (; e + kUnroll <= e1; e += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = base[entries[e + u] * tile_elems];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += v[u];
  }
  for (; e < e1; ++e) s += base[entries[e] * tile_elems];
  return s;
}

// Whether pair (r, c) of a slot touches a pad: the row body is in block
// bi, the column body in bj, except in a fold, where both are in bi below
// the diagonal and in bj above it.
template <int T>
__device__ __forceinline__ bool pad_pair(bool fold, int bi, int bj, int r,
                                         int c, int n_real) {
  const int rb = (fold && c > r) ? bj : bi;
  const int cb = fold ? rb : bj;
  return rb * T + r >= n_real || cb * T + c >= n_real;
}

// ------------------------------------------------- fp32 class (K3) ---
//
// One CTA of 2T threads. Per unordered pair: w = rsqrt(r2^3) (kFast) or
// rsqrt(r2)^3, r2 = |d|^2 + softening, d = p_c - p_r; rows
// F_r += d w (m_c), reactions F_c -= d w (m_r). Stage both blocks
// (x, y, z[, m]), compute the T x T w tile once into shared memory (rows
// padded to T + 1 floats, so the row pass, one thread per row, and the
// column pass, one thread per column, read it without bank conflicts), then
// run the row pass on threads [0, T) and the column pass on [T, 2T).

template <int T>
constexpr size_t fp32_smem_bytes() {
  return (T * (T + 1) + 8 * T) * sizeof(float);  // w tile + two 4 x T blocks
}

// f += sum over c in [c0, c1) of (Q[c] - P[r]) w(r, c) [* m_Q[c]]: the row
// sums of body P[r] against partners Q[c]. P, Q: 4 x T (x, y, z, m).
template <int T, bool kMass>
__device__ __forceinline__ void fp32_row_sums(const float* Wr,
                                              const float* P, const float* Q,
                                              int r, int c0, int c1,
                                              float* f) {
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
__device__ __forceinline__ void fp32_col_sums(const float* W, const float* P,
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

// pos_a / pos_b: the (rows, K) positions (x, y, z[, m]) of the slot's
// system; out: its two (T, 3) partial tiles.
template <int T, int K, bool kFast, bool kPads>
__device__ __forceinline__ void fp32_slot(int kind, int bi, int bj,
                                          const float* __restrict__ pos_a,
                                          const float* __restrict__ pos_b,
                                          float* out, float softening,
                                          int n_real, float* smem) {
  constexpr int LD = T + 1;
  constexpr bool kMass = K == 4;
  float* W = smem;          // T x LD
  float* pa = W + T * LD;   // 4 x T, block bi
  float* pb = pa + 4 * T;   // 4 x T, block bj
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
    if (kPads && pad_pair<T>(fold, bi, bj, r, c, n_real)) w = 0.f;
    W[r * LD + c] = w;
  }
  __syncthreads();

  float s[3] = {0.f, 0.f, 0.f}, s2[3] = {0.f, 0.f, 0.f};
  if (!fold) {
    if (threadIdx.x < T) {  // row pass
      const int r = threadIdx.x;
      fp32_row_sums<T, kMass>(W + r * LD, pa, pb, r, 0, T, s);
      for (int k = 0; k < 3; ++k) out[r * 3 + k] = s[k];
    } else if (kind != kSlotDiag) {  // column pass
      const int c = threadIdx.x - T;
      fp32_col_sums<T, kMass>(W, pa, pb, c, 0, T, s);
      for (int k = 0; k < 3; ++k) out[(T + c) * 3 + k] = -s[k];
    }
    return;
  }
  // FOLD: the row pass stores both sides' row sums, then the column pass
  // adds its sums to the same tiles.
  if (threadIdx.x < T) {
    const int r = threadIdx.x;
    const float* Wr = W + r * LD;
    fp32_row_sums<T, kMass>(Wr, pa, pa, r, 0, r, s);
    fp32_row_sums<T, kMass>(Wr, pb, pb, r, r + 1, T, s2);
    for (int k = 0; k < 3; ++k) {
      out[r * 3 + k] = s[k];
      out[(T + r) * 3 + k] = s2[k];
    }
  } else {
    const int c = threadIdx.x - T;
    fp32_col_sums<T, kMass>(W, pa, pa, c, c + 1, T, s);
    fp32_col_sums<T, kMass>(W, pb, pb, c, 0, c, s2);
  }
  __syncthreads();
  if (threadIdx.x >= T) {
    const int c = threadIdx.x - T;
    for (int k = 0; k < 3; ++k) {
      out[c * 3 + k] -= s[k];
      out[(T + c) * 3 + k] -= s2[k];
    }
  }
}

// ------------------------------------------------- bf16 class (K2) ---
//
// One CTA of kMxuThreads threads. w in fp32 once per pair (masked where
// d2 == 0 in DIAG slots, in CROSS and FOLD slots iff mask_offdiag; the
// fold's self diagonal always), rounded to bf16 into shared memory (rows
// padded to T + 8), then each warp owns one 32-row output tile of one side
// and runs m32n8k16 wmma products over the tile's T columns against the
// (T, 8) operand v = [vhi | vlo] of the other side (rows) or of its own
// (reactions, through col_major loads of the same tile; fold: both).

constexpr int kMxuThreads = 256;
constexpr int kMxuWarps = kMxuThreads / 32;

template <int T, bool kSplit>
constexpr size_t mxu_smem_bytes() {
  constexpr int kParts = kSplit ? 2 : 1;
  return 2 * kParts * T * (T + 8) * sizeof(__nv_bfloat16)  // W tiles
         + 2 * T * 8 * sizeof(__nv_bfloat16)               // v_a, v_b
         + 6 * T * sizeof(float);                          // positions
}

// pos_a / pos_b (rows, 3) and v_a / v_b (rows, 8) of the slot's system;
// out: its two (T, 8) partial tiles.
template <int T, bool kSplit, bool kPads>
__device__ __forceinline__ void mxu_slot(int kind, int bi, int bj,
                                         const float* __restrict__ pos_a,
                                         const float* __restrict__ pos_b,
                                         const float* __restrict__ v_a,
                                         const float* __restrict__ v_b,
                                         float* out, float softening,
                                         int fast, int mask_offdiag,
                                         int n_real, unsigned char* smem) {
  using namespace nvcuda;
  constexpr int LD = T + 8;
  constexpr int kParts = kSplit ? 2 : 1;
  constexpr int kTile = T * LD;
  constexpr int kMTiles = T / 32;
  static_assert(2 * kMTiles <= kMxuWarps, "one warp per 32-row output tile");

  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Va = W + 2 * kParts * kTile;
  __nv_bfloat16* Vb = Va + T * 8;
  float* xa = reinterpret_cast<float*>(Vb + T * 8);
  float* ya = xa + T;
  float* za = ya + T;
  float* xb = za + T;
  float* yb = xb + T;
  float* zb = yb + T;

  const bool fold = kind == kSlotFold;
  const bool mask = kind == kSlotDiag || mask_offdiag;

  const float* pa = pos_a + static_cast<size_t>(bi) * T * 3;
  const float* pb = pos_b + static_cast<size_t>(bj) * T * 3;
  for (int t = threadIdx.x; t < T * 3; t += kMxuThreads) {
    const int r = t / 3, k = t - 3 * (t / 3);
    xa[k * T + r] = pa[t];
    xb[k * T + r] = pb[t];
  }
  const float* va = v_a + static_cast<size_t>(bi) * T * 8;
  const float* vb = v_b + static_cast<size_t>(bj) * T * 8;
  for (int t = threadIdx.x; t < T * 8; t += kMxuThreads) {
    Va[t] = __float2bfloat16_rn(va[t]);
    Vb[t] = __float2bfloat16_rn(vb[t]);
  }
  __syncthreads();

  // Pair weights. Tile 0 holds W (DIAG, CROSS) or W_lo (FOLD); tile 1 holds
  // W_hi (FOLD only).
  for (int e = threadIdx.x; e < T * T; e += kMxuThreads) {
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
    if (kPads && pad_pair<T>(fold, bi, bj, r, c, n_real)) w = 0.f;
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

  // Warp -> (side, 32-row output tile). Side 0's partial belongs to block bi
  // of side a, side 1's to block bj of side b.
  const int warp = threadIdx.x / 32;
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
  wmma::store_matrix_sync(out + (side * T + m * 32) * 8, acc, 8,
                          wmma::mem_row_major);
}

}  // namespace slot_body
