// B10: the ordered fp32 force VJP, one thread per receiver k.
// B11: the pair-once fp32 force VJP on K3's slot + fold geometry.
// B12: the one-cotangent VJP of the ordered pairs a <- b, each pair once on
//      a cross slot table (B11's slot walk, a wider register micro-tile).
//
// With d = p_j - p_k, s = |d|^2 + softening, inv = rsqrt(s), w = inv^3,
// u = w inv^2 and the cotangent g of F:
//   pos_bar_k = sum_j m_j [-w g_k + 3 u (g_k.d) d]            (receiver)
//             + m_k sum_j [ w g_j - 3 u (g_j.d) d]            (source)
// and with unit masses sum_j [3 u ((g_k - g_j).d) d + w g_j] - g_k sum_j w.
// w and u are zeroed where the pre-softening |d|^2 == 0: at softening 1e-9
// the self pair's eps^-1.5 weight swamps the fp32 sums otherwise.
//
// B10 replaces mini_nbody_tpu/ops/vjp_kernel.py:106 `_vjp_kernel` (reached
// through `vjp_pos_rect`, :635, and `vjp_pos_pallas`, :737). It is bound by
// its issue rate, so its design cuts instructions per pair:
//   - the mass terms fused as the unit-mass formula is:
//       pos_bar_k = 3 sum_j u (m_j dot_k - m_k dot_j) d + m_k sum_j w g_j
//                   - g_k sum_j m_j w,
//     dot_k = g_k.d, dot_j = g_j.d; the 3 and m_k are applied once in the
//     epilogue, so a pair costs three d FMAs, three w g_j FMAs and one
//     m_j w FMA into its receiver's sums (~27 instructions a pair in all,
//     by the count of the source, against ~40 with the halves apart);
//   - register micro-tiles: R receivers per thread (R = 4 where the block
//     keeps whole warps of block / 4 threads, else 2, else 1), so each
//     broadcast load of a source's two float4s serves R pairs and the R
//     chains are independent work for the scheduler;
//   - two loop bodies chosen per tile at compile time: overlap_only (square
//     calls under coincident routing, :130-147) runs the tiles whose j
//     range does not meet the block's k range (k tile and j tile have one
//     size, `block`, so they meet only when they are the same tile) without
//     the compare and select of d2 == 0.
// The sources are staged through shared memory in tiles of `block` (x, y,
// z, m) and (gx, gy, gz) float4s; the Pallas grid's sequential j axis is
// the loop over tiles. Each tile's sums are kept apart from the totals and
// added to them after the tile, so B10's bits depend on `block`, not on R:
// every receiver adds its pairs in the same order at any R. The ragged j
// edge is (FAR, m = 0, g = 0) in shared memory: against FAR w and u
// underflow to 0 and every term is 0, in both mass modes. Receivers past nk
// compute and are not written. rsqrt is rsqrt.approx.ftz (slot_body.cuh
// rsqrt_normal): for any softening >= 2^-126 it is rsqrtf's result, and on a
// denormal r2 w and u overflow to inf either way.
//
// B11 replaces vjp_kernel.py:273 `_sym_vjp_tri_kernel` (`vjp_pos_sym`,
// :406). Per unordered pair (a, b), d = p_b - p_a, its term
//   t = w (m_a g_b - m_b g_a) + c d,  c = 3 u (m_b (g_a.d) - m_a (g_b.d))
// goes to a's row with + and to b's reaction with -; with the mass
// cotangent, -w (g_b.d) goes to a and +w (g_a.d) to b (that term is NOT
// antisymmetric). The slot + fold geometry is K3's
// (csrc/symmetric_force.cu), one slot (kind, bi, bj) at a time:
//   DIAG  (bi == bj): the block's ordered pairs, row sums only (the rows
//         cover both orders), always masked.
//   CROSS: rows to block bi (side a), reactions to block bj (side b).
//   FOLD  (bj == bi + 1): entry (r, c) is pair (a_r, a_c) for c < r and
//         (b_r, b_c) for c > r: two passes over the full tile, one per
//         side, w and u zeroed off the side's triangle and on the diagonal.
// CROSS and FOLD pairs are masked where d2 == 0 iff mask_offdiag. The
// maskless body is a compile-time instantiation whose w and u are the
// masked body's bits (r2 is one FMA chain in both), so 'fast' is bitwise
// 'masked' wherever no d2 == 0 pair is dropped.
//
// Design: K3's register micro-tiles (slot_body.cuh fp32_pass), in place of
// a design that stored each pair's w and c in shared fp32 tiles and
// recomputed d once more for the row side and once for the column side
// (~18 shared loads a pair, half the threads idle on DIAG slots). A CTA of
// (T / 4) (T / 8) threads walks its slots persistently
// (slot_body::stream_width and walk_slots: the next slot's blocks are read
// into registers while the current one computes). Each thread owns 4 rows
// x 8 columns of the tile: its rows' (x, y, z, m) and (gx, gy, gz) in
// registers, each column's read once from shared memory as a broadcast; d,
// w, u and c once per pair in registers, t added to the row's sums and to
// the column's. The columns run in two halves of 4, so their sums take 16
// registers, not 32, for no more shuffles. The lanes that share a row or a
// column halve their sums with shuffles (slot_body::lane_sums) and the
// warps' column partials meet in shared memory, added in increasing warp
// index; no pair costs a shared-memory access. Each CTA stores its two T x
// (3|4) partials (side 0: block bi, side 1: block bj) and
// csrc/slot_reduce.cu adds each block's partials in slot order, so every
// output bit is the same on every run. The TPU's single-launch bound (the
// (3|4, N) VMEM reaction buffer, _SYM_BWD_MAX = 131072) does not apply:
// the wrapper keeps K3's chunk loop, and autodiff routes a CUDA tensor's
// square VJP here (and to B13) at every N.
//
// B9c: blockIdx.y is the system of an ensemble launch, which replaces
// vjp_kernel.py:483 `_vjp_sym_ensemble_impl` (`pallas_call` :527, B11's
// kernel under a leading system axis). Every system runs the same
// system-local slot list over its own rows, sys_rows rows after the previous
// system's; a standalone call is the same kernel with one system, so each
// system's sums are bitwise its standalone call's. gridDim.y is at most
// 65,535. Pads are FAR with zero mass and
// zero cotangent: real-vs-pad terms are exactly 0 and pad-pad terms are
// w (0 - 0) + 0 d = 0.
//
// B12 replaces vjp_kernel.py:831 `_pair_vjp_kernel` (`vjp_pos_pair`, :861,
// `pallas_call` :923), the per-device tile of the 2-D grid backward
// (parallel/sharded.py): with d = p_b - p_a and only a's cotangents g_a,
//   t(a, b) = 3 u m_b (g_a.d) d - w m_b g_a,
//   a_bar[a] = sum_b t(a, b),   b_bar[b] = -sum_a t(a, b),
// d2 == 0 masked (a body present in both sets meets itself). The TPU kernel
// carries b_bar as a whole-B buffer across its sequential grid; here each
// ordered pair is computed once, on B11's design: a cross slot table over
// the row blocks of a and the column blocks of b (slot_pipe.slot_table with
// nb_b), walked persistently (walk_slots) by CTAs of 4 x 16 register
// micro-tiles, each slot's two (T, 3) partials (a_bar rows, b_bar columns)
// stored for csrc/slot_reduce.cu, which adds them in slot order: every
// output bit is the same on every run. t is B11's term with g_b = 0, and
// its body is B11's specialised to it (pair_pass): per pair d and r2 as one
// FMA chain, rsqrt_normal, w' = m_b w and u' = m_b u, one dot product and
// ud = u' (g_a.d); the rows sum ud d and w', the columns ud d and w' g_a,
// and the 3 and g_a are applied once per slot: ~29 instructions a pair by
// the source's count, 37.3 a pair over the slot loop's SASS with the
// per-slot combining (ab_slots.py). The 4 x 16 micro-tile spreads that
// combining over 64 pairs a thread; 4 x 8 (39.8 a pair), 4 x 32 and tile 64
// measured slower (PERF.md, the B12 sweep), so the tile is 128 alone. The
// mask is the plain version's d2 == 0 (its squares rounded apart, then
// added): that holds iff every |d_i| <= 2^-75, whose square rounds to 0, so
// the kernel compares the largest |d_i| with 2^-75 and zeroes inv, so w'
// and u'.
// Pads are FAR with zero cotangent (rows) and zero mass (columns): every
// term against a pad is exactly 0, so ragged sets need no branch.
//
// What bounds them on an H100: fp32 arithmetic. B10: ~35 fp32 operations and
// one rsqrt per ordered pair (JAX's count, vjp_kernel.py:656), and in fact
// its issue rate (~27 instructions a pair). B11: JAX counts 44 per
// unordered pair; its issue rate bounds it too, at 36-43 instructions a pair
// by the count of its SASS (ab_slots.py), with 128 registers a thread and 16
// warps per SM (4 CTAs of 128 threads at T = 64, one of 512 at T = 128). Its
// dynamic shared memory is the staged blocks, the row totals and the warps'
// column partials: 7,936 bytes at T = 64 (9,216 with the mass cotangent) and
// 34,304 at T = 128 (43,008); the launch raises the dynamic limit first and
// returns cudaGetLastError(). B12: JAX counts 26 per ordered pair
// (vjp_kernel.py:944); its issue rate bounds it as B11's does: 128
// registers a thread, 16 warps per SM (2 CTAs of (T / 4) (T / 16) = 256
// threads), 19,968 bytes of dynamic shared memory; the per-slot combining
// of its sums, spread over a thread's 64 pairs, and its partials (24 / T
// bytes a pair, 12.9 GB at 262,144^2) cost the rest.
//
// Built without --use_fast_math (see direct_force.cu); nvcc contracts the
// mul/add pairs into FMAs, which the plain PyTorch version does not do.

#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

constexpr float kFar = 1.0e18f;
constexpr int kSlotDiag = 0;
constexpr int kSlotFold = 2;

// ---------------------------------------------------------------- B10 ---

// A receiver of B10 in registers: position, cotangent and mass.
struct Receiver {
  float x, y, z, gx, gy, gz, m;
};

// A receiver's sums: t = sum u (m_j dot_k - m_k dot_j) d, s = sum w g_j,
// sw = sum m_j w.
struct Sums {
  float t0, t1, t2, s0, s1, s2, sw;
};

__device__ __forceinline__ void add_sums(Sums& a, const Sums& b) {
  a.t0 += b.t0;
  a.t1 += b.t1;
  a.t2 += b.t2;
  a.s0 += b.s0;
  a.s1 += b.s1;
  a.s2 += b.s2;
  a.sw += b.sw;
}

// One j tile of n staged sources into each of the R receivers' fresh
// partials. kD2: the tile may hold a d2 == 0 pair, masked. r2 is formed by
// one FMA chain in both bodies (the masked one computes d2 for its select
// on the side), so w and u are the same bits with and without the mask.
template <int R, bool kMass, bool kD2>
__device__ __forceinline__ void ordered_tile(const float4* sp,
                                             const float4* sg, int n,
                                             const Receiver (&rk)[R],
                                             Sums (&p)[R], float softening) {
#pragma unroll
  for (int r = 0; r < R; ++r) p[r] = Sums{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int c = 0; c < n; ++c) {
    const float4 q = sp[c], h = sg[c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const Receiver& k = rk[r];
      const float dx = q.x - k.x, dy = q.y - k.y, dz = q.z - k.z;
      const float inv = slot_body::rsqrt_normal(
          fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, softening))));
      const float inv2 = inv * inv;
      float w = inv2 * inv;
      float u = w * inv2;
      if (kD2 && dx * dx + dy * dy + dz * dz == 0.f) w = u = 0.f;
      const float dot_k = k.gx * dx + k.gy * dy + k.gz * dz;
      const float dot_j = h.x * dx + h.y * dy + h.z * dz;
      const float coeff =
          u * (kMass ? q.w * dot_k - k.m * dot_j : dot_k - dot_j);
      Sums& a = p[r];
      a.t0 += coeff * dx;
      a.t1 += coeff * dy;
      a.t2 += coeff * dz;
      a.s0 += w * h.x;
      a.s1 += w * h.y;
      a.s2 += w * h.z;
      a.sw += kMass ? q.w * w : w;
    }
  }
}

// Receivers per thread of a B10 block of `block` receivers: 4 where the
// block keeps whole warps, else 2, else 1 (PERF.md: R = 4 with the
// source loop unrolled twice was the fastest of R in {2, 4} and unroll in
// {1, 2, 4} at block 512).
__host__ __device__ constexpr int ordered_r(int block) {
  return block % 128 == 0 ? 4 : (block % 64 == 0 ? 2 : 1);
}

// B10: block / R threads per block of `block` receivers, thread i owning
// receivers k0 + i + (block / R) r, r < R; the sources come through shared
// memory in tiles of `block` (the j tile is the k tile's size, so the two
// ranges meet only in the CTA's own tile). At most 128 registers where R > 1
// (R = 4: up to 256 threads, two CTAs of them per SM at least).
template <int R, bool kMass>
__global__ void __launch_bounds__(1024 / R, R == 4 ? 2 : 1)
    vjp_ordered_kernel(const float* __restrict__ pos_k,
                       const float* __restrict__ g_k,
                       const float* __restrict__ mass_k, int nk,
                       const float* __restrict__ pos_j,
                       const float* __restrict__ g_j,
                       const float* __restrict__ mass_j, int nj,
                       float* __restrict__ out, float softening,
                       int overlap_only) {
  extern __shared__ float4 smem4[];
  const int threads = blockDim.x, block = R * threads;
  float4* sp = smem4;          // (x, y, z, m) of the j tile
  float4* sg = smem4 + block;  // (gx, gy, gz, 0)
  const int k0 = blockIdx.x * block;
  Receiver rk[R];
  Sums tot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = k0 + threadIdx.x + r * threads;
    Receiver& k = rk[r];
    k = Receiver{kFar, kFar, kFar, 0.f, 0.f, 0.f, 1.f};
    if (i < nk) {
      k.x = pos_k[3 * i];
      k.y = pos_k[3 * i + 1];
      k.z = pos_k[3 * i + 2];
      k.gx = g_k[3 * i];
      k.gy = g_k[3 * i + 1];
      k.gz = g_k[3 * i + 2];
      if (kMass) k.m = mass_k[i];
    }
    tot[r] = Sums{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  for (int base = 0; base < nj; base += block) {
    __syncthreads();  // every thread is done with the previous tile
    for (int c = threadIdx.x; c < block; c += threads) {
      const int j = base + c;
      float4 p = make_float4(kFar, kFar, kFar, 0.f);
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nj) {
        p = make_float4(pos_j[3 * j], pos_j[3 * j + 1], pos_j[3 * j + 2],
                        kMass ? mass_j[j] : 1.f);
        h = make_float4(g_j[3 * j], g_j[3 * j + 1], g_j[3 * j + 2], 0.f);
      }
      sp[c] = p;
      sg[c] = h;
    }
    __syncthreads();
    // Each tile's partials are added to the totals after the tile: one
    // running fp32 sum over all N partners drifts from the exact sum by
    // several 1e-4 of the output's scale at N = 262,144.
    Sums part[R];
    if (!overlap_only || base == k0)
      ordered_tile<R, kMass, true>(sp, sg, block, rk, part, softening);
    else
      ordered_tile<R, kMass, false>(sp, sg, block, rk, part, softening);
#pragma unroll
    for (int r = 0; r < R; ++r) add_sums(tot[r], part[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = k0 + threadIdx.x + r * threads;
    if (i >= nk) continue;
    const Receiver& k = rk[r];
    const Sums& a = tot[r];
    out[3 * i] = (3.f * a.t0 - k.gx * a.sw) + k.m * a.s0;
    out[3 * i + 1] = (3.f * a.t1 - k.gy * a.sw) + k.m * a.s1;
    out[3 * i + 2] = (3.f * a.t2 - k.gz * a.sw) + k.m * a.s2;
  }
}

using OrderedKernel = void (*)(const float*, const float*, const float*, int,
                               const float*, const float*, const float*, int,
                               float*, float, int);

// B10's kernel for (block, masses) and its threads per block, or nullptr.
OrderedKernel pick_ordered(int block, bool masses, int* threads) {
  if (block <= 0 || block > 1024 || block % 32 != 0) return nullptr;
  const int r = ordered_r(block);
  *threads = block / r;
  if (r == 4) return masses ? vjp_ordered_kernel<4, true>
                            : vjp_ordered_kernel<4, false>;
  if (r == 2) return masses ? vjp_ordered_kernel<2, true>
                            : vjp_ordered_kernel<2, false>;
  return masses ? vjp_ordered_kernel<1, true> : vjp_ordered_kernel<1, false>;
}

// ---------------------------------------------------------------- B11 ---

// Each thread owns kSymR x kSymC pairs of the T x T slot tile: rows ty + Gr
// i (i < kSymR, Gr = T / kSymR) and columns tx + Gc j (j < kSymC, Gc = T /
// kSymC). A body takes 7 floats, so 4 rows (28 registers), their sums and 8
// columns' sums fit 128 registers; K3's 8 x 8 would not.
constexpr int kSymR = 4, kSymC = 8;
// Warps per SM B11 is compiled for (at most 128 registers a thread).
constexpr int kSymWarps = 16;

template <int T>
__host__ __device__ constexpr int sym_threads() {
  return (T / kSymR) * (T / kSymC);
}

template <int T, int KO>
constexpr size_t sym_smem_bytes() {
  // two staged blocks ((x, y, z, m) and (gx, gy, gz, 0) float4s per body),
  // a pass's row totals and the warps' column partials, KO floats a body
  return 4 * T * sizeof(float4) +
         (1 + sym_threads<T>() / 32) * T * KO * sizeof(float);
}

// One block's positions (K floats a body) and cotangents (3; none without
// kCot) in registers: load() reads them from device memory, store() writes
// them to shared float4s, (x, y, z, m) at sp and (gx, gy, gz, -) at sg (the
// unit-mass kernels read no m).
template <int T, int K, bool kCot = true, int kThreads = sym_threads<T>()>
struct SymBlock {
  static constexpr int kP = (T * K + kThreads - 1) / kThreads;
  static constexpr int kG = kCot ? (T * 3 + kThreads - 1) / kThreads : 0;
  float p[kP], g[kG > 0 ? kG : 1];

  __device__ __forceinline__ void load(const float* __restrict__ pos,
                                       const float* __restrict__ gr) {
#pragma unroll
    for (int l = 0; l < kP; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < T * K) p[l] = pos[t];
    }
#pragma unroll
    for (int l = 0; l < kG; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < T * 3) g[l] = gr[t];
    }
  }

  __device__ __forceinline__ void store(float* sp, float* sg) const {
#pragma unroll
    for (int l = 0; l < kP; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < T * K) sp[4 * (t / K) + t % K] = p[l];
    }
#pragma unroll
    for (int l = 0; l < kG; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < T * 3) sg[4 * (t / 3) + t % 3] = g[l];
    }
  }
};

// One pass of B11 over the T x T pairs of block P (rows: positions P,
// cotangents PG) against block Q (columns): each thread's pairs in
// registers, w, u and c once per pair, its term t added to the row's sums
// and (kCols) to the column's; with KO = 4 the mass cotangent, -w (g_Q.d)
// to the row and +w (g_P.d) to the column, as a 4th sum. Then the lanes
// that share a row (lane bits [0, log2 Gc)) halve their sums (lane_sums)
// and one writes the row's total to rows (T x KO); the lanes that share a
// column (bits [log2 Gc, 5)) halve theirs and each warp stores its column
// partials to cols (warps x T x KO); a barrier. kD2 zeroes w and u where
// d2 == 0, kTri off the fold pass's triangle `tri`. r2 is one FMA chain in
// both bodies, so a pair's w and u are the same bits with and without kD2.
template <int T, int K, int KO, bool kCols, bool kTri, bool kD2>
__device__ __forceinline__ void sym_pass(const float4* P, const float4* PG,
                                         const float4* Q, const float4* QG,
                                         int tri, float softening,
                                         float* rows, float* cols) {
  constexpr int R = kSymR, C = kSymC;
  constexpr int Gr = T / R, Gc = T / C;
  constexpr int kLogC = T == 128 ? 4 : 3;
  static_assert(Gc == 1 << kLogC, "tile 64 or 128");
  constexpr bool kMass = K == 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & (Gc - 1), ty = threadIdx.x >> kLogC;

  float4 p[R];
  float3 h[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    p[i] = P[ty + Gr * i];
    const float4 hg = PG[ty + Gr * i];
    h[i] = make_float3(hg.x, hg.y, hg.z);
  }
  float f[R][KO];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < KO; ++k) f[i][k] = 0.f;

  // The columns in two halves of kSymC / 2: a half's column sums are
  // combined and stored before the next half starts, which halves their
  // registers and costs no more shuffles.
  constexpr int H = C / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s[H][KO];
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int k = 0; k < KO; ++k) s[j][k] = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const int c = tx + Gc * (H * half + j);
      const float4 q = Q[c], hq = QG[c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dx = q.x - p[i].x, dy = q.y - p[i].y, dz = q.z - p[i].z;
        const float inv = slot_body::rsqrt_normal(
            fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, softening))));
        const float inv2 = inv * inv;
        float w = inv2 * inv, u = w * inv2;
        if (kD2 && dx * dx + dy * dy + dz * dz == 0.f) w = u = 0.f;
        if (kTri && slot_body::off_triangle(tri, ty + Gr * i, c))
          w = u = 0.f;
        const float dot_a = h[i].x * dx + h[i].y * dy + h[i].z * dz;
        const float dot_b = hq.x * dx + hq.y * dy + hq.z * dz;
        const float cc = 3.f * (u * (kMass ? q.w * dot_a - p[i].w * dot_b
                                           : dot_a - dot_b));
        float t[3];
        if (kMass) {
          const float wa = w * p[i].w, wb = w * q.w;
          t[0] = cc * dx + (wa * hq.x - wb * h[i].x);
          t[1] = cc * dy + (wa * hq.y - wb * h[i].y);
          t[2] = cc * dz + (wa * hq.z - wb * h[i].z);
        } else {
          t[0] = cc * dx + w * (hq.x - h[i].x);
          t[1] = cc * dy + w * (hq.y - h[i].y);
          t[2] = cc * dz + w * (hq.z - h[i].z);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          f[i][k] += t[k];
          if (kCols) s[j][k] += t[k];
        }
        if (KO == 4) {
          f[i][3] -= w * dot_b;
          if (kCols) s[j][3] += w * dot_a;
        }
      }
    }
    if (kCols) {
      constexpr int kLeft = H >> (5 - kLogC);  // columns a lane keeps
      int coff = 0;
      bool unused = true;  // halving steps only: every lane keeps its own
      slot_body::lane_sums<H, kLogC, 5 - kLogC>(s, lane, coff, unused);
      float* cw = cols + warp * T * KO;
#pragma unroll
      for (int j = 0; j < kLeft; ++j)
#pragma unroll
        for (int k = 0; k < KO; ++k)
          cw[(tx + Gc * (H * half + coff + j)) * KO + k] = s[j][k];
    }
  }

  int off = 0;
  bool writer = true;
  slot_body::lane_sums<R, 0, kLogC>(f, lane, off, writer);
  if (writer)
#pragma unroll
    for (int k = 0; k < KO; ++k) rows[(ty + Gr * off) * KO + k] = f[0][k];
  __syncthreads();
}

// The slot's passes on its staged blocks; out: its two (T, KO) partial
// tiles. A reaction's position columns are the negated column sums, its
// mass cotangent the column sum itself; the warps' column partials are
// added in increasing warp index.
template <int T, int K, int KO>
__device__ __forceinline__ void sym_compute(int kind, int mask_offdiag,
                                            float* out, float softening,
                                            float* smem) {
  constexpr int kThreads = sym_threads<T>(), kWarps = kThreads / 32;
  const float4* pa = reinterpret_cast<const float4*>(smem);
  const float4* ga = pa + T;
  const float4* pb = pa + 2 * T;
  const float4* gb = pa + 3 * T;
  float* rows = smem + 16 * T;
  float* cols = rows + T * KO;
  // The reaction of element e (body e / KO, column e % KO).
  auto reaction = [&](int e) {
    float s = cols[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += cols[w * T * KO + e];
    return e % KO < 3 ? -s : s;
  };
  if (kind == kSlotFold) {
    // Side a's triangle (c < r), then side b's (c > r): rows + reactions.
    if (mask_offdiag)
      sym_pass<T, K, KO, true, true, true>(pa, ga, pa, ga, 1, softening,
                                           rows, cols);
    else
      sym_pass<T, K, KO, true, true, false>(pa, ga, pa, ga, 1, softening,
                                            rows, cols);
    for (int e = threadIdx.x; e < T * KO; e += kThreads)
      out[e] = rows[e] + reaction(e);
    __syncthreads();
    if (mask_offdiag)
      sym_pass<T, K, KO, true, true, true>(pb, gb, pb, gb, 2, softening,
                                           rows, cols);
    else
      sym_pass<T, K, KO, true, true, false>(pb, gb, pb, gb, 2, softening,
                                            rows, cols);
    for (int e = threadIdx.x; e < T * KO; e += kThreads)
      out[T * KO + e] = rows[e] + reaction(e);
  } else if (kind == kSlotDiag) {
    // The block's ordered pairs, rows only (they cover both orders).
    sym_pass<T, K, KO, false, false, true>(pa, ga, pb, gb, 0, softening,
                                           rows, cols);
    for (int e = threadIdx.x; e < T * KO; e += kThreads) out[e] = rows[e];
  } else {
    if (mask_offdiag)
      sym_pass<T, K, KO, true, false, true>(pa, ga, pb, gb, 0, softening,
                                            rows, cols);
    else
      sym_pass<T, K, KO, true, false, false>(pa, ga, pb, gb, 0, softening,
                                             rows, cols);
    for (int e = threadIdx.x; e < T * KO; e += kThreads) {
      out[e] = rows[e];
      out[T * KO + e] = reaction(e);
    }
  }
}

// pos_a / pos_b: (c, K) rows (x, y, z[, m]); g_a / g_b: (c, 3); part: 2
// (T, KO) tiles per slot and system, KO = 4 with the mass cotangent. Each
// CTA walks its slots (slot_body::walk_slots), loading the next slot's
// blocks into registers while it computes one.
template <int T, int K, int KO>
__global__ void __launch_bounds__(
    sym_threads<T>(), slot_body::stream_min_ctas(sym_threads<T>(), kSymWarps))
    vjp_sym_kernel(const int* __restrict__ slots, int n_slots,
                   const float* __restrict__ pos_a,
                   const float* __restrict__ pos_b,
                   const float* __restrict__ g_a,
                   const float* __restrict__ g_b, float* part,
                   long long sys_rows, float softening, int mask_offdiag) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.y;
  pos_a += sys * sys_rows * K;
  pos_b += sys * sys_rows * K;
  g_a += sys * sys_rows * 3;
  g_b += sys * sys_rows * 3;
  SymBlock<T, K> a, b;
  slot_body::walk_slots(
      slots, n_slots,
      [&](const slot_body::Slot& sl) {
        a.load(pos_a + static_cast<size_t>(sl.bi) * T * K,
               g_a + static_cast<size_t>(sl.bi) * T * 3);
        b.load(pos_b + static_cast<size_t>(sl.bj) * T * K,
               g_b + static_cast<size_t>(sl.bj) * T * 3);
      },
      [&] {
        a.store(smem, smem + 4 * T);
        b.store(smem + 8 * T, smem + 12 * T);
      },
      [&](const slot_body::Slot& sl, int s) {
        // Side 0's tile (block bi), then side 1's (block bj).
        float* out = part + (sys * n_slots + s) * 2 * T * KO;
        sym_compute<T, K, KO>(sl.kind, mask_offdiag, out, softening, smem);
      });
}

using SymKernel = void (*)(const int*, int, const float*, const float*,
                           const float*, const float*, float*, long long,
                           float, int);

// B11's kernel for (tile, k, ko), its threads per CTA and dynamic shared
// memory, or nullptr.
SymKernel pick_sym(int tile, int k, int ko, int* threads, size_t* smem) {
#define NBODY_PICK_SYM(T)                                              \
  if (tile == T) {                                                     \
    *threads = sym_threads<T>();                                       \
    *smem = ko == 4 ? sym_smem_bytes<T, 4>() : sym_smem_bytes<T, 3>(); \
    if (k == 3 && ko == 3) return vjp_sym_kernel<T, 3, 3>;             \
    if (k == 4 && ko == 3) return vjp_sym_kernel<T, 4, 3>;             \
    if (k == 4 && ko == 4) return vjp_sym_kernel<T, 4, 4>;             \
    return nullptr;                                                    \
  }
  NBODY_PICK_SYM(64)
  NBODY_PICK_SYM(128)
#undef NBODY_PICK_SYM
  return nullptr;
}

// ---------------------------------------------------------------- B12 ---

// B12's tile, and its micro-tile: kPairR rows x kPairC columns a thread,
// the columns in groups of 4 (64 pairs a thread per slot, so the per-slot
// work of combining the sums is spread over twice B11's pairs).
constexpr int kPairTile = 128;
constexpr int kPairR = 4, kPairC = 16;
// The largest |d_i| whose square rounds to 0 in fp32 (2^-150 is a tie
// between 0 and 2^-149, rounded to even): d2 == 0 iff max |d_i| <= this.
constexpr float kD2Zero = 0x1p-75f;

template <int T>
__host__ __device__ constexpr int pair_threads() {
  return (T / kPairR) * (T / kPairC);
}

// One pass of B12 over the T x T ordered pairs of row block A (positions,
// cotangents AG) and column block B ((x, y, z[, m])): thread (ty, tx) owns
// rows ty + Gr i (i < kPairR) in registers and columns tx + Gc j (j <
// kPairC), read once each from shared memory, in groups of 4. Per pair,
// with d = p_b - p_a, w' = m_b w and u' = m_b u:
//   ud = u' (g_a.d);  rows += (ud d, w');  columns += (ud d, w' g_a).
// inv is zeroed where the plain version's d2 == 0 (every |d_i| <= kD2Zero;
// then w' and u' are 0 and so is every term). After a group the
// thread forms its columns' b_bar partials, w'g_a sums - 3 ud d sums, the
// lanes that share a column (bits [log2 Gc, 5)) combine them (lane_sums)
// and each warp stores its column partials to cols (warps x T x 3); after
// the groups its rows' a_bar partials, 3 ud d sums - g_a w' sums, are
// combined across the lanes that share a row (bits [0, log2 Gc)) and one
// lane writes each row's total to rows (T x 3). Then a barrier.
template <int T, bool kMass>
__device__ __forceinline__ void pair_pass(const float4* A, const float4* AG,
                                          const float4* B, float softening,
                                          float* rows, float* cols) {
  constexpr int R = kPairR, H = 4, kGroups = kPairC / H;
  constexpr int Gr = T / R, Gc = T / kPairC;
  constexpr int kLogC = 3;
  static_assert(Gc == 1 << kLogC, "tile 128");
  constexpr int kColBits = 5 - kLogC;
  // the columns a lane keeps of a group after lane_sums
  constexpr int kLeft = (H >> kColBits) > 0 ? (H >> kColBits) : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & (Gc - 1), ty = threadIdx.x >> kLogC;

  float3 p[R], h[R];
  float f[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 a = A[ty + Gr * i], g = AG[ty + Gr * i];
    p[i] = make_float3(a.x, a.y, a.z);
    h[i] = make_float3(g.x, g.y, g.z);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[i][k] = 0.f;
  }
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    float s[H][6];
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int k = 0; k < 6; ++k) s[j][k] = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float4 q = B[tx + Gc * (H * grp + j)];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dx = q.x - p[i].x, dy = q.y - p[i].y, dz = q.z - p[i].z;
        float inv = slot_body::rsqrt_normal(
            fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, softening))));
        if (fmaxf(fabsf(dx), fmaxf(fabsf(dy), fabsf(dz))) <= kD2Zero)
          inv = 0.f;
        const float inv2 = inv * inv;
        const float w = kMass ? (inv2 * inv) * q.w : inv2 * inv;
        const float ud = (w * inv2) * (h[i].x * dx + h[i].y * dy +
                                       h[i].z * dz);
        f[i][0] += ud * dx;
        f[i][1] += ud * dy;
        f[i][2] += ud * dz;
        f[i][3] += w;
        s[j][0] += ud * dx;
        s[j][1] += ud * dy;
        s[j][2] += ud * dz;
        s[j][3] += w * h[i].x;
        s[j][4] += w * h[i].y;
        s[j][5] += w * h[i].z;
      }
    }
    float col[H][3];
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) col[j][k] = s[j][3 + k] - 3.f * s[j][k];
    int coff = 0;
    bool cwriter = true;
    slot_body::lane_sums<H, kLogC, kColBits>(col, lane, coff, cwriter);
    float* cw = cols + warp * T * 3;
    if (cwriter)
#pragma unroll
      for (int j = 0; j < kLeft; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          cw[(tx + Gc * (H * grp + coff + j)) * 3 + k] = col[j][k];
  }
  float row[R][3];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i][0] = 3.f * f[i][0] - h[i].x * f[i][3];
    row[i][1] = 3.f * f[i][1] - h[i].y * f[i][3];
    row[i][2] = 3.f * f[i][2] - h[i].z * f[i][3];
  }
  int off = 0;
  bool writer = true;
  slot_body::lane_sums<R, 0, kLogC>(row, lane, off, writer);
  if (writer)
#pragma unroll
    for (int k = 0; k < 3; ++k) rows[(ty + Gr * off) * 3 + k] = row[0][k];
  __syncthreads();
}

template <int T>
constexpr size_t pair_smem_bytes() {
  // the staged blocks (three float4s a body: a's position and cotangent,
  // b's position and mass), the row totals and the warps' column partials
  return 3 * T * sizeof(float4) +
         (1 + pair_threads<T>() / 32) * T * 3 * sizeof(float);
}

// B12: the slots of a cross table over the row blocks of pos_a / g_a ((na,
// 3) each) and the column blocks of pos_b ((nb, K)); part: 2 (T, 3) tiles
// per slot, side 0 block bi's a_bar partial, side 1 block bj's b_bar
// partial, for slot_reduce_launch. Each CTA walks its slots
// (slot_body::walk_slots), loading the next slot's blocks into registers
// while it computes one.
template <int T, int K>
__global__ void __launch_bounds__(
    pair_threads<T>(),
    slot_body::stream_min_ctas(pair_threads<T>(), kSymWarps))
    vjp_pair_kernel(const int* __restrict__ slots, int n_slots,
                    const float* __restrict__ pos_a,
                    const float* __restrict__ g_a,
                    const float* __restrict__ pos_b, float* part,
                    float softening) {
  constexpr int kThreads = pair_threads<T>(), kWarps = kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const float4* s4 = reinterpret_cast<const float4*>(smem);
  float* rows = smem + 12 * T;
  float* cols = rows + 3 * T;
  SymBlock<T, 3, true, kThreads> a;
  SymBlock<T, K, false, kThreads> b;
  slot_body::walk_slots(
      slots, n_slots,
      [&](const slot_body::Slot& sl) {
        a.load(pos_a + static_cast<size_t>(sl.bi) * T * 3,
               g_a + static_cast<size_t>(sl.bi) * T * 3);
        b.load(pos_b + static_cast<size_t>(sl.bj) * T * K, nullptr);
      },
      [&] {
        a.store(smem, smem + 4 * T);
        b.store(smem + 8 * T, nullptr);
      },
      [&](const slot_body::Slot&, int s) {
        pair_pass<T, K == 4>(s4, s4 + T, s4 + 2 * T, softening, rows, cols);
        float* out = part + static_cast<long long>(s) * 2 * T * 3;
        for (int e = threadIdx.x; e < T * 3; e += kThreads) {
          out[e] = rows[e];
          out[T * 3 + e] = slot_body::warp_total<T, kWarps>(cols, e);
        }
      });
}

using PairKernel = void (*)(const int*, int, const float*, const float*,
                            const float*, float*, float);

// B12's kernel for k, its threads per CTA and dynamic shared memory, or
// nullptr.
PairKernel pick_pair(int k, int* threads, size_t* smem) {
  *threads = pair_threads<kPairTile>();
  *smem = pair_smem_bytes<kPairTile>();
  if (k == 3) return vjp_pair_kernel<kPairTile, 3>;
  if (k == 4) return vjp_pair_kernel<kPairTile, 4>;
  return nullptr;
}

}  // namespace

// B10. pos_k, g_k (nk, 3), mass_k (nk,) or NULL; pos_j, g_j (nj, 3), mass_j
// (nj,) or NULL (masses both or neither); out (nk, 3): fp32, contiguous, on
// the current device. overlap_only: mask d2 == 0 only in the tile whose j
// range is the block's k range (square calls). block: receivers per block
// and j-tile size, a multiple of 32 up to 1024. Returns cudaGetLastError().
extern "C" int vjp_ordered_launch(const float* pos_k, const float* g_k,
                                  const float* mass_k, int nk,
                                  const float* pos_j, const float* g_j,
                                  const float* mass_j, int nj, float* out,
                                  float softening, int overlap_only,
                                  int block, void* stream) {
  int threads = 0;
  const OrderedKernel kernel =
      pick_ordered(block, mass_k != nullptr, &threads);
  if (kernel == nullptr || (mass_k == nullptr) != (mass_j == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nk == 0) return 0;
  kernel<<<(nk + block - 1) / block, threads, 2 * block * sizeof(float4),
           static_cast<cudaStream_t>(stream)>>>(
      pos_k, g_k, mass_k, nk, pos_j, g_j, mass_j, nj, out, softening,
      overlap_only);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers per thread, local bytes per thread, CTAs per SM and
// threads per CTA of B10's kernel at `block` with or without masses (block
// / ordered_r(block) threads).
extern "C" int vjp_ordered_info(int block, int masses, int* out) {
  int threads = 0;
  const void* kernel =
      reinterpret_cast<const void*>(pick_ordered(block, masses, &threads));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, threads, 2 * block * sizeof(float4));
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = threads;
  return static_cast<int>(err);
}

// B12. slots (n_slots, 3) int32, a cross table (kind, bi, bj) over the row
// blocks of pos_a, g_a ((rows_a, 3)) and the column blocks of pos_b
// ((rows_b, k), k = 3 (unit masses) or 4 (x, y, z, m)), rows of each a
// multiple of tile, pads FAR with zero cotangent and zero mass; fp32,
// contiguous, on the current device. part: n_slots x 2 tiles of (tile, 3)
// fp32, side 0 of slot s block bi's a_bar partial, side 1 block bj's b_bar
// partial, for slot_reduce_launch. The tile is 128 (kPairTile). Returns
// cudaGetLastError().
extern "C" int vjp_pair_launch(const int* slots, int n_slots,
                               const float* pos_a, const float* g_a,
                               const float* pos_b, float* part, int k,
                               float softening, void* stream) {
  int threads = 0;
  size_t smem = 0;
  const PairKernel kernel = pick_pair(k, &threads, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int width = 0;
  err = slot_body::stream_width(kernel, threads, smem, n_slots, 1, &width);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<width, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      slots, n_slots, pos_a, g_a, pos_b, part, softening);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers per thread, local bytes per thread, CTAs per SM and
// threads per CTA of B12's kernel with or without masses, at its launch's
// shared memory.
extern "C" int vjp_pair_info(int masses, int* out) {
  int threads = 0;
  size_t smem = 0;
  const PairKernel kernel = pick_pair(masses ? 4 : 3, &threads, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = threads;
  return static_cast<int>(err);
}

// B11 and B9c. slots (n_slots, 3) int32 (kind, bi, bj); pos_a / pos_b
// (rows, k), k = 3 (unit masses) or 4 (x, y, z, m); g_a / g_b (rows, 3);
// rows of each a multiple of tile; n_sys systems of such rows, sys_rows rows
// apart (tri mode; 1 system in cross mode); fp32, contiguous, on the current
// device. part: n_sys x n_slots x 2 tiles of (tile, ko) fp32, ko = 3, or 4
// with the mass cotangent (k = 4 only), written (side 0 of slot s: block
// bi's sums; side 1: block bj's; a DIAG slot writes side 0 only) for
// slot_reduce_launch. tile: 64 or 128. Returns cudaGetLastError().
extern "C" int vjp_sym_launch(const int* slots, int n_slots, int n_sys,
                              long long sys_rows, const float* pos_a,
                              const float* pos_b, const float* g_a,
                              const float* g_b, float* part, int k, int ko,
                              int tile, float softening, int mask_offdiag,
                              void* stream) {
  int threads = 0;
  size_t smem = 0;
  const SymKernel kernel = pick_sym(tile, k, ko, &threads, &smem);
  if (kernel == nullptr || n_sys > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots == 0 || n_sys == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int width = 0;
  err = slot_body::stream_width(kernel, threads, smem, n_slots, n_sys,
                                &width);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(width, n_sys), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      slots, n_slots, pos_a, pos_b, g_a, g_b, part, sys_rows, softening,
      mask_offdiag);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers per thread, local bytes per thread, CTAs per SM and
// threads per CTA of B11's kernel for (tile, masses, ko), at its launch's
// shared memory.
extern "C" int vjp_sym_info(int tile, int masses, int ko, int* out) {
  int threads = 0;
  size_t smem = 0;
  const SymKernel kernel =
      pick_sym(tile, masses ? 4 : 3, ko, &threads, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = threads;
  return static_cast<int>(err);
}
