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
// reduction (csrc/slot_reduce.cu, or ordered_sum and ordered_row_sum in
// B15's reduce and integrate phases).
//
// Both bodies keep each pair's weight w in registers: no pair costs a
// shared-memory access. Shared memory stages the two blocks once per slot
// and combines the partial sums of the threads (fp32) or warps (bf16) that
// share a row or a column, once per slot, in a fixed order, so every output
// bit is the same on every run. A FOLD slot runs as two passes over the full
// T x T tile, one per side, with w zeroed outside the side's triangle (fold
// slots are nb / 2 of ~nb^2 / 2).
//
// Pads: a real body against a FAR pad gets w = 0 exactly (r2^3 overflows
// and rsqrt(inf) = 0, or rsqrt(r2)^3 underflows). The streamed kernels drop
// the pad rows after every pass; B15 places each pad of a block at its own
// far point, so every pair of two bodies that touches a pad, pad with pad
// included, gets w = 0 the same way.
//
// The caller keeps every thread of the CTA in the call (the bodies hold
// __syncthreads) and syncs before it reuses the shared memory for the next
// slot. Built without --use_fast_math: nvcc contracts the mul/add pairs
// into FMAs, which the plain PyTorch versions do not do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace slot_body {

constexpr int kSlotDiag = 0;
constexpr int kSlotFold = 2;

// The slot-order sum of one element of a target's partials: entries[e0 ..
// e1) are its tiles in slot order, base points at the element in tile 0.
// The sum starts at 0 and adds them in list order; kUnroll loads are in
// flight before their adds, so a long list costs one load latency per
// kUnroll adds (B15's reduce phase; csrc/slot_reduce.cu adds in the same
// order through its cp.async ring, so the bits are the same).
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

// ordered_sum of the W consecutive elements base[0 .. W) of a target's
// partials (one body's row of a (T, W) tile) into s: each s[k] bitwise
// ordered_sum(base + k, ...), the W columns loaded together, kRowUnroll
// entries in flight (B15's fused reduce and integrate of the fp32 class,
// one thread per body, which has the registers for them).
constexpr int kRowUnroll = 2 * kUnroll;

template <int W>
__device__ __forceinline__ void ordered_row_sum(const float* __restrict__ base,
                                                const int* __restrict__ entries,
                                                int e, int e1,
                                                long long tile_elems,
                                                float (&s)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) s[k] = 0.f;
  for (; e + kRowUnroll <= e1; e += kRowUnroll) {
    float v[kRowUnroll][W];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
#pragma unroll
      for (int k = 0; k < W; ++k)
        v[u][k] = base[entries[e + u] * tile_elems + k];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
#pragma unroll
      for (int k = 0; k < W; ++k) s[k] += v[u][k];
  }
  for (; e < e1; ++e)
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] += base[entries[e] * tile_elems + k];
}

// rsqrt of a normal float or +inf, flushing denormal inputs: with kFast
// (fast_rsqrt_cube: softening >= 1e-12) r2^3 >= 1e-36 is never denormal, so
// this is rsqrtf's result without its denormal rescaling.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// w = rsqrt(r2^3) (kFast) or rsqrt(r2)^3.
template <bool kFast>
__device__ __forceinline__ float pair_weight(float r2) {
  if (kFast) return rsqrt_normal((r2 * r2) * r2);
  const float inv = rsqrtf(r2);
  return (inv * inv) * inv;
}

// Whether pair (r, c) of a fold pass lies outside its side's triangle:
// tri 1 keeps c < r (side a), tri 2 keeps c > r (side b).
__device__ __forceinline__ bool off_triangle(int tri, int r, int c) {
  return tri == 1 ? c >= r : c <= r;
}

// The grid width of a streamed slot kernel: as many CTAs as the card holds
// at once (the kernel's occupancy on every SM), shared among the n_sys
// systems on gridDim.y, at most one per slot. Each CTA walks the slots
// blockIdx.x, blockIdx.x + gridDim.x, ... and loads a slot's blocks while
// the one before computes (the kernel's staged registers).
template <typename Kernel>
cudaError_t stream_width(Kernel kernel, int threads, size_t smem,
                         int n_slots, int n_sys, int* width) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  const long long w = static_cast<long long>(per_sm) * sms / n_sys;
  *width = static_cast<int>(w < 1 ? 1 : (w < n_slots ? w : n_slots));
  return err;
}

// CTAs per SM a streamed kernel of `threads` threads is compiled for, to
// hold `warps` warps per SM: the fp32 body (K3) kFp32Warps = 16 (at most
// 128 registers per thread), the bf16 body (K2) kMxuWarps = 12 (at most
// 168; its two-strip body spills at 128). B15 takes its own
// (csrc/resident_sym.cu res_warps).
constexpr int kFp32Warps = 16;
constexpr int kMxuWarps = 12;

__host__ __device__ constexpr int stream_min_ctas(int threads, int warps) {
  return 32 * warps / threads;
}

// A slot's (kind, bi, bj) from the device slot list.
struct Slot {
  int kind, bi, bj;
};

__device__ __forceinline__ Slot read_slot(const int* __restrict__ slots,
                                          int s) {
  return {slots[3 * s], slots[3 * s + 1], slots[3 * s + 2]};
}

// The streamed kernels' slot loop: this CTA computes slots blockIdx.x,
// blockIdx.x + gridDim.x, ... of the n_slots of `slots`. load(slot) reads
// a slot's blocks into the stage's registers while the slot before it
// computes (its triple was read one slot earlier still), store() stages
// them in shared memory, and compute(slot, s) runs slot s.
template <class Load, class Store, class Compute>
__device__ __forceinline__ void walk_slots(const int* __restrict__ slots,
                                           int n_slots, Load load,
                                           Store store, Compute compute) {
  const int stride = gridDim.x;
  int s = blockIdx.x;
  Slot next{}, after{};
  if (s < n_slots) {
    next = read_slot(slots, s);
    load(next);
  }
  if (s + stride < n_slots) after = read_slot(slots, s + stride);
  for (; s < n_slots; s += stride) {
    store();
    __syncthreads();
    const Slot cur = next;
    next = after;
    if (s + stride < n_slots) load(next);
    if (s + 2 * stride < n_slots) after = read_slot(slots, s + 2 * stride);
    compute(cur, s);
    __syncthreads();  // the slot is done with shared memory
  }
}

// ------------------------------------------------- fp32 class (K3) ---
//
// One CTA of (T/8)^2 threads: T = 128, 256 threads; T = 64, 64. Thread
// (ty, tx) = (tid / G, tid % G), G = T / 8, owns the 8 x 8 pairs of rows
// ty + G i and columns tx + G j (i, j < 8): it holds its rows' (x, y, z[,
// m]) in registers, reads each column's once from shared memory (a
// broadcast), and keeps 8 x 3 row sums and 8 x 3 reaction sums in
// registers. Per pair: d = p_c - p_r, r2 = |d|^2 + softening, w = rsqrt(r2^3)
// (kFast) or rsqrt(r2)^3; rows F_r += d w (m_c), reactions G_c += d w (m_r),
// stored negated. The G threads that share a row are lanes of one warp
// (lane bits [0, log2 G)); those that share a column are lanes in bits
// [log2 G, 5) and the CTA's warps. Each warp halves its sums across its
// lanes (lane_sums), then the row totals and the warps' column partials
// meet in shared memory and the column partials are added in increasing
// warp index.

template <int T>
__host__ __device__ constexpr int fp32_threads() {
  return (T / 8) * (T / 8);
}

template <int T>
__host__ __device__ constexpr size_t fp32_smem_bytes() {
  // two staged blocks (float4 per body), the row totals, the warps' column
  // partials
  return 2 * T * sizeof(float4) +
         (3 * T + fp32_threads<T>() / 32 * 3 * T) * sizeof(float);
}

// Sums each of a lane's N partials (s[0 .. N), K components each) with the
// partners' copies across lane bits [kBit0, kBit0 + kBits), highest bit
// first, in a fixed order. While N > 1 a step halves: a lane keeps the
// upper half of its entries if its bit is set, else the lower half, and
// adds its partner's copy of that half; with one entry left the partners
// swap and add, and only the one whose bit is clear stays the writer. On
// return s[0 .. max(N >> kBits, 1)) hold the totals of entries off, off + 1,
// ... of the lane's original N. K3 sums 8 entries of 3 (rows and
// reactions), B11 (csrc/vjp_kernel.cu) 4 entries of 3 or 4.
template <int N, int kBit0, int kBits, int M, int K>
__device__ __forceinline__ void lane_sums(float (&s)[M][K], int lane,
                                          int& off, bool& writer) {
  if constexpr (kBits > 0) {
    constexpr int kBit = kBit0 + kBits - 1;
    const bool up = (lane >> kBit) & 1;
    if constexpr (N > 1) {
      constexpr int H = N / 2;
#pragma unroll
      for (int i = 0; i < H; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float send = up ? s[i][k] : s[i + H][k];
          const float keep = up ? s[i + H][k] : s[i][k];
          s[i][k] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << kBit);
        }
      if (up) off += H;
      lane_sums<H, kBit0, kBits - 1>(s, lane, off, writer);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        s[0][k] += __shfl_xor_sync(0xffffffffu, s[0][k], 1 << kBit);
      if (up) writer = false;
      lane_sums<1, kBit0, kBits - 1>(s, lane, off, writer);
    }
  }
}

// One pass over the T x T pairs of blocks P (rows) and Q (columns): row
// totals to rows (T x 3, shared), the warps' column partials to cols
// (warps x T x 3, shared), then a barrier. kCols = false skips the
// reactions (DIAG); kTri zeroes w off the triangle `tri` (FOLD).
template <int T, int K, bool kFast, bool kCols, bool kTri>
__device__ __forceinline__ void fp32_pass(const float4* P, const float4* Q,
                                          int tri, float softening,
                                          float* rows, float* cols) {
  constexpr int G = T / 8;
  constexpr int kLog = T == 128 ? 4 : 3;
  static_assert(G == 1 << kLog, "tile 64 or 128");
  constexpr bool kMass = K == 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & (G - 1), ty = threadIdx.x >> kLog;

  float4 p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = P[ty + G * i];
  float f[8][3], g[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) f[i][k] = g[i][k] = 0.f;

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tx + G * j;
    const float4 q = Q[c];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dx = q.x - p[i].x;
      const float dy = q.y - p[i].y;
      const float dz = q.z - p[i].z;
      const float r2 = dx * dx + dy * dy + (dz * dz + softening);
      float w = pair_weight<kFast>(r2);
      if (kTri && off_triangle(tri, ty + G * i, c)) w = 0.f;
      const float wr = kMass ? w * q.w : w;
      f[i][0] += dx * wr;
      f[i][1] += dy * wr;
      f[i][2] += dz * wr;
      if (kCols) {
        const float wc = kMass ? w * p[i].w : w;
        g[j][0] += dx * wc;
        g[j][1] += dy * wc;
        g[j][2] += dz * wc;
      }
    }
  }

  int off = 0;
  bool writer = true;
  lane_sums<8, 0, kLog>(f, lane, off, writer);
  if (writer)
#pragma unroll
    for (int k = 0; k < 3; ++k) rows[(ty + G * off) * 3 + k] = f[0][k];
  if (kCols) {
    constexpr int kLeft = 8 >> (5 - kLog);  // columns a lane keeps
    int coff = 0;
    bool unused = true;  // halving steps only: every lane keeps its own
    lane_sums<8, kLog, 5 - kLog>(g, lane, coff, unused);
    float* cw = cols + warp * T * 3;
#pragma unroll
    for (int j = 0; j < kLeft; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) cw[(tx + G * (coff + j)) * 3 + k] = g[j][k];
  }
  __syncthreads();
}

// The column total of element e of a pass: the warps' partials in
// increasing warp index.
template <int T, int kWarps>
__device__ __forceinline__ float warp_total(const float* cols, int e) {
  float s = cols[e];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += cols[w * T * 3 + e];
  return s;
}

// One slot's two blocks (x, y, z[, m]) in registers: load() reads them from
// device memory, store() writes them to the shared float4 blocks. The
// streamed kernel loads the next slot's while the current one computes.
template <int T, int K>
struct Fp32Stage {
  static constexpr int kThreads = fp32_threads<T>();
  static constexpr int kLoads = (T * K + kThreads - 1) / kThreads;
  float a[kLoads], b[kLoads];

  __device__ __forceinline__ void load(int bi, int bj,
                                       const float* __restrict__ pos_a,
                                       const float* __restrict__ pos_b) {
    const float* ga = pos_a + static_cast<size_t>(bi) * T * K;
    const float* gb = pos_b + static_cast<size_t>(bj) * T * K;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < T * K) {
        a[l] = ga[t];
        b[l] = gb[t];
      }
    }
  }

  __device__ __forceinline__ void store(float* smem) const {
    float* sa = smem;          // block bi of side a, float4 per body
    float* sb = smem + 4 * T;  // block bj of side b
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < T * K) {
        const int r = t / K, k = t - K * (t / K);
        sa[4 * r + k] = a[l];
        sb[4 * r + k] = b[l];
      }
    }
  }
};

// The slot's passes on its staged blocks (Fp32Stage::store, then a
// barrier); out: its two (T, 3) partial tiles.
template <int T, int K, bool kFast>
__device__ __forceinline__ void fp32_compute(int kind, float* out,
                                             float softening, float* smem) {
  constexpr int kThreads = fp32_threads<T>();
  constexpr int kWarps = kThreads / 32;
  const float4* pa = reinterpret_cast<const float4*>(smem);
  const float4* pb = pa + T;
  float* rows = smem + 8 * T;
  float* cols = rows + 3 * T;

  if (kind == kSlotFold) {
    // Side a's triangle (c < r), then side b's (c > r): rows - reactions.
    fp32_pass<T, K, kFast, true, true>(pa, pa, 1, softening, rows, cols);
    for (int e = threadIdx.x; e < 3 * T; e += kThreads)
      out[e] = rows[e] - warp_total<T, kWarps>(cols, e);
    __syncthreads();
    fp32_pass<T, K, kFast, true, true>(pb, pb, 2, softening, rows, cols);
    for (int e = threadIdx.x; e < 3 * T; e += kThreads)
      out[3 * T + e] = rows[e] - warp_total<T, kWarps>(cols, e);
  } else if (kind == kSlotDiag) {
    fp32_pass<T, K, kFast, false, false>(pa, pb, 0, softening, rows, cols);
    for (int e = threadIdx.x; e < 3 * T; e += kThreads) out[e] = rows[e];
  } else {
    fp32_pass<T, K, kFast, true, false>(pa, pb, 0, softening, rows, cols);
    for (int e = threadIdx.x; e < 3 * T; e += kThreads) {
      out[e] = rows[e];
      out[3 * T + e] = -warp_total<T, kWarps>(cols, e);
    }
  }
}

// ------------------------------------------------- bf16 class (K2) ---
//
// One CTA of T threads: T / 32 warps, warp m owning the rows [32 m, 32 m +
// 32) of the T x T slot tile as two 16-row strips. For each 16-column step
// a lane computes in fp32, for each strip, the 8 weights its m16n8k16 A
// fragment holds (rows g, g + 8 and columns 2t, 2t + 1, 2t + 8, 2t + 9 of
// the 16 x 16 sub-tile, g = lane / 4, t = lane % 4), masked where d2 == 0
// (DIAG slots; CROSS and FOLD iff mask_offdiag; the fold's self diagonal
// always), packs them to bf16 pairs (cvt.rn.bf16x2.f32) and runs
//   rows:      acc[strip] (16 x 8) += W (16 x 16) @ v_Q (16 x 8),
//   reactions: col[step]  (16 x 8) += W^T (16 x 16) @ v_P[strip] (16 x 8),
// W^T's fragment being W's four 8 x 8 blocks through movmatrix .trans (no
// second rsqrt, no shared-memory round trip). v = [vhi | vlo] (T, 8) is
// the wrapper's compensated operand split, rounded to bf16 once per slot
// while staging (vhi is exact); split_w adds the products of w's bf16
// remainder. Each strip's row accumulator is one fresh fragment per slot
// (and pass); a step's reaction fragment sums the warp's two strips and
// goes to shared memory at once, and the warps' reaction partials are added
// in increasing warp index. Two strips give each lane 16 independent pairs
// per step. The step loop (mxu_steps) and the one-block stage (MxuBlock)
// also carry B6 (csrc/mxu_force.cu, rows only, its own w) and B16
// (csrc/band_mxu.cu, the band walk).

constexpr int kMxuStrips = 2;

template <int T>
__host__ __device__ constexpr int mxu_threads() {
  return 32 * T / (16 * kMxuStrips);
}

// The two staged blocks and v^T of both in bf16 (rows padded to T + 8) of
// the bf16 body's shared memory.
template <int T>
__host__ __device__ constexpr size_t mxu_stage_bytes() {
  return 2 * T * sizeof(float4) + 2 * 8 * (T + 8) * sizeof(__nv_bfloat16);
}

template <int T>
__host__ __device__ constexpr size_t mxu_smem_bytes() {
  // the staged blocks, a fold pass's rows, the warps' reaction partials
  return mxu_stage_bytes<T>() +
         (1 + mxu_threads<T>() / 32) * T * 8 * sizeof(float);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// w's bf16 remainder: w - bf16(w), rounded to bf16, for both halves.
__device__ __forceinline__ uint32_t remainder_bf16x2(uint32_t hi, float lo_w,
                                                     float hi_w) {
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16x2(lo_w - h.x, hi_w - h.y);
}

__device__ __forceinline__ uint32_t transpose_8x8(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's rows of a bf16 pass, per strip h (rows r0[h] = 16 (H warp + h)
// + g and r0[h] + 8 of the tile): the two rows' positions (float4) and the
// B fragment of the strip's v (k = the strip's rows) for the reactions.
struct MxuRows {
  int r0[kMxuStrips];
  float4 p0[kMxuStrips], p1[kMxuStrips];
  uint32_t bp0[kMxuStrips], bp1[kMxuStrips];
};

// The T / 16 column steps of a pass over the columns Q (float4 per body) and
// vq (row g of v_Q^T in bf16, as bf16 pairs): for each strip the row
// product W @ v_Q into acc[h] (added to, in the tensor cores' own fp32
// adds), and with kCols each step's reaction fragment W^T @ v_P to cw
// (this warp's T x 8 partials). weight(p, q, r, c) is the w of pair (row r
// at p, column c at q).
template <int T, bool kSplit, bool kCols, class Weight>
__device__ __forceinline__ void mxu_steps(const MxuRows& rw, const float4* Q,
                                          const uint32_t* vq,
                                          float (&acc)[kMxuStrips][4],
                                          float* cw, Weight weight) {
  constexpr int kSteps = T / 16;
  constexpr int H = kMxuStrips;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Each step's columns (positions, and v_Q's B fragment) are loaded one
  // step ahead.
  float4 nq0 = Q[2 * t], nq1 = Q[2 * t + 1], nq2 = Q[2 * t + 8],
         nq3 = Q[2 * t + 9];
  uint32_t nb0 = vq[t], nb1 = vq[t + 4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c0 = 16 * s + 2 * t, c1 = c0 + 1, c2 = c0 + 8, c3 = c0 + 9;
    const float4 q0 = nq0, q1 = nq1, q2 = nq2, q3 = nq3;
    const uint32_t bq0 = nb0, bq1 = nb1;
    if (s + 1 < kSteps) {
      nq0 = Q[c0 + 16];
      nq1 = Q[c1 + 16];
      nq2 = Q[c2 + 16];
      nq3 = Q[c3 + 16];
      nb0 = vq[(c0 + 16) / 2];
      nb1 = vq[(c2 + 16) / 2];
    }
    float col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int ra = rw.r0[h], rb = ra + 8;
      const float w00 = weight(rw.p0[h], q0, ra, c0);
      const float w01 = weight(rw.p0[h], q1, ra, c1);
      const float w10 = weight(rw.p1[h], q0, rb, c0);
      const float w11 = weight(rw.p1[h], q1, rb, c1);
      const float w02 = weight(rw.p0[h], q2, ra, c2);
      const float w03 = weight(rw.p0[h], q3, ra, c3);
      const float w12 = weight(rw.p1[h], q2, rb, c2);
      const float w13 = weight(rw.p1[h], q3, rb, c3);
      // A fragment: (ra, c0..c1), (rb, c0..c1), (ra, c2..c3), (rb, c2..c3).
      const uint32_t a[4] = {pack_bf16x2(w00, w01), pack_bf16x2(w10, w11),
                             pack_bf16x2(w02, w03), pack_bf16x2(w12, w13)};
      mma_bf16(acc[h], a, bq0, bq1);
      uint32_t lo[4];
      if (kSplit) {
        lo[0] = remainder_bf16x2(a[0], w00, w01);
        lo[1] = remainder_bf16x2(a[1], w10, w11);
        lo[2] = remainder_bf16x2(a[2], w02, w03);
        lo[3] = remainder_bf16x2(a[3], w12, w13);
        mma_bf16(acc[h], lo, bq0, bq1);
      }
      if (kCols) {
        // W^T's blocks: (0, 0) = a0^T, (1, 0) = a2^T, (0, 1) = a1^T,
        // (1, 1) = a3^T.
        const uint32_t at[4] = {transpose_8x8(a[0]), transpose_8x8(a[2]),
                                transpose_8x8(a[1]), transpose_8x8(a[3])};
        mma_bf16(col, at, rw.bp0[h], rw.bp1[h]);
        if (kSplit) {
          const uint32_t lt[4] = {transpose_8x8(lo[0]), transpose_8x8(lo[2]),
                                  transpose_8x8(lo[1]), transpose_8x8(lo[3])};
          mma_bf16(col, lt, rw.bp0[h], rw.bp1[h]);
        }
      }
    }
    if (kCols) {
      // The step's 16 columns are this warp's alone: the partial goes to
      // shared memory at once (C fragment: column g, then g + 8).
      *reinterpret_cast<float2*>(cw + (16 * s + g) * 8 + 2 * t) =
          make_float2(col[0], col[1]);
      *reinterpret_cast<float2*>(cw + (16 * s + g + 8) * 8 + 2 * t) =
          make_float2(col[2], col[3]);
    }
  }
}

// One pass over the T x T pairs of blocks P (rows, operand VP, v^T in
// bf16) and Q (columns, VQ): the row sums to rows_out (T x 8, global or
// shared), the warps' reaction partials to cols (warps x T x 8, shared)
// unless !kCols, then a barrier. kD2 masks d2 == 0; kTri zeroes w off the
// triangle `tri` and the self diagonal (FOLD).
template <int T, bool kSplit, bool kFast, bool kCols, bool kD2, bool kTri>
__device__ __forceinline__ void mxu_pass(const float4* P, const float4* Q,
                                         const __nv_bfloat16* VP,
                                         const __nv_bfloat16* VQ, int tri,
                                         float softening, float* rows_out,
                                         float* cols) {
  constexpr int LDV = T + 8;
  constexpr int H = kMxuStrips;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* vp = reinterpret_cast<const uint32_t*>(VP + g * LDV);
  const uint32_t* vq = reinterpret_cast<const uint32_t*>(VQ + g * LDV);
  MxuRows rw;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int strip = 16 * (H * warp + h);
    rw.r0[h] = strip + g;
    rw.p0[h] = P[rw.r0[h]];
    rw.p1[h] = P[rw.r0[h] + 8];
    rw.bp0[h] = vp[(strip + 2 * t) / 2];
    rw.bp1[h] = vp[(strip + 2 * t + 8) / 2];
  }

  float acc[H][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;

  auto weight = [&](const float4& p, const float4& q, int r, int c) {
    const float dx = q.x - p.x;
    const float dy = q.y - p.y;
    const float dz = q.z - p.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    float w = pair_weight<kFast>(d2 + softening);
    if (kD2 && d2 == 0.f) w = 0.f;
    if (kTri && off_triangle(tri, r, c)) w = 0.f;
    return w;
  };
  mxu_steps<T, kSplit, kCols>(rw, Q, vq, acc, cols + warp * T * 8, weight);

  // C fragments: (row g, columns 2t, 2t + 1), (row g + 8, the same).
#pragma unroll
  for (int h = 0; h < H; ++h) {
    *reinterpret_cast<float2*>(rows_out + rw.r0[h] * 8 + 2 * t) =
        make_float2(acc[h][0], acc[h][1]);
    *reinterpret_cast<float2*>(rows_out + (rw.r0[h] + 8) * 8 + 2 * t) =
        make_float2(acc[h][2], acc[h][3]);
  }
  __syncthreads();
}

// The reaction total of float4 e of a pass's (T, 8) tile: the warps'
// partials in increasing warp index.
template <int T>
__device__ __forceinline__ float4 warp_total4(const float* cols, int e) {
  const float4* c = reinterpret_cast<const float4*>(cols);
  float4 s = c[e];
#pragma unroll
  for (int w = 1; w < mxu_threads<T>() / 32; ++w) {
    const float4 v = c[w * 2 * T + e];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  return s;
}

template <int T, bool kSplit, bool kFast>
__device__ __forceinline__ void mxu_slot_body(
    int kind, const float4* pa, const float4* pb, const __nv_bfloat16* va,
    const __nv_bfloat16* vb, float* out, float softening, int mask_offdiag,
    float* rows, float* cols) {
  // A (T, 8) tile is 2T float4s.
  constexpr int kThreads = mxu_threads<T>();
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  if (kind == kSlotFold) {
    // Side a's triangle (c < r), then side b's (c > r): rows + reactions.
#define NBODY_FOLD_PASS(D2, P, V, TRI, SIDE)                                  \
  mxu_pass<T, kSplit, kFast, true, D2, true>(P, P, V, V, TRI, softening,      \
                                             rows, cols);                     \
  for (int e = threadIdx.x; e < 2 * T; e += kThreads) {                       \
    const float4 c = warp_total4<T>(cols, e), r = rows4[e];                   \
    out4[SIDE * 2 * T + e] =                                                  \
        make_float4(r.x + c.x, r.y + c.y, r.z + c.z, r.w + c.w);              \
  }                                                                           \
  __syncthreads();
    if (mask_offdiag) {
      NBODY_FOLD_PASS(true, pa, va, 1, 0)
      NBODY_FOLD_PASS(true, pb, vb, 2, 1)
    } else {
      NBODY_FOLD_PASS(false, pa, va, 1, 0)
      NBODY_FOLD_PASS(false, pb, vb, 2, 1)
    }
#undef NBODY_FOLD_PASS
  } else if (kind == kSlotDiag) {
    mxu_pass<T, kSplit, kFast, false, true, false>(pa, pb, va, vb, 0,
                                                   softening, out, cols);
  } else {
    if (mask_offdiag)
      mxu_pass<T, kSplit, kFast, true, true, false>(pa, pb, va, vb, 0,
                                                    softening, out, cols);
    else
      mxu_pass<T, kSplit, kFast, true, false, false>(pa, pb, va, vb, 0,
                                                     softening, out, cols);
    for (int e = threadIdx.x; e < 2 * T; e += kThreads)
      out4[2 * T + e] = warp_total4<T>(cols, e);
  }
}

// One block's positions (x, y, z) and operand v (8 floats per body, as
// float4s) in registers: load() reads them from device memory, store()
// writes the positions to a shared float4 block and v^T rounded to bf16
// (rows padded to T + 8).
template <int T>
struct MxuBlock {
  static constexpr int kThreads = mxu_threads<T>();
  static constexpr int kLoads = (3 * T + kThreads - 1) / kThreads;
  static constexpr int kV4 = 2 * T / kThreads;  // float4s of v per thread
  static_assert(kV4 * kThreads == 2 * T, "whole float4s of v per thread");
  float p[kLoads];
  float4 v[kV4];

  // pos: the block's (T, 3) positions, vg: its (T, 8) operand.
  __device__ __forceinline__ void load(const float* __restrict__ pos,
                                       const float* __restrict__ vg) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < 3 * T) p[l] = pos[t];
    }
    const float4* gv = reinterpret_cast<const float4*>(vg);
#pragma unroll
    for (int l = 0; l < kV4; ++l) v[l] = gv[threadIdx.x + l * kThreads];
  }

  __device__ __forceinline__ void store(float* q, __nv_bfloat16* vt) const {
    constexpr int LDV = T + 8;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int t = threadIdx.x + l * kThreads;
      if (t < 3 * T) {
        const int r = t / 3, k = t - 3 * (t / 3);
        q[4 * r + k] = p[l];
      }
    }
#pragma unroll
    for (int l = 0; l < kV4; ++l) {
      // Float4 f of a block's (T, 8) v is body f / 2, columns 4 (f % 2) ..
      const int f = threadIdx.x + l * kThreads;
      const int r = f >> 1, k = 4 * (f & 1);
      vt[(k + 0) * LDV + r] = __float2bfloat16_rn(v[l].x);
      vt[(k + 1) * LDV + r] = __float2bfloat16_rn(v[l].y);
      vt[(k + 2) * LDV + r] = __float2bfloat16_rn(v[l].z);
      vt[(k + 3) * LDV + r] = __float2bfloat16_rn(v[l].w);
    }
  }
};

// One slot's two blocks in registers. store() writes block a's positions
// and v^T, then block b's, to the shared layout mxu_compute reads. The
// streamed kernel loads the next slot's while the current one computes.
template <int T>
struct MxuStage {
  MxuBlock<T> a, b;

  __device__ __forceinline__ void load(int bi, int bj,
                                       const float* __restrict__ pos_a,
                                       const float* __restrict__ pos_b,
                                       const float* __restrict__ v_a,
                                       const float* __restrict__ v_b) {
    a.load(pos_a + static_cast<size_t>(bi) * T * 3,
           v_a + static_cast<size_t>(bi) * T * 8);
    b.load(pos_b + static_cast<size_t>(bj) * T * 3,
           v_b + static_cast<size_t>(bj) * T * 8);
  }

  __device__ __forceinline__ void store(unsigned char* smem) const {
    constexpr int LDV = T + 8;
    float* sa = reinterpret_cast<float*>(smem);  // float4 per body
    float* sb = sa + 4 * T;
    __nv_bfloat16* ta = reinterpret_cast<__nv_bfloat16*>(sb + 4 * T);
    a.store(sa, ta);
    b.store(sb, ta + 8 * LDV);
  }
};

// The slot's passes on its staged blocks (MxuStage::store, then a barrier)
// at smem; out: its two (T, 8) partial tiles. The passes' scratch follows
// the blocks unless `scratch` puts it elsewhere (B15, whose two staged
// areas share one scratch).
template <int T, bool kSplit>
__device__ __forceinline__ void mxu_compute(int kind, float* out,
                                            float softening, int fast,
                                            int mask_offdiag,
                                            unsigned char* smem,
                                            float* scratch = nullptr) {
  constexpr int LDV = T + 8;
  const float4* pa = reinterpret_cast<const float4*>(smem);
  const float4* pb = pa + T;
  const __nv_bfloat16* va = reinterpret_cast<const __nv_bfloat16*>(pb + T);
  const __nv_bfloat16* vb = va + 8 * LDV;
  float* rows = scratch != nullptr
                    ? scratch
                    : reinterpret_cast<float*>(smem + mxu_stage_bytes<T>());
  float* cols = rows + T * 8;  // warps x T x 8
  if (fast)
    mxu_slot_body<T, kSplit, true>(kind, pa, pb, va, vb, out, softening,
                                   mask_offdiag, rows, cols);
  else
    mxu_slot_body<T, kSplit, false>(kind, pa, pb, va, vb, out, softening,
                                    mask_offdiag, rows, cols);
}

}  // namespace slot_body
