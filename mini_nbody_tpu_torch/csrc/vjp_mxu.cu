// B13: the bf16-class pair-once force VJP on K2's slot + fold geometry.
// B14: its row half on a full rectangular grid.
//
// With d = p_b - p_a, s = |d|^2 + softening, inv = rsqrt(s), w = inv^3,
// u = w inv^2, a pair's gradient term to a (and -1x to b) is
//   t = w (m_a g_b - m_b g_a) + c d,   c = 3 u (m_b (g_a.d) - m_a (g_b.d)).
// Only w and c depend on both bodies, so the sums of t are products against
// per-body operands A_g = [g | m] and A_p = [p | 1]: rows S_g = W @ A_g,
// S_p = C @ A_p; reactions the same with W^T and C^T (the minus of -t sits
// in the transposed contraction). Rows and reactions add into one (c, 8)
// accumulator [S_g | S_p]; the wrapper forms pos_bar = m S_g[:3] - g S_g[3]
// + S_p[:3] - p S_p[3] (_combine) once. The mass cotangent, -w (g_b.d) to a
// and +w (g_a.d) to b, is a 9th column summed in fp32 on the CUDA cores.
//
// B13 replaces mini_nbody_tpu/ops/vjp_mxu.py:134 `_bwd_tri_kernel`
// (`vjp_pos_sym_mxu`, :342); B14 replaces :179 `_bwd_rect_kernel`
// (`vjp_rect_mxu`, :657), which autodiff calls square beyond the symmetric
// bound. Both keep JAX's numerics: w and c in fp32 (_wc_block, :74-109),
// rounded to bf16 in shared memory, operands split into compensated hi/lo
// bf16 halves by the wrapper (_split8, :224-228), fp32 accumulation; JAX
// folds hi + lo per block (:117-121), and so do these kernels before they
// store their partials (B13) or rows (B14).
//
// B13: one CTA of 256 threads per slot (kind, bi, bj), as K2
// (csrc/slot_pipe.cu). All threads compute the T x T tiles of w and c
// (bf16, rows padded to T + 8); then each warp owns one 32-row output tile
// of one side and runs two m32n8k16 wmma products over the tile's T
// columns, [W @ Qg | C @ Qp] for rows and, through col_major loads of the
// same tiles, [W^T @ Qg | C^T @ Qp] for reactions.
//   DIAG  (bi == bj): always masked where d2 == 0, row sums only (the rows
//         cover both orders).
//   CROSS: rows to block bi (side a) with block bj's operands, reactions
//         to block bj (side b) with block bi's.
//   FOLD  (bj == bi + 1): entry (r, c) is pair (a_r, a_c) for c < r (tiles
//         0) and (b_r, b_c) for c > r (tiles 1); the diagonal is always
//         masked; each block adds its tile's rows and reactions.
// CROSS and FOLD are masked where d2 == 0 iff mask_offdiag. Each CTA stores
// its two T x (8|9) partials (side 0: block bi, side 1: block bj), and
// csrc/slot_reduce.cu adds each block's partials in slot order; the mass
// column is summed inside the CTA in a fixed order too (see the kernel), so
// every output bit is the same on every run. The TPU's single-launch bound
// does not apply: the wrapper keeps K3's chunk loop.
//
// B9d: blockIdx.y is the system of an ensemble launch, which replaces
// vjp_mxu.py:430 `_vjp_ensemble_impl` (`pallas_call` :485, B13's kernel
// under a leading system axis). Every system runs the same system-local
// slot list over its own rows (positions, cotangents and operands),
// sys_rows rows after the previous system's; a standalone call is the same
// kernel with one system, so each system's sums are bitwise its standalone
// call's. gridDim.y is at most 65,535.
//
// B14: the row half of K2's step loop with a second product, as B6's bf16
// class (csrc/mxu_force.cu). One CTA of 2T threads per k tile of T
// receivers (T = 64 or 128): each warp owns one 16-row strip, each lane
// rows g and g + 8 of its strip in registers, (x, y, z, m) and (gx, gy,
// gz). Per j tile of T bodies, staged once in shared memory ((x, y, z, m)
// and (gx, gy, gz) as float4s; the operands' transposes in bf16 in the B
// fragment's layout; two buffers, the next tile's bodies loaded into
// registers while the current one computes, one barrier per tile), each
// lane computes for each 16-column step the 8 (w, c) of its mma.sync
// m16n8k16 A fragments in fp32, packs them to bf16 pairs and runs W @ Qg
// and C @ Qp at once: no w or c touches shared memory. Each tile's products
// start from fresh fragments and are added into fp32 running sums in
// registers with round-to-nearest adds, as B6 does: the tensor cores' fp32
// accumulation does not round to nearest, and one fragment carried across
// all j tiles drifted, its error against the fp32 gradient growing with N.
// A row's sums add the same products in the same order as the shared-tile
// kernel before this design (its wmma k steps are these m16n8k16 steps):
// at N = 262,144 with masses its rows were that kernel's bits
// (ab_slots.py, PERF.md). The epilogue
// folds hi + lo per row through shared memory. No reaction side, no
// atomics: each CTA writes its own rows, so B14 is deterministic.
// overlap_only (square calls under coincident routing, vjp_mxu.py:207-221)
// runs the tiles whose j range is not the CTA's k range through a body
// without the d2 == 0 select (chosen per tile at compile time), so 'fast'
// is bitwise 'masked' wherever no d2 == 0 pair is dropped. The operands
// [split([g | m]) | split([p | 1])] are formed from the staged body as the
// wrapper's _split8 forms them (hi = bf16(v), lo = bf16(v - hi), v - hi
// exact in fp32), so they are the plain version's bits. w's rsqrt is
// rsqrt.approx.ftz (slot_body.cuh rsqrt_normal): for any softening >=
// 2^-126 it is rsqrtf's result, and on a denormal r2 w and u overflow to
// inf either way.
//
// Numerics against the plain version: the fp32 pipeline of w and c is
// written with round-to-nearest intrinsics in the plain version's order of
// operations (no FMA contraction), so the kernel's fp32 w and c are the
// plain version's wherever the rsqrt is torch.rsqrt's, and both round them
// to the same bf16; what remains is the order of the fp32 sums.
//
// Pads: the wrappers pad B13's positions with FAR (zero mass in mass mode)
// and zero cotangents, and B14 fills its ragged edges with the same in
// shared memory (zero operands): against FAR, w and u underflow to 0, so
// w = c = 0; pad-pad pairs have g = 0 and d = 0, so c = 0, and their w lands
// only in pad rows.
//
// What bounds them on an H100: the fp32 pipeline of w and c (~30 fp32
// operations and one rsqrt per pair, JAX's count, vjp_mxu.py:367). B13 then
// pays shared memory: each bf16 tile element is written once and read by
// two wmma loads (rows and reactions); its products are 32 x 8 x T (N = 8)
// and keep the tensor cores mostly idle. B13 takes 64,000 bytes of shared
// memory per CTA at T = 64 and 177,152 at T = 128 (its launch raises the
// dynamic limit first); B14 25,088 bytes of static shared memory at T =
// 128, and its issue rate: ~30 instructions per pair by the count of its
// source. The launches return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "slot_body.cuh"

namespace {

using namespace nvcuda;

constexpr float kFar = 1.0e18f;
constexpr int kSlotDiag = 0;
constexpr int kSlotFold = 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using Frag = wmma::fragment<wmma::accumulator, 32, 8, 16, float>;
using FragB = wmma::fragment<wmma::matrix_b, 32, 8, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragA = wmma::fragment<wmma::matrix_a, 32, 8, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 32, 8, 16, __nv_bfloat16,
                              wmma::col_major>;

// A staged block of T bodies, fp32: x, y, z, m, gx, gy, gz (7 x T).
constexpr int kRows = 7;

// fp32 w and c of rows P[r] against columns Q[c], every product and sum
// rounded on its own in the plain version's order; dot_a = g_P.d,
// dot_b = g_Q.d. mask zeroes w and u where d2 == 0.
template <int T, bool kMass>
__device__ __forceinline__ void wc(const float* P, const float* Q, int r,
                                   int c, float softening, bool mask,
                                   float& w, float& cc, float& dot_a,
                                   float& dot_b) {
  const float dx = __fsub_rn(Q[c], P[r]);
  const float dy = __fsub_rn(Q[T + c], P[T + r]);
  const float dz = __fsub_rn(Q[2 * T + c], P[2 * T + r]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float inv = rsqrtf(__fadd_rn(d2, softening));
  const float inv2 = __fmul_rn(inv, inv);
  w = __fmul_rn(inv2, inv);
  float u = __fmul_rn(w, inv2);
  if (mask && d2 == 0.f) w = u = 0.f;
  dot_a = __fadd_rn(__fadd_rn(__fmul_rn(P[4 * T + r], dx),
                              __fmul_rn(P[5 * T + r], dy)),
                    __fmul_rn(P[6 * T + r], dz));
  dot_b = __fadd_rn(__fadd_rn(__fmul_rn(Q[4 * T + c], dx),
                              __fmul_rn(Q[5 * T + c], dy)),
                    __fmul_rn(Q[6 * T + c], dz));
  const float diff =
      kMass ? __fsub_rn(__fmul_rn(Q[3 * T + c], dot_a),
                        __fmul_rn(P[3 * T + r], dot_b))
            : __fsub_rn(dot_a, dot_b);
  cc = __fmul_rn(3.f, __fmul_rn(u, diff));
}

// Stage T bodies starting at row `row0` of pos (n, K), g (n, 3) and the
// operands q (n, 16) -> Qg, Qp (T x 8 bf16). Rows past n are
// FAR with zero mass, cotangent and operands.
template <int T, int K>
__device__ __forceinline__ void stage(const float* __restrict__ pos,
                                      const float* __restrict__ g,
                                      const float* __restrict__ q, int row0,
                                      int n, float* S, __nv_bfloat16* Qg,
                                      __nv_bfloat16* Qp) {
  for (int t = threadIdx.x; t < T * 4; t += kThreads) {
    const int r = t / 4, k = t % 4, row = row0 + r;
    float v = (k == 3) ? 0.f : kFar;
    if (row < n) v = k < K ? pos[static_cast<size_t>(row) * K + k] : 1.f;
    S[k * T + r] = v;
  }
  for (int t = threadIdx.x; t < T * 3; t += kThreads) {
    const int r = t / 3, k = t % 3, row = row0 + r;
    S[(4 + k) * T + r] = row < n ? g[static_cast<size_t>(row) * 3 + k] : 0.f;
  }
  for (int t = threadIdx.x; t < T * 16; t += kThreads) {
    const int r = t / 16, k = t % 16, row = row0 + r;
    const float v = row < n ? q[static_cast<size_t>(row) * 16 + k] : 0.f;
    (k < 8 ? Qg : Qp)[r * 8 + (k % 8)] = __float2bfloat16_rn(v);
  }
}

// Fold a warp's [hi | lo] products (32 x 8 each, row-major in `s`) and add
// or store row `lane` as 4 columns at dst.
__device__ __forceinline__ void fold_row(const float* s, int lane,
                                         float* out) {
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = s[lane * 8 + q] + s[lane * 8 + q + 4];
}

// ---------------------------------------------------------------- B13 ---

template <int T>
constexpr size_t mxu_smem_bytes() {
  return 4 * T * (T + 8) * sizeof(__nv_bfloat16)  // W, C (x2 for a fold)
         + 4 * T * 8 * sizeof(__nv_bfloat16)     // Qg, Qp of both blocks
         + kWarps * 2 * 32 * 8 * sizeof(float)    // per-warp products
         + 2 * kRows * T * sizeof(float)          // blocks
         + 2 * (T / 32 + kThreads / T) * T * sizeof(float);  // mass parts
}

template <int T, int K, int KO>
__global__ void __launch_bounds__(kThreads)
    vjp_mxu_kernel(const int* __restrict__ slots,
                   const float* __restrict__ pos_a,
                   const float* __restrict__ pos_b,
                   const float* __restrict__ g_a,
                   const float* __restrict__ g_b,
                   const float* __restrict__ q_a,
                   const float* __restrict__ q_b, float* part,
                   long long sys_rows, float softening, int mask_offdiag) {
  constexpr int LD = T + 8;
  constexpr int kTile = T * LD;
  constexpr int kMTiles = T / 32;
  constexpr int kRowParts = T / 32;      // warp chunks per row
  constexpr int kColParts = kThreads / T;  // threads per column
  constexpr bool kMass = K == 4;
  constexpr bool kMassGrad = KO == 9;
  static_assert(2 * kMTiles <= kWarps, "one warp per 32-row output tile");
  static_assert(kThreads % T == 0 && 2 * T <= kThreads,
                "a thread keeps one column; 2T threads fold the mass sums");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  // tiles + (2 s + 0) kTile: W (s = 0) or the fold's W_hi (s = 1);
  // tiles + (2 s + 1) kTile: C likewise.
  __nv_bfloat16* QgA = tiles + 4 * kTile;
  __nv_bfloat16* QpA = QgA + T * 8;
  __nv_bfloat16* QgB = QpA + T * 8;
  __nv_bfloat16* QpB = QgB + T * 8;
  float* scratch = reinterpret_cast<float*>(QpB + T * 8);
  float* SA = scratch + kWarps * 2 * 32 * 8;
  float* SB = SA + kRows * T;
  // Parts of the mass cotangent sums of block bi (A) and block bj (B): per
  // (row, warp chunk) and per (column thread, column).
  float* rowA = SB + kRows * T;
  float* rowB = rowA + kRowParts * T;
  float* colA = rowB + kRowParts * T;
  float* colB = colA + kColParts * T;

  const int kind = slots[3 * blockIdx.x];
  const int bi = slots[3 * blockIdx.x + 1];
  const int bj = slots[3 * blockIdx.x + 2];
  const bool fold = kind == kSlotFold;
  const bool mask = kind == kSlotDiag || mask_offdiag;
  const long long sys = blockIdx.y;
  pos_a += sys * sys_rows * K;
  pos_b += sys * sys_rows * K;
  g_a += sys * sys_rows * 3;
  g_b += sys * sys_rows * 3;
  q_a += sys * sys_rows * 16;
  q_b += sys * sys_rows * 16;
  // Side 0's tile (block bi), then side 1's (block bj).
  float* out = part + (sys * gridDim.x + blockIdx.x) * 2 * T * KO;

  stage<T, K>(pos_a, g_a, q_a, bi * T, (bi + 1) * T, SA, QgA, QpA);
  stage<T, K>(pos_b, g_b, q_b, bj * T, (bj + 1) * T, SB, QgB, QpB);
  __syncthreads();

  // The mass cotangent of a pair, -w (g_b.d) to its row and w (g_a.d) to its
  // column, is summed in a fixed order: a row's terms by warp shuffles within
  // each 32-column chunk, then the chunks in order; a column's terms in
  // registers by the one thread that visits it in each row it owns (the
  // stride kThreads is a multiple of T), then those threads in order.
  float col_a = 0.f, col_b = 0.f;
  for (int e = threadIdx.x; e < T * T; e += kThreads) {
    const int r = e / T, c = e % T;
    const bool upper = fold && c > r;
    const float* P = upper ? SB : SA;
    const float* Q = fold ? P : SB;
    float w, cc, dot_a, dot_b;
    wc<T, kMass>(P, Q, r, c, softening, mask, w, cc, dot_a, dot_b);
    if (fold && r == c) w = cc = 0.f;
    const int s = upper ? 1 : 0;
    tiles[(2 * s) * kTile + r * LD + c] = __float2bfloat16_rn(w);
    tiles[(2 * s + 1) * kTile + r * LD + c] = __float2bfloat16_rn(cc);
    if (fold) {
      tiles[(2 - 2 * s) * kTile + r * LD + c] = __float2bfloat16_rn(0.f);
      tiles[(3 - 2 * s) * kTile + r * LD + c] = __float2bfloat16_rn(0.f);
    }
    if (kMassGrad) {
      // A warp's 32 entries share row r (T is a multiple of 32).
      const float m_r = -__fmul_rn(w, dot_b);
      float lo = upper ? 0.f : m_r, hi = upper ? m_r : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        lo += __shfl_xor_sync(0xffffffffu, lo, off);
        hi += __shfl_xor_sync(0xffffffffu, hi, off);
      }
      if (threadIdx.x % 32 == 0) {
        rowA[r * kRowParts + c / 32] = lo;
        rowB[r * kRowParts + c / 32] = hi;
      }
      if (kind != kSlotDiag) {
        const float m_c = __fmul_rn(w, dot_a);
        if (fold && !upper)
          col_a += m_c;
        else
          col_b += m_c;
      }
    }
  }
  if (kMassGrad) {
    colA[threadIdx.x] = col_a;  // thread t keeps column t % T
    colB[threadIdx.x] = col_b;
  }
  __syncthreads();

  if (kMassGrad && threadIdx.x < 2 * T) {
    const int t = threadIdx.x % T;
    const bool b = threadIdx.x >= T;
    const float* rp = b ? rowB : rowA;
    const float* cp = b ? colB : colA;
    float m = 0.f;
    for (int q = 0; q < kRowParts; ++q) m += rp[t * kRowParts + q];
    for (int q = 0; q < kColParts; ++q) m += cp[q * T + t];
    if (!b || kind != kSlotDiag) out[(b ? T + t : t) * KO + 8] = m;
  }

  // Warp -> (side, 32-row output tile). Side 0's partial belongs to block bi
  // of side a, side 1's to block bj of side b.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int side = warp / kMTiles, m = warp % kMTiles;
  if (side > 1 || (kind == kSlotDiag && side == 1)) return;
  const bool rows = fold || side == 0;  // [W | C] @ operands
  const bool cols = fold || side == 1;  // [W | C]^T @ operands
  const __nv_bfloat16* Wt = tiles + (fold && side == 1 ? 2 * kTile : 0);
  const __nv_bfloat16* Ct = Wt + kTile;
  // FOLD: each side multiplies its own block's operands; DIAG / CROSS:
  // rows take block bj's (the column bodies), reactions block bi's.
  const bool own_a = (side == 0) == fold;
  const __nv_bfloat16* Qg = own_a ? QgA : QgB;
  const __nv_bfloat16* Qp = own_a ? QpA : QpB;

  Frag fg, fp;
  wmma::fill_fragment(fg, 0.f);
  wmma::fill_fragment(fp, 0.f);
#pragma unroll 2
  for (int k = 0; k < T / 16; ++k) {
    FragB bg, bp;
    wmma::load_matrix_sync(bg, Qg + k * 16 * 8, 8);
    wmma::load_matrix_sync(bp, Qp + k * 16 * 8, 8);
    if (rows) {
      FragA a;
      wmma::load_matrix_sync(a, Wt + m * 32 * LD + k * 16, LD);
      wmma::mma_sync(fg, a, bg, fg);
      wmma::load_matrix_sync(a, Ct + m * 32 * LD + k * 16, LD);
      wmma::mma_sync(fp, a, bp, fp);
    }
    if (cols) {
      FragAt at;
      wmma::load_matrix_sync(at, Wt + k * 16 * LD + m * 32, LD);
      wmma::mma_sync(fg, at, bg, fg);
      wmma::load_matrix_sync(at, Ct + k * 16 * LD + m * 32, LD);
      wmma::mma_sync(fp, at, bp, fp);
    }
  }
  float* sg = scratch + warp * 2 * 32 * 8;
  float* sp = sg + 32 * 8;
  wmma::store_matrix_sync(sg, fg, 8, wmma::mem_row_major);
  wmma::store_matrix_sync(sp, fp, 8, wmma::mem_row_major);
  __syncwarp();
  float v[8];
  fold_row(sg, lane, v);
  fold_row(sp, lane, v + 4);
  float* dst = out + (side * T + m * 32 + lane) * KO;
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q] = v[q];
}

template <int T, int K, int KO>
int launch_mxu(const int* slots, int n_slots, int n_sys, long long sys_rows,
               const float* pos_a, const float* pos_b, const float* g_a,
               const float* g_b, const float* q_a, const float* q_b,
               float* part, float softening, int mask_offdiag,
               cudaStream_t stream) {
  constexpr size_t smem = mxu_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      vjp_mxu_kernel<T, K, KO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vjp_mxu_kernel<T, K, KO><<<dim3(n_slots, n_sys), kThreads, smem, stream>>>(
      slots, pos_a, pos_b, g_a, g_b, q_a, q_b, part, sys_rows, softening,
      mask_offdiag);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int dispatch_mxu(const int* slots, int n_slots, int n_sys, long long sys_rows,
                 const float* pos_a, const float* pos_b, const float* g_a,
                 const float* g_b, const float* q_a, const float* q_b,
                 float* part, int masses, int ko, float softening,
                 int mask_offdiag, cudaStream_t s) {
#define NBODY_VJP_MXU_LAUNCH(K, KO)                                        \
  launch_mxu<T, K, KO>(slots, n_slots, n_sys, sys_rows, pos_a, pos_b, g_a, \
                       g_b, q_a, q_b, part, softening, mask_offdiag, s)
  if (!masses && ko == 8) return NBODY_VJP_MXU_LAUNCH(3, 8);
  if (masses && ko == 8) return NBODY_VJP_MXU_LAUNCH(4, 8);
  if (masses && ko == 9) return NBODY_VJP_MXU_LAUNCH(4, 9);
#undef NBODY_VJP_MXU_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- B14 ---

// One 16-row strip per warp (2T threads per CTA of T receivers), compiled
// for 24 warps per SM with masses (at most 85 registers) and 16 with unit
// masses, which spilled at 24 (80 registers). PERF.md: two strips per
// warp, as B6, ran slower at 8, 12 and 16 warps per SM, and one strip at 16
// or 32 warps no faster than at 24.

// Warps per SM B14 is compiled for, with masses (K = 4) or unit masses.
template <int K>
__host__ __device__ constexpr int rect_warps() {
  return K == 4 ? 24 : 16;
}

template <int T>
__host__ __device__ constexpr int rect_threads() {
  return 2 * T;  // T of them stage the j tile
}

// One staged j tile: (x, y, z, m) and (gx, gy, gz, 0) per body, and the
// B operands' transposes in bf16 (rows padded to T + 8): rows 0-7 are
// Qg^T = [hi | lo] of [g | m], rows 8-15 Qp^T = [hi | lo] of [p | 1].
template <int T>
struct RectTile {
  static constexpr int LDV = T + 8;
  float4 p[T];
  float4 g[T];
  __nv_bfloat16 vt[16 * LDV];
};

// A lane's receivers: rows r0 = 16 warp + g and r0 + 8 of the CTA's tile,
// (x, y, z, m) and (gx, gy, gz).
struct RectRows {
  int r0;
  float4 p0, p1;
  float3 g0, g1;
};

// fp32 w and c of receiver (p, gp) against source (q, gq), every product and
// sum rounded on its own in the plain version's order (vjp_mxu.py _wc); kD2
// zeroes w and u where d2 == 0.
template <bool kMass, bool kD2>
__device__ __forceinline__ void rect_wc(const float4& p, const float3& gp,
                                        const float4& q, const float4& gq,
                                        float softening, float& w,
                                        float& cc) {
  const float dx = __fsub_rn(q.x, p.x);
  const float dy = __fsub_rn(q.y, p.y);
  const float dz = __fsub_rn(q.z, p.z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float inv = slot_body::rsqrt_normal(__fadd_rn(d2, softening));
  const float inv2 = __fmul_rn(inv, inv);
  w = __fmul_rn(inv2, inv);
  float u = __fmul_rn(w, inv2);
  if (kD2 && d2 == 0.f) w = u = 0.f;
  const float dot_a = __fadd_rn(
      __fadd_rn(__fmul_rn(gp.x, dx), __fmul_rn(gp.y, dy)),
      __fmul_rn(gp.z, dz));
  const float dot_b = __fadd_rn(
      __fadd_rn(__fmul_rn(gq.x, dx), __fmul_rn(gq.y, dy)),
      __fmul_rn(gq.z, dz));
  const float diff = kMass ? __fsub_rn(__fmul_rn(q.w, dot_a),
                                       __fmul_rn(p.w, dot_b))
                           : __fsub_rn(dot_a, dot_b);
  cc = __fmul_rn(3.f, __fmul_rn(u, diff));
}

// One j tile's products, from fresh fragments: ag = W @ Qg and ap = C @ Qp
// over the tile's T / 16 column steps. Per step a lane computes the 8 (w, c)
// of its m16n8k16 A fragments, packs them to bf16 pairs and runs both
// products at once.
template <int T, bool kMass, bool kD2>
__device__ __forceinline__ void rect_tile(const RectRows& rw,
                                          const RectTile<T>& jt,
                                          float softening,
                                          float (&ag)[4], float (&ap)[4]) {
  constexpr int LDV = RectTile<T>::LDV;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* vg = reinterpret_cast<const uint32_t*>(jt.vt + g * LDV);
  const uint32_t* vp =
      reinterpret_cast<const uint32_t*>(jt.vt + (8 + g) * LDV);
#pragma unroll
  for (int q = 0; q < 4; ++q) ag[q] = ap[q] = 0.f;
#pragma unroll
  for (int s = 0; s < T / 16; ++s) {
    // The lane's columns: c0, c0 + 1 (A registers 0, 1), c0 + 8, c0 + 9
    // (registers 2, 3).
    const int c0 = 16 * s + 2 * t;
    const int cs[4] = {c0, c0 + 1, c0 + 8, c0 + 9};
    float4 q[4], gq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = jt.p[cs[k]];
      gq[k] = jt.g[cs[k]];
    }
    const uint32_t bg0 = vg[c0 / 2], bg1 = vg[(c0 + 8) / 2];
    const uint32_t bp0 = vp[c0 / 2], bp1 = vp[(c0 + 8) / 2];
    float w[2][4], c[2][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rect_wc<kMass, kD2>(rw.p0, rw.g0, q[k], gq[k], softening, w[0][k],
                          c[0][k]);
      rect_wc<kMass, kD2>(rw.p1, rw.g1, q[k], gq[k], softening, w[1][k],
                          c[1][k]);
    }
    // A fragment: (r0, c0..c0+1), (r0 + 8, c0..c0+1), (r0, c0+8..c0+9),
    // (r0 + 8, c0+8..c0+9).
    const uint32_t aw[4] = {slot_body::pack_bf16x2(w[0][0], w[0][1]),
                            slot_body::pack_bf16x2(w[1][0], w[1][1]),
                            slot_body::pack_bf16x2(w[0][2], w[0][3]),
                            slot_body::pack_bf16x2(w[1][2], w[1][3])};
    const uint32_t ac[4] = {slot_body::pack_bf16x2(c[0][0], c[0][1]),
                            slot_body::pack_bf16x2(c[1][0], c[1][1]),
                            slot_body::pack_bf16x2(c[0][2], c[0][3]),
                            slot_body::pack_bf16x2(c[1][2], c[1][3])};
    slot_body::mma_bf16(ag, aw, bg0, bg1);
    slot_body::mma_bf16(ap, ac, bp0, bp1);
  }
}

// Receiver `row` (FAR with zero mass and cotangent past nk).
template <int K>
__device__ __forceinline__ void rect_receiver(const float* __restrict__ pos,
                                              const float* __restrict__ g,
                                              int row, int nk, float4& p,
                                              float3& gp) {
  p = make_float4(kFar, kFar, kFar, 0.f);
  gp = make_float3(0.f, 0.f, 0.f);
  if (row >= nk) return;
  const float* pr = pos + static_cast<size_t>(row) * K;
  p = make_float4(pr[0], pr[1], pr[2], K == 4 ? pr[3] : 1.f);
  const float* gr = g + static_cast<size_t>(row) * 3;
  gp = make_float3(gr[0], gr[1], gr[2]);
}

template <int T, int K>
__global__ void __launch_bounds__(
    rect_threads<T>(),
    slot_body::stream_min_ctas(rect_threads<T>(), rect_warps<K>()))
    vjp_rect_mxu_kernel(const float* __restrict__ pos_k,
                        const float* __restrict__ g_k, int nk,
                        const float* __restrict__ pos_j,
                        const float* __restrict__ g_j, int nj,
                        float* __restrict__ rows, float softening,
                        int overlap_only) {
  constexpr int LDV = RectTile<T>::LDV;
  constexpr bool kMass = K == 4;
  __shared__ RectTile<T> tiles[2];
  __shared__ __align__(16) float S[T * 16];
  const int kt = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // The lane's receivers and their running sums (hi and lo columns).
  RectRows rw;
  float sg[4], sp[4];
  rw.r0 = 16 * warp + g;
  rect_receiver<K>(pos_k, g_k, kt * T + rw.r0, nk, rw.p0, rw.g0);
  rect_receiver<K>(pos_k, g_k, kt * T + rw.r0 + 8, nk, rw.p1, rw.g1);
#pragma unroll
  for (int q = 0; q < 4; ++q) sg[q] = sp[q] = 0.f;

  // Source jt * T + tid in registers: loaded one tile ahead, then staged.
  float x, y, z, m, hx, hy, hz;
  bool real;
  auto load = [&](int jt) {
    const int row = jt * T + tid;
    real = row < nj;
    x = y = z = kFar;
    m = hx = hy = hz = 0.f;
    if (!real) return;
    const float* pr = pos_j + static_cast<size_t>(row) * K;
    x = pr[0];
    y = pr[1];
    z = pr[2];
    m = K == 4 ? pr[3] : 1.f;
    const float* gr = g_j + static_cast<size_t>(row) * 3;
    hx = gr[0];
    hy = gr[1];
    hz = gr[2];
  };
  // The operands [g | m] and [p | 1] split into bf16 hi and lo halves, as
  // the wrapper's _split8 (hi = bf16(v), lo = bf16(v - hi)); zero for pads.
  auto stage = [&](RectTile<T>& b) {
    b.p[tid] = make_float4(x, y, z, m);
    b.g[tid] = make_float4(hx, hy, hz, 0.f);
    const float v[8] = {hx, hy, hz, m, x, y, z, 1.f};
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = (k / 4) * 8 + k % 4;  // Qg^T rows 0-3, Qp^T rows 8-11
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[k]);
      const __nv_bfloat16 lo =
          __float2bfloat16_rn(__fsub_rn(v[k], __bfloat162float(hi)));
      b.vt[r * LDV + tid] = real ? hi : zero;
      b.vt[(r + 4) * LDV + tid] = real ? lo : zero;
    }
  };

  const int n_jt = (nj + T - 1) / T;
  const bool stager = tid < T;
  if (stager) load(0);
  for (int jt = 0; jt < n_jt; ++jt) {
    // Buffer jt & 1 was last read two tiles ago, before the last barrier.
    RectTile<T>& b = tiles[jt & 1];
    if (stager) stage(b);
    __syncthreads();
    if (stager && jt + 1 < n_jt) load(jt + 1);
    float ag[4], ap[4];
    if (!overlap_only || jt == kt)
      rect_tile<T, kMass, true>(rw, b, softening, ag, ap);
    else
      rect_tile<T, kMass, false>(rw, b, softening, ag, ap);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sg[q] = __fadd_rn(sg[q], ag[q]);
      sp[q] = __fadd_rn(sp[q], ap[q]);
    }
  }

  // Epilogue, one thread per receiver: fold hi + lo of both products. C
  // fragments: (row r0, columns 2t, 2t + 1), (row r0 + 8, the same); S holds
  // a row's [S_g | S_p] hi and lo columns (16 floats).
  float* a = S + rw.r0 * 16 + 2 * t;
  float* b = a + 8 * 16;
  *reinterpret_cast<float2*>(a) = make_float2(sg[0], sg[1]);
  *reinterpret_cast<float2*>(b) = make_float2(sg[2], sg[3]);
  *reinterpret_cast<float2*>(a + 8) = make_float2(sp[0], sp[1]);
  *reinterpret_cast<float2*>(b + 8) = make_float2(sp[2], sp[3]);
  __syncthreads();
  const int row = kt * T + tid;
  if (tid >= T || row >= nk) return;
  const float* s = S + tid * 16;
  float* o = rows + static_cast<size_t>(row) * 8;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[q] = __fadd_rn(s[q], s[q + 4]);
    o[4 + q] = __fadd_rn(s[8 + q], s[12 + q]);
  }
}

using RectKernel = void (*)(const float*, const float*, int, const float*,
                            const float*, int, float*, float, int);

// B14's kernel for (tile, masses) and its threads per CTA, or nullptr.
RectKernel pick_rect(int tile, int masses, int* threads) {
  if (tile == 64) {
    *threads = rect_threads<64>();
    return masses ? vjp_rect_mxu_kernel<64, 4> : vjp_rect_mxu_kernel<64, 3>;
  }
  if (tile == 128) {
    *threads = rect_threads<128>();
    return masses ? vjp_rect_mxu_kernel<128, 4>
                  : vjp_rect_mxu_kernel<128, 3>;
  }
  return nullptr;
}

}  // namespace

// B13 and B9d. slots (n_slots, 3) int32 (kind, bi, bj); pos_a / pos_b
// (rows, 3), or (rows, 4) with masses (x, y, z, m); g_a / g_b (rows, 3);
// q_a / q_b (rows, 16) operands [split([g | m]) | split([p | 1])]; rows of
// each a multiple of tile; n_sys systems of such rows, sys_rows rows apart
// (tri mode; 1 system in cross mode); fp32, contiguous, on the current
// device. part: n_sys x n_slots x 2 tiles of (tile, ko) fp32, ko = 8, or 9
// with the mass cotangent (masses only), written (side 0 of slot s: block
// bi's raw sums; side 1: block bj's; a DIAG slot writes side 0 only) for
// slot_reduce_launch. tile: 64 or 128. Returns cudaGetLastError() after the
// launch.
extern "C" int vjp_mxu_launch(const int* slots, int n_slots, int n_sys,
                              long long sys_rows, const float* pos_a,
                              const float* pos_b, const float* g_a,
                              const float* g_b, const float* q_a,
                              const float* q_b, float* part, int masses,
                              int ko, int tile, float softening,
                              int mask_offdiag, void* stream) {
  if (n_slots == 0 || n_sys == 0) return 0;
  if (n_sys > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64)
    return dispatch_mxu<64>(slots, n_slots, n_sys, sys_rows, pos_a, pos_b,
                            g_a, g_b, q_a, q_b, part, masses, ko, softening,
                            mask_offdiag, s);
  if (tile == 128)
    return dispatch_mxu<128>(slots, n_slots, n_sys, sys_rows, pos_a, pos_b,
                             g_a, g_b, q_a, q_b, part, masses, ko, softening,
                             mask_offdiag, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B14. pos_k (nk, 3|4), g_k (nk, 3); pos_j (nj, 3|4), g_j (nj, 3); rows
// (nk, 8) raw [S_g | S_p] out; masses: the positions carry m as a 4th
// column; fp32, contiguous, on the current device. The kernel forms the
// operands [split([g | m]) | split([p | 1])] of each staged j body itself.
// overlap_only: mask d2 == 0 only in the j tile that is the CTA's k tile
// (square calls). tile: 64 or 128. Returns cudaGetLastError().
extern "C" int vjp_rect_mxu_launch(const float* pos_k, const float* g_k,
                                   int nk, const float* pos_j,
                                   const float* g_j, int nj, float* rows,
                                   int masses, int tile, float softening,
                                   int overlap_only, void* stream) {
  if (nk == 0) return 0;
  int threads = 0;
  const RectKernel kernel = pick_rect(tile, masses, &threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(nk + tile - 1) / tile, threads, 0,
           static_cast<cudaStream_t>(stream)>>>(pos_k, g_k, nk, pos_j, g_j,
                                                nj, rows, softening,
                                                overlap_only);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers per thread, local bytes per thread, CTAs per SM and
// threads per CTA (two a receiver) of B14's kernel for (tile, masses).
extern "C" int vjp_rect_mxu_info(int tile, int masses, int* out) {
  int threads = 0;
  const RectKernel kernel = pick_rect(tile, masses, &threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = threads;
  return static_cast<int>(err);
}
