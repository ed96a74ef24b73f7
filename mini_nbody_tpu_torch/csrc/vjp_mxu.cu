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
// rounded to bf16 for the tensor cores, operands split into compensated
// hi/lo bf16 halves (_split8, :224-228), fp32 accumulation; JAX folds hi +
// lo per block (:117-121), and so do these kernels before they store their
// partials (B13) or rows (B14).
//
// B13: K2's step loop (csrc/slot_body.cuh mxu_steps) with two products and
// a transposed side, in place of a design that stored the T x T tiles of w
// and c as bf16 in shared memory and read them back through wmma loads
// (177,152 bytes of shared memory at T = 128: one CTA of 8 warps per SM,
// its fp32 and tensor-core phases never overlapping). One slot (kind, bi,
// bj) of K2's slot + fold geometry at a time:
//   DIAG  (bi == bj): always masked where d2 == 0, row sums only (the rows
//         cover both orders).
//   CROSS: rows to block bi (side a) with block bj's operands, reactions
//         to block bj (side b) with block bi's.
//   FOLD  (bj == bi + 1): entry (r, c) is pair (a_r, a_c) for c < r and
//         (b_r, b_c) for c > r: two passes over the full tile, one per side
//         with w and c zeroed off its triangle and on the diagonal, each
//         side's rows and reactions against its own block's operands.
// CROSS and FOLD are masked where d2 == 0 iff mask_offdiag; the maskless
// body is a compile-time instantiation whose w and c are the masked body's
// bits. A CTA of T / 32 warps, two 16-row strips a warp (T / 16 warps of
// one strip with the mass cotangent), walks its slots persistently
// (slot_body::stream_width and walk_slots). For each 16-column step a lane
// computes in fp32, for each strip, the 8 (w, c) of its mma.sync m16n8k16
// A fragments, packs them with cvt.rn.bf16x2 and runs W @ Qg and C @ Qp
// for the rows; movmatrix .trans turns the same registers into W^T's and
// C^T's fragments for the reactions, W^T @ Qg and C^T @ Qp against the
// rows' operands. No w or c touches shared memory. The
// operands (the wrapper's [hi | lo] splits of [g | m] and [p | 1]) are
// staged once per slot in bf16 in the B fragment's layout. Each strip's row
// products are one fresh fragment per slot and pass; each step's reaction
// products (both strips) go to shared memory per warp, and the warps'
// partials are added in increasing warp index; hi + lo is folded once,
// into the slot's (T, 8|9) partial tile. The mass cotangent is summed in
// fp32 on the CUDA cores in one fixed order (quad shuffles, then the warps
// in increasing index). Each CTA stores its two T x (8|9) partials (side 0:
// block bi, side 1: block bj), and csrc/slot_reduce.cu adds each block's
// partials in slot order, so every output bit is the same on every run.
// The TPU's single-launch bound does not apply: the wrapper keeps K3's
// chunk loop.
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
// operations and one rsqrt per pair, JAX's count, vjp_mxu.py:367), and in
// fact their issue rate: ~28 instructions a pair for w and c alone in the
// plain version's rounding (no FMA). B13 adds the packs, movmatrix, four
// MMAs a step and its column loads, which two strips a warp share: 33-37
// instructions a pair over its step loop by the count of its SASS
// (ab_slots.py). It runs
// T threads at T = 64 and 128 with at most 168 registers, 12 warps per SM;
// its dynamic shared memory (the staged blocks, the operands' transposes,
// a pass's row products and the warps' reaction products) is 20,992 bytes
// at T = 64 and 57,856 at T = 128, with the mass cotangent 30,464 and
// 95,232 (one strip a warp, 16 warps per SM). B14 takes 25,088 bytes of
// static shared memory at T = 128, ~33 instructions per pair by the count
// of its SASS (ab_slots.py). The launches return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

constexpr float kFar = 1.0e18f;
constexpr int kSlotDiag = 0;
constexpr int kSlotFold = 2;

// fp32 w and c of the pair (p, gp) -> (q, gq), every product and sum
// rounded on its own in the plain version's order (vjp_mxu.py _wc), and the
// dot products of the mass cotangent, dot_a = gp.d and dot_b = gq.d. w and
// u are zeroed where d2 == 0 (kD2) and where !keep (a fold pass's other
// triangle), before c is formed.
template <bool kMass, bool kD2>
__device__ __forceinline__ void pair_wc(const float4& p, const float3& gp,
                                        const float4& q, const float4& gq,
                                        float softening, bool keep, float& w,
                                        float& cc, float& dot_a,
                                        float& dot_b) {
  const float dx = __fsub_rn(q.x, p.x);
  const float dy = __fsub_rn(q.y, p.y);
  const float dz = __fsub_rn(q.z, p.z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float inv = slot_body::rsqrt_normal(__fadd_rn(d2, softening));
  const float inv2 = __fmul_rn(inv, inv);
  w = __fmul_rn(inv2, inv);
  float u = __fmul_rn(w, inv2);
  if ((kD2 && d2 == 0.f) || !keep) w = u = 0.f;
  dot_a = __fadd_rn(__fadd_rn(__fmul_rn(gp.x, dx), __fmul_rn(gp.y, dy)),
                    __fmul_rn(gp.z, dz));
  dot_b = __fadd_rn(__fadd_rn(__fmul_rn(gq.x, dx), __fmul_rn(gq.y, dy)),
                    __fmul_rn(gq.z, dz));
  const float diff = kMass ? __fsub_rn(__fmul_rn(q.w, dot_a),
                                       __fmul_rn(p.w, dot_b))
                           : __fsub_rn(dot_a, dot_b);
  cc = __fmul_rn(3.f, __fmul_rn(u, diff));
}

// ---------------------------------------------------------------- B13 ---

// 16-row strips of the T x T slot tile per warp, and the warps per SM the
// kernel is compiled for, chosen by measurement (ab_slots.py, PERF.md):
// two strips at 12 warps (at most 168 registers a thread), which share
// each step's column loads; with the mass cotangent (KO = 9) one strip at
// 16 warps (128 registers), where two strips spilled.
template <int KO>
__host__ __device__ constexpr int sym_mxu_strips() {
  return KO == 9 ? 1 : 2;
}

template <int KO>
__host__ __device__ constexpr int sym_mxu_warps() {
  return KO == 9 ? 16 : 12;
}

template <int T, int KO>
__host__ __device__ constexpr int sym_mxu_threads() {
  return 32 * T / (16 * sym_mxu_strips<KO>());
}

// A product partial row: [W @ Qg | C @ Qp] with Qg = [hi | lo] of [g | m]
// and Qp = [hi | lo] of [p | 1], 16 floats. Operand column k of body c sits
// at word c * 16 + (k ^ 8 ((c >> 1) & 1)): the C fragments' float2 stores of
// a warp hit no bank twice, and each quad (hi or lo of one product) stays a
// float4.
__device__ __forceinline__ int part_word(int c, int k) {
  return c * 16 + (k ^ (((c >> 1) & 1) << 3));
}

template <int T, int KO>
constexpr size_t sym_mxu_smem_bytes() {
  constexpr int kWarps = sym_mxu_threads<T, KO>() / 32;
  // two staged blocks ((x, y, z, m) and (gx, gy, gz, 0) float4s per body),
  // their operands' transposes in bf16 (16 rows padded to T + 8), a pass's
  // row products and the warps' reaction products (16 floats a body), and
  // with the mass cotangent its row sums and the warps' column sums
  return 4 * T * sizeof(float4) +
         2 * 16 * (T + 8) * sizeof(__nv_bfloat16) +
         (1 + kWarps) * T * (16 + (KO == 9 ? 1 : 0)) * sizeof(float);
}

// One block of a slot: load() records where its positions (K floats a
// body), cotangents (3) and operands (16) are; store() reads them and
// writes the positions and cotangents to shared float4s, (x, y, z, m) at
// sp and (gx, gy, gz, -) at sg (the unit-mass kernel reads no m), and the
// operands' transposes rounded to bf16 at vt (row k = operand column k,
// padded to T + 8): rows 0-7 Qg^T, 8-15 Qp^T. The next slot's blocks are
// not read ahead into registers: with two strips a warp that spilled.
template <int T, int K, int kThreads>
struct SymMxuBlock {
  static constexpr int kP = (T * K + kThreads - 1) / kThreads;
  static constexpr int kG = (T * 3 + kThreads - 1) / kThreads;
  static constexpr int kQ = 4 * T / kThreads;  // float4s of q per thread
  static_assert(kQ * kThreads == 4 * T, "whole float4s of q per thread");
  const float* pos;
  const float* gr;
  const float4* q;

  __device__ __forceinline__ void load(const float* __restrict__ pos_,
                                       const float* __restrict__ gr_,
                                       const float* __restrict__ q_) {
    pos = pos_;
    gr = gr_;
    q = reinterpret_cast<const float4*>(q_);
  }

  __device__ __forceinline__ void store(float* sp, float* sg,
                                        __nv_bfloat16* vt) const {
    constexpr int LDV = T + 8;
    float p[kP], g[kG];
    float4 v[kQ];
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
#pragma unroll
    for (int l = 0; l < kQ; ++l) v[l] = q[threadIdx.x + l * kThreads];
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
#pragma unroll
    for (int l = 0; l < kQ; ++l) {
      // Float4 f of a block's (T, 16) q is body f / 4, columns 4 (f % 4) ..
      const int f = threadIdx.x + l * kThreads;
      const int r = f >> 2, k = 4 * (f & 3);
      vt[(k + 0) * LDV + r] = __float2bfloat16_rn(v[l].x);
      vt[(k + 1) * LDV + r] = __float2bfloat16_rn(v[l].y);
      vt[(k + 2) * LDV + r] = __float2bfloat16_rn(v[l].z);
      vt[(k + 3) * LDV + r] = __float2bfloat16_rn(v[l].w);
    }
  }
};

// The shared memory of a B13 CTA.
template <int T, int KO>
struct SymMxuSmem {
  static constexpr int kWarps = sym_mxu_threads<T, KO>() / 32;
  static constexpr int LDV = T + 8;
  float4* p[2];  // (x, y, z, m) of block bi (side a) and block bj (side b)
  float4* g[2];  // (gx, gy, gz, -)
  __nv_bfloat16* vt[2];
  float* rows;   // T x 16 row products of a pass
  float* cols;   // warps x T x 16 reaction products
  float* mrow;   // T mass-cotangent row sums (KO == 9)
  float* mcol;   // warps x T column sums (KO == 9)

  __device__ __forceinline__ explicit SymMxuSmem(unsigned char* base) {
    float4* f4 = reinterpret_cast<float4*>(base);
    p[0] = f4;
    g[0] = f4 + T;
    p[1] = f4 + 2 * T;
    g[1] = f4 + 3 * T;
    vt[0] = reinterpret_cast<__nv_bfloat16*>(f4 + 4 * T);
    vt[1] = vt[0] + 16 * LDV;
    rows = reinterpret_cast<float*>(vt[1] + 16 * LDV);
    cols = rows + T * 16;
    mrow = cols + kWarps * T * 16;
    mcol = mrow + T;
  }
};

// One pass of B13 over the T x T pairs of block P (rows: positions P,
// cotangents PG, operands VP) against block Q (columns). Warp m owns the
// strips of rows [16 (S m + h), 16 (S m + h) + 16), h < S =
// sym_mxu_strips<KO>();
// for each 16-column step a lane computes in fp32, for each strip, the 8
// (w, c) of its m16n8k16 A fragments (rows g and g + 8 of the strip,
// columns 2t, 2t + 1, 2t + 8, 2t + 9 of the step), packs them to bf16 pairs
// and runs
//   rows:      ag[h] += W @ Qg_Q,    ap[h] += C @ Qp_Q,
//   reactions: W^T @ Qg_P,  C^T @ Qp_P   (kCols; a fresh fragment per step,
//              summing the warp's strips),
// W^T's and C^T's fragments being W's and C's 8 x 8 blocks through
// movmatrix .trans. Each strip's row products are one fresh fragment per
// pass and go to rows; each step's reaction products are this warp's alone
// and go to cols at once. With KO = 9 the mass cotangent, -w (g_Q.d) to
// the row and +w (g_P.d) to the column, is summed in fp32 on the CUDA
// cores: a row's in the lane's registers over the pass, then across its
// quad; a step's columns across the lanes that share them (lane bits 2-4)
// into this warp's mcol. Then a barrier.
template <int T, int KO, bool kMass, bool kCols, bool kD2, bool kTri>
__device__ __forceinline__ void sym_mxu_pass(
    const float4* P, const float4* PG, const __nv_bfloat16* VP,
    const float4* Q, const float4* QG, const __nv_bfloat16* VQ, int tri,
    float softening, const SymMxuSmem<T, KO>& sm) {
  constexpr int LDV = T + 8;
  constexpr int S = sym_mxu_strips<KO>();
  constexpr bool kMassGrad = KO == 9;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // Operand column g of the strips' rows and of the step's columns, as B
  // fragments (k = bodies): Qg^T row g and Qp^T row g.
  const uint32_t* vpg = reinterpret_cast<const uint32_t*>(VP + g * LDV);
  const uint32_t* vpp = reinterpret_cast<const uint32_t*>(VP + (8 + g) * LDV);
  const uint32_t* vqg = reinterpret_cast<const uint32_t*>(VQ + g * LDV);
  const uint32_t* vqp = reinterpret_cast<const uint32_t*>(VQ + (8 + g) * LDV);
  int r0[S];
  float4 p0[S], p1[S];
  float3 g0[S], g1[S];
  uint32_t rg0[S], rg1[S], rp0[S], rp1[S];
  float ag[S][4], ap[S][4], mr0[S], mr1[S];
#pragma unroll
  for (int h = 0; h < S; ++h) {
    const int strip = 16 * (S * warp + h);
    r0[h] = strip + g;
    p0[h] = P[r0[h]];
    p1[h] = P[r0[h] + 8];
    const float4 h0 = PG[r0[h]], h1 = PG[r0[h] + 8];
    g0[h] = make_float3(h0.x, h0.y, h0.z);
    g1[h] = make_float3(h1.x, h1.y, h1.z);
    rg0[h] = vpg[(strip + 2 * t) / 2];
    rg1[h] = vpg[(strip + 2 * t + 8) / 2];
    rp0[h] = vpp[(strip + 2 * t) / 2];
    rp1[h] = vpp[(strip + 2 * t + 8) / 2];
#pragma unroll
    for (int k = 0; k < 4; ++k) ag[h][k] = ap[h][k] = 0.f;
    mr0[h] = mr1[h] = 0.f;
  }
  float* cw = sm.cols + warp * T * 16;
  float* mw = sm.mcol + warp * T;

  // The step loop is not unrolled: unrolled, it spilled at two strips (168
  // registers) and at one (128).
#pragma unroll 1
  for (int s = 0; s < T / 16; ++s) {
    // The lane's columns: c0, c0 + 1 (A registers 0, 1), c0 + 8, c0 + 9
    // (registers 2, 3).
    const int c0 = 16 * s + 2 * t;
    const int cs[4] = {c0, c0 + 1, c0 + 8, c0 + 9};
    float cg[4] = {0.f, 0.f, 0.f, 0.f}, cp[4] = {0.f, 0.f, 0.f, 0.f};
    float mc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < S; ++h) {
      const int r1 = r0[h] + 8;
      float w[2][4], c[2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 q = Q[cs[k]], hq = QG[cs[k]];
        float da0, db0, da1, db1;
        pair_wc<kMass, kD2>(
            p0[h], g0[h], q, hq, softening,
            !kTri || !slot_body::off_triangle(tri, r0[h], cs[k]), w[0][k],
            c[0][k], da0, db0);
        pair_wc<kMass, kD2>(
            p1[h], g1[h], q, hq, softening,
            !kTri || !slot_body::off_triangle(tri, r1, cs[k]), w[1][k],
            c[1][k], da1, db1);
        if (kMassGrad) {
          mr0[h] -= w[0][k] * db0;
          mr1[h] -= w[1][k] * db1;
          mc[k] += w[0][k] * da0 + w[1][k] * da1;
        }
      }
      // A fragment: (r0, c0..c0+1), (r1, c0..c0+1), (r0, c0+8..c0+9),
      // (r1, c0+8..c0+9).
      const uint32_t aw[4] = {slot_body::pack_bf16x2(w[0][0], w[0][1]),
                              slot_body::pack_bf16x2(w[1][0], w[1][1]),
                              slot_body::pack_bf16x2(w[0][2], w[0][3]),
                              slot_body::pack_bf16x2(w[1][2], w[1][3])};
      const uint32_t ac[4] = {slot_body::pack_bf16x2(c[0][0], c[0][1]),
                              slot_body::pack_bf16x2(c[1][0], c[1][1]),
                              slot_body::pack_bf16x2(c[0][2], c[0][3]),
                              slot_body::pack_bf16x2(c[1][2], c[1][3])};
      slot_body::mma_bf16(ag[h], aw, vqg[c0 / 2], vqg[(c0 + 8) / 2]);
      slot_body::mma_bf16(ap[h], ac, vqp[c0 / 2], vqp[(c0 + 8) / 2]);
      if (kCols) {
        // W^T's blocks: (0, 0) = a0^T, (1, 0) = a2^T, (0, 1) = a1^T,
        // (1, 1) = a3^T; the same for C^T.
        const uint32_t awt[4] = {
            slot_body::transpose_8x8(aw[0]), slot_body::transpose_8x8(aw[2]),
            slot_body::transpose_8x8(aw[1]), slot_body::transpose_8x8(aw[3])};
        const uint32_t act[4] = {
            slot_body::transpose_8x8(ac[0]), slot_body::transpose_8x8(ac[2]),
            slot_body::transpose_8x8(ac[1]), slot_body::transpose_8x8(ac[3])};
        slot_body::mma_bf16(cg, awt, rg0[h], rg1[h]);
        slot_body::mma_bf16(cp, act, rp0[h], rp1[h]);
      }
    }
    if (kCols) {
      // C fragments: column 16 s + g, then 16 s + g + 8; operand columns
      // 2t, 2t + 1 of each product.
      const int ca = 16 * s + g, cb = ca + 8;
      *reinterpret_cast<float2*>(cw + part_word(ca, 2 * t)) =
          make_float2(cg[0], cg[1]);
      *reinterpret_cast<float2*>(cw + part_word(cb, 2 * t)) =
          make_float2(cg[2], cg[3]);
      *reinterpret_cast<float2*>(cw + part_word(ca, 8 + 2 * t)) =
          make_float2(cp[0], cp[1]);
      *reinterpret_cast<float2*>(cw + part_word(cb, 8 + 2 * t)) =
          make_float2(cp[2], cp[3]);
      if (kMassGrad) {
        // The step's 16 column sums over the 8 lanes that share each
        // (lane bits 4, 3, 2): halve twice, then add; the lanes with bit 2
        // clear write column c0 + (bit 3) + 8 (bit 4).
        const bool up4 = lane & 16, up3 = lane & 8;
        float a0 = up4 ? mc[2] : mc[0], a1 = up4 ? mc[3] : mc[1];
        a0 += __shfl_xor_sync(0xffffffffu, up4 ? mc[0] : mc[2], 16);
        a1 += __shfl_xor_sync(0xffffffffu, up4 ? mc[1] : mc[3], 16);
        float b = up3 ? a1 : a0;
        b += __shfl_xor_sync(0xffffffffu, up3 ? a0 : a1, 8);
        b += __shfl_xor_sync(0xffffffffu, b, 4);
        if (!(lane & 4)) mw[c0 + (up3 ? 1 : 0) + (up4 ? 8 : 0)] = b;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < S; ++h) {
    // C fragments: (row r0, operand columns 2t, 2t + 1), (row r0 + 8, the
    // same).
    const int r1 = r0[h] + 8;
    *reinterpret_cast<float2*>(sm.rows + part_word(r0[h], 2 * t)) =
        make_float2(ag[h][0], ag[h][1]);
    *reinterpret_cast<float2*>(sm.rows + part_word(r1, 2 * t)) =
        make_float2(ag[h][2], ag[h][3]);
    *reinterpret_cast<float2*>(sm.rows + part_word(r0[h], 8 + 2 * t)) =
        make_float2(ap[h][0], ap[h][1]);
    *reinterpret_cast<float2*>(sm.rows + part_word(r1, 8 + 2 * t)) =
        make_float2(ap[h][2], ap[h][3]);
    if (kMassGrad) {
      // A row's sum over its quad (lane bits 0, 1).
      float m0 = mr0[h], m1 = mr1[h];
      m0 += __shfl_xor_sync(0xffffffffu, m0, 1);
      m1 += __shfl_xor_sync(0xffffffffu, m1, 1);
      m0 += __shfl_xor_sync(0xffffffffu, m0, 2);
      m1 += __shfl_xor_sync(0xffffffffu, m1, 2);
      if (t == 0) {
        sm.mrow[r0[h]] = m0;
        sm.mrow[r1] = m1;
      }
    }
  }
  __syncthreads();
}

// One side's (T, KO) partial tile at dst from a pass: its row products
// (kRows), the warps' reaction products added in increasing warp index
// (kCols), or their sum; each product's hi and lo columns folded once, here.
// Item (body c, half h) is columns 4h .. 4h + 3 ([S_g] or [S_p]) and, with
// KO = 9 and h = 0, the mass cotangent.
template <int T, int KO, bool kRows, bool kCols>
__device__ __forceinline__ void sym_mxu_side(float* dst,
                                             const SymMxuSmem<T, KO>& sm) {
  constexpr int kWarps = SymMxuSmem<T, KO>::kWarps;
  auto quad = [](const float* base, int word) {
    return *reinterpret_cast<const float4*>(base + word);
  };
  auto add = [](float4 a, const float4& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
    return a;
  };
  for (int it = threadIdx.x; it < 2 * T; it += sym_mxu_threads<T, KO>()) {
    const int c = it >> 1, h = it & 1;
    const int hi = part_word(c, 8 * h), lo = part_word(c, 8 * h + 4);
    float4 v;
    if (kRows) v = add(quad(sm.rows, hi), quad(sm.rows, lo));
    if (kCols) {
      float4 shi = quad(sm.cols, hi), slo = quad(sm.cols, lo);
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        shi = add(shi, quad(sm.cols + w * T * 16, hi));
        slo = add(slo, quad(sm.cols + w * T * 16, lo));
      }
      const float4 r = add(shi, slo);
      v = kRows ? add(v, r) : r;
    }
    float* o = dst + c * KO + 4 * h;
    if (KO == 8) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
      if (h == 0) {
        float m = 0.f;
        if (kCols) {
          m = sm.mcol[c];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) m += sm.mcol[w * T + c];
        }
        dst[c * KO + 8] = kRows ? (kCols ? sm.mrow[c] + m : sm.mrow[c]) : m;
      }
    }
  }
}

// The slot's passes on its staged blocks (SymMxuBlock::store, then a
// barrier); out: its two (T, KO) partial tiles.
template <int T, int K, int KO>
__device__ __forceinline__ void sym_mxu_compute(int kind, int mask_offdiag,
                                                float* out, float softening,
                                                const SymMxuSmem<T, KO>& sm) {
  constexpr bool kMass = K == 4;
  if (kind == kSlotFold) {
    // Side a's triangle (c < r), then side b's (c > r): rows + reactions,
    // each side its own block's operands.
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (mask_offdiag)
        sym_mxu_pass<T, KO, kMass, true, true, true>(
            sm.p[side], sm.g[side], sm.vt[side], sm.p[side], sm.g[side],
            sm.vt[side], 1 + side, softening, sm);
      else
        sym_mxu_pass<T, KO, kMass, true, false, true>(
            sm.p[side], sm.g[side], sm.vt[side], sm.p[side], sm.g[side],
            sm.vt[side], 1 + side, softening, sm);
      sym_mxu_side<T, KO, true, true>(out + side * T * KO, sm);
      __syncthreads();
    }
  } else if (kind == kSlotDiag) {
    // The block's ordered pairs, rows only (they cover both orders).
    sym_mxu_pass<T, KO, kMass, false, true, false>(
        sm.p[0], sm.g[0], sm.vt[0], sm.p[1], sm.g[1], sm.vt[1], 0, softening,
        sm);
    sym_mxu_side<T, KO, true, false>(out, sm);
  } else {
    // Rows to block bi with block bj's operands, reactions to block bj
    // with block bi's.
    if (mask_offdiag)
      sym_mxu_pass<T, KO, kMass, true, true, false>(
          sm.p[0], sm.g[0], sm.vt[0], sm.p[1], sm.g[1], sm.vt[1], 0,
          softening, sm);
    else
      sym_mxu_pass<T, KO, kMass, true, false, false>(
          sm.p[0], sm.g[0], sm.vt[0], sm.p[1], sm.g[1], sm.vt[1], 0,
          softening, sm);
    sym_mxu_side<T, KO, true, false>(out, sm);
    sym_mxu_side<T, KO, false, true>(out + T * KO, sm);
  }
}

// pos_a / pos_b (c, K), g_a / g_b (c, 3), q_a / q_b (c, 16); part: 2 (T,
// KO) tiles per slot and system. Each CTA walks its slots
// (slot_body::walk_slots).
template <int T, int K, int KO>
__global__ void __launch_bounds__(
    sym_mxu_threads<T, KO>(),
    slot_body::stream_min_ctas(sym_mxu_threads<T, KO>(),
                               sym_mxu_warps<KO>()))
    vjp_mxu_kernel(const int* __restrict__ slots, int n_slots,
                   const float* __restrict__ pos_a,
                   const float* __restrict__ pos_b,
                   const float* __restrict__ g_a,
                   const float* __restrict__ g_b,
                   const float* __restrict__ q_a,
                   const float* __restrict__ q_b, float* part,
                   long long sys_rows, float softening, int mask_offdiag) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SymMxuSmem<T, KO> sm(smem);
  const long long sys = blockIdx.y;
  pos_a += sys * sys_rows * K;
  pos_b += sys * sys_rows * K;
  g_a += sys * sys_rows * 3;
  g_b += sys * sys_rows * 3;
  q_a += sys * sys_rows * 16;
  q_b += sys * sys_rows * 16;
  SymMxuBlock<T, K, sym_mxu_threads<T, KO>()> a, b;
  slot_body::walk_slots(
      slots, n_slots,
      [&](const slot_body::Slot& sl) {
        const size_t i = sl.bi, j = sl.bj;
        a.load(pos_a + i * T * K, g_a + i * T * 3, q_a + i * T * 16);
        b.load(pos_b + j * T * K, g_b + j * T * 3, q_b + j * T * 16);
      },
      [&] {
        a.store(reinterpret_cast<float*>(sm.p[0]),
                reinterpret_cast<float*>(sm.g[0]), sm.vt[0]);
        b.store(reinterpret_cast<float*>(sm.p[1]),
                reinterpret_cast<float*>(sm.g[1]), sm.vt[1]);
      },
      [&](const slot_body::Slot& sl, int s) {
        // Side 0's tile (block bi), then side 1's (block bj).
        float* out = part + (sys * n_slots + s) * 2 * T * KO;
        sym_mxu_compute<T, K, KO>(sl.kind, mask_offdiag, out, softening, sm);
      });
}

using SymMxuKernel = void (*)(const int*, int, const float*, const float*,
                              const float*, const float*, const float*,
                              const float*, float*, long long, float, int);

// B13's kernel for (tile, masses, ko), its threads per CTA and dynamic
// shared memory, or nullptr.
SymMxuKernel pick_sym_mxu(int tile, int masses, int ko, int* threads,
                          size_t* smem) {
#define NBODY_PICK_SYM_MXU(T)                                      \
  if (tile == T) {                                                 \
    *threads = ko == 9 ? sym_mxu_threads<T, 9>()                   \
                       : sym_mxu_threads<T, 8>();                  \
    *smem = ko == 9 ? sym_mxu_smem_bytes<T, 9>()                   \
                    : sym_mxu_smem_bytes<T, 8>();                  \
    if (!masses && ko == 8) return vjp_mxu_kernel<T, 3, 8>;        \
    if (masses && ko == 8) return vjp_mxu_kernel<T, 4, 8>;         \
    if (masses && ko == 9) return vjp_mxu_kernel<T, 4, 9>;         \
    return nullptr;                                                \
  }
  NBODY_PICK_SYM_MXU(64)
  NBODY_PICK_SYM_MXU(128)
#undef NBODY_PICK_SYM_MXU
  return nullptr;
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
  float dot_a, dot_b;
  pair_wc<kMass, kD2>(p, gp, q, gq, softening, true, w, cc, dot_a, dot_b);
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
  int threads = 0;
  size_t smem = 0;
  const SymMxuKernel kernel = pick_sym_mxu(tile, masses, ko, &threads, &smem);
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
      slots, n_slots, pos_a, pos_b, g_a, g_b, q_a, q_b, part, sys_rows,
      softening, mask_offdiag);
  return static_cast<int>(cudaGetLastError());
}

// out[4]: registers per thread, local bytes per thread, CTAs per SM and
// threads per CTA of B13's kernel for (tile, masses, ko), at its launch's
// shared memory.
extern "C" int vjp_mxu_info(int tile, int masses, int ko, int* out) {
  int threads = 0;
  size_t smem = 0;
  const SymMxuKernel kernel = pick_sym_mxu(tile, masses, ko, &threads, &smem);
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
