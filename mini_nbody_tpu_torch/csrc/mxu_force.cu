// B6: the ordered tensor-core hybrid force. Pair weights in fp32 on the CUDA
// cores, the weighted sums as products on the tensor cores:
//
//   F_i = sum_j w_ij (p_j - p_i) = S[:3] - p_i S[3],   S = W @ [p_j | 1],
//
// with d = p_j - p_i, d2 = |d|^2, inv = rsqrt(d2 + softening),
// w = (inv inv) inv, w = 0 where d2 == 0 (masked tiles only), w *= m_j.
//
// Replaces mini_nbody_tpu/ops/mxu_force.py:98 `_hybrid_kernel` (its pair
// math `_pair_sums`, :69; `body_force_mxu`, :259). Two precision classes,
// one kernel each:
//   bf16 (pair_dtype="bfloat16", JAX's Precision.DEFAULT): W in bf16 times
//        the (TJ, 8) compensated operand [vhi | vlo] of v = [p_j | 1]
//        (vhi = bf16(v), vlo = bf16(v - vhi)) on the tensor cores, fp32
//        accumulation; the epilogue folds hi + lo. Without the lo half the
//        epilogue's cancellation (S[:3] and p_i S[3] large and nearly equal)
//        turns the bf16 rounding of v into per-body error tails.
//   fp32 (pair_dtype="float32", JAX's Precision.HIGHEST): fp32 FMAs on the
//        CUDA cores, no tensor cores, summing w d (the identity's right-hand
//        side, F_i = sum_j w_ij d_ij) rather than w [p_j | 1]. Chosen over
//        3xTF32 products: it is the fp32 class by construction and costs 3
//        FMAs per pair against the ~12 operations of w that both would pay.
//        The identity form in sequential fp32 sums loses ~ulp(w |p|) per
//        add, which the epilogue's cancellation turns into errors above the
//        fp32 class near close pairs (measured on the card: beyond 1e-4 of
//        the force scale at N = 3001, softening 1e-9); the d form has none.
//
// What bounds it on an H100: the fp32 pipeline of w, ~12 operations and one
// rsqrt per ordered pair (13 with a mass); the products are 16 x 8 x 16
// (N = 8) and keep the tensor cores mostly idle.
//
// bf16 design (K2's row half, csrc/slot_body.cuh `mxu_steps`, without the
// reaction product): one CTA of 128 threads per 128 receivers, warp m
// owning receivers [32 m, 32 m + 32) as two 16-row strips, each lane its
// rows g and g + 8 of each strip in registers. Per 128-body j tile, staged
// once in shared memory (positions with mass as float4, v^T in bf16 in the
// B fragment's layout; two buffers, the next tile's bodies loaded into
// registers while the current one computes, one barrier per tile), each
// lane computes for each 16-column step and strip the 8 weights of its
// mma.sync m16n8k16 A fragment in fp32, packs them to bf16 pairs and runs
// the row product at once: no w touches shared memory. The tile's product
// starts from a fresh fragment and is added into fp32 register sums with
// round-to-nearest adds: the tensor cores' fp32 accumulation does not
// round to nearest, and carried across the 8192 j tiles of N = 2^20 its
// bias reached a third of the force scale after the epilogue's
// cancellation (measured on the card); a fragment per tile keeps each
// product chain to 128 columns. The sums meet in shared memory once, for
// the epilogue. Compiled for 20 warps per SM (5 CTAs, at most 96
// registers; 16 warps at 120 registers ran 1.2% slower per 2^20 pass on an
// H100). fp32 design: 256 threads per 128 receivers; thread (r, h) sums
// half h of each tile's columns for receiver r in registers, and the
// epilogue adds the two halves in a fixed order. There is no reaction side
// and there are no atomics: each CTA writes its own rows, so B6 is
// deterministic, and a maskless run is bitwise the masked one wherever no
// d2 == 0 pair is dropped (w feeds the products unchanged).
//
// overlap_only (square calls under coincident routing, mxu_force.py:110-115)
// masks d2 == 0 only in the j tile whose range is the CTA's own (the tiles
// are equal, so the ranges meet only there): that tile holds every self
// pair, and the caller's duplicate scan has ruled out the rest.
//
// Pads: receivers past ni are computed against 0 and never written; sources
// past nj are staged at FAR with zero mass and a zero operand. Against FAR,
// r2 ~ 3e36 and inv^3 underflows to exactly 0 (the cube is inv inv inv, not
// rsqrt(r2^3)), so pads add exact zeros, as JAX's FAR padding does.
//
// Numerics against the plain version: w is computed with round-to-nearest
// intrinsics in the plain version's order (no FMA contraction), so both
// round the same fp32 w to the same bf16; what remains is the order of the
// fp32 sums. The epilogue, too, rounds each step as the plain version does.
// The bf16 class takes rsqrt.approx.ftz, without rsqrtf's rescaling of a
// denormal input (fewer registers and instructions): a denormal r2, which
// only a softening below 2^-126 lets through, gives w = inf either way
// (inv > 2^63, so inv^3 overflows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace {

constexpr float kFar = 1.0e18f;
constexpr int TI = 128;      // receivers per CTA
constexpr int TJ = 128;      // sources per j tile
static_assert(TI == TJ, "overlap_only assumes equal i and j tiles");

// fp32 w and d of one ordered pair, each operation rounded on its own in
// the plain version's order. kFtz: rsqrt.approx.ftz (the bf16 class).
template <bool kMass, bool kFtz = false>
__device__ __forceinline__ float weight(float xi, float yi, float zi,
                                        float xj, float yj, float zj,
                                        float mj, float softening, bool mask,
                                        float& dx, float& dy, float& dz) {
  dx = __fsub_rn(xj, xi);
  dy = __fsub_rn(yj, yi);
  dz = __fsub_rn(zj, zi);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float r2 = __fadd_rn(d2, softening);
  const float inv = kFtz ? slot_body::rsqrt_normal(r2) : rsqrtf(r2);
  float w = __fmul_rn(__fmul_rn(inv, inv), inv);
  if (mask && d2 == 0.f) w = 0.f;
  return kMass ? __fmul_rn(w, mj) : w;
}

// ---------------------------------------------------------- bf16 class ---

constexpr int kH = slot_body::kMxuStrips;
constexpr int kBf16Threads = slot_body::mxu_threads<TI>();  // 4 warps
constexpr int LDV = TJ + 8;  // bf16 row stride of v^T
static_assert(kBf16Threads == TJ, "one staged source per thread");

// One staged j tile: positions and mass, and v^T = [vhi | vlo]^T in bf16.
struct JTile {
  float4 q[TJ];
  __nv_bfloat16 vt[8 * LDV];
};

// One j tile's row products into acc, a fresh fragment: the lane's 2
// strips x 8 weights per 16-column step, kD2 masking d2 == 0.
template <bool kMass, bool kD2>
__device__ __forceinline__ void b6_tile(const slot_body::MxuRows& rw,
                                        const JTile& jt, float softening,
                                        float (&acc)[kH][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  auto w = [softening](const float4& p, const float4& q, int, int) {
    float dx, dy, dz;
    return weight<kMass, true>(p.x, p.y, p.z, q.x, q.y, q.z, q.w, softening,
                               kD2, dx, dy, dz);
  };
#pragma unroll
  for (int h = 0; h < kH; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
  slot_body::mxu_steps<TJ, false, false>(
      rw, jt.q, reinterpret_cast<const uint32_t*>(jt.vt + g * LDV), acc,
      nullptr, w);
}

// Receiver row's position, 0 past ni.
__device__ __forceinline__ float4 receiver(const float* __restrict__ pos_i,
                                           int row, int ni) {
  if (row >= ni) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = pos_i + static_cast<size_t>(row) * 3;
  return make_float4(p[0], p[1], p[2], 0.f);
}

template <bool kMass>
__global__ void __launch_bounds__(
    kBf16Threads, slot_body::stream_min_ctas(kBf16Threads, 20))
    mxu_bf16_kernel(const float* __restrict__ pos_i, int ni,
                    const float* __restrict__ pos_j,
                    const float* __restrict__ mass_j, int nj,
                    float* __restrict__ out, float* __restrict__ sums,
                    float softening, int overlap_only) {
  __shared__ JTile tiles[2];
  __shared__ __align__(16) float S[TI * 8];
  const int it = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // The lane's receivers (0 past ni) and their running sums.
  slot_body::MxuRows rw;
  float s[kH][4];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    rw.r0[h] = 16 * (kH * warp + h) + g;
    rw.p0[h] = receiver(pos_i, it * TI + rw.r0[h], ni);
    rw.p1[h] = receiver(pos_i, it * TI + rw.r0[h] + 8, ni);
    rw.bp0[h] = rw.bp1[h] = 0u;
    s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
  }

  // Source jt * TJ + tid in registers: loaded one tile ahead, then staged.
  float x, y, z, m;
  bool real;
  auto load = [&](int jt) {
    const int row = jt * TJ + tid;
    real = row < nj;
    const size_t o = static_cast<size_t>(row) * 3;
    x = real ? pos_j[o] : kFar;
    y = real ? pos_j[o + 1] : kFar;
    z = real ? pos_j[o + 2] : kFar;
    m = real ? (kMass ? mass_j[row] : 1.f) : 0.f;
  };
  auto stage = [&](JTile& b) {
    b.q[tid] = make_float4(x, y, z, m);
    const float v[4] = {x, y, z, 1.f};
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[q]);
      const __nv_bfloat16 lo =
          __float2bfloat16_rn(v[q] - __bfloat162float(hi));
      b.vt[q * LDV + tid] = real ? hi : zero;
      b.vt[(4 + q) * LDV + tid] = real ? lo : zero;
    }
  };

  const int n_jt = (nj + TJ - 1) / TJ;
  load(0);
  for (int jt = 0; jt < n_jt; ++jt) {
    // Buffer jt & 1 was last read two tiles ago, before the last barrier.
    JTile& b = tiles[jt & 1];
    stage(b);
    __syncthreads();
    if (jt + 1 < n_jt) load(jt + 1);
    float acc[kH][4];
    if (!overlap_only || jt == it)
      b6_tile<kMass, true>(rw, b, softening, acc);
    else
      b6_tile<kMass, false>(rw, b, softening, acc);
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[h][q] = __fadd_rn(s[h][q], acc[h][q]);
  }

  // Epilogue, one thread per receiver: fold hi + lo and F = S[:3] - p_i
  // S[3]. C fragments: (row r0, columns 2t, 2t + 1), (row r0 + 8, the same).
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    *reinterpret_cast<float2*>(S + rw.r0[h] * 8 + 2 * t) =
        make_float2(s[h][0], s[h][1]);
    *reinterpret_cast<float2*>(S + (rw.r0[h] + 8) * 8 + 2 * t) =
        make_float2(s[h][2], s[h][3]);
  }
  __syncthreads();
  const int row = it * TI + tid;
  if (row >= ni) return;
  float sv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sv[q] = S[tid * 8 + q];
  if (sums != nullptr) {
#pragma unroll
    for (int q = 0; q < 8; ++q) sums[static_cast<size_t>(row) * 8 + q] = sv[q];
  }
  float f[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) f[q] = __fadd_rn(sv[q], sv[q + 4]);
  const float* pi = pos_i + static_cast<size_t>(row) * 3;
  float* o = out + static_cast<size_t>(row) * 3;
  o[0] = __fsub_rn(f[0], __fmul_rn(pi[0], f[3]));
  o[1] = __fsub_rn(f[1], __fmul_rn(pi[1], f[3]));
  o[2] = __fsub_rn(f[2], __fmul_rn(pi[2], f[3]));
}

// ---------------------------------------------------------- fp32 class ---

constexpr int kFp32Threads = 2 * TI;  // two threads per receiver

template <bool kMass>
__global__ void __launch_bounds__(kFp32Threads)
    mxu_fp32_kernel(const float* __restrict__ pos_i, int ni,
                    const float* __restrict__ pos_j,
                    const float* __restrict__ mass_j, int nj,
                    float* __restrict__ out, float* __restrict__ sums,
                    float softening, int overlap_only) {
  __shared__ float scratch[2 * TI * 4];
  __shared__ float Xi[TI], Yi[TI], Zi[TI];
  __shared__ float Xj[TJ], Yj[TJ], Zj[TJ], Mj[TJ];

  const int it = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < TI) {
    const int row = it * TI + tid;
    const bool real = row < ni;
    Xi[tid] = real ? pos_i[static_cast<size_t>(row) * 3] : 0.f;
    Yi[tid] = real ? pos_i[static_cast<size_t>(row) * 3 + 1] : 0.f;
    Zi[tid] = real ? pos_i[static_cast<size_t>(row) * 3 + 2] : 0.f;
  }

  const int r_own = tid % TI, half = tid / TI;
  float sx = 0.f, sy = 0.f, sz = 0.f;

  const int n_jt = (nj + TJ - 1) / TJ;
  for (int jt = 0; jt < n_jt; ++jt) {
    __syncthreads();  // the previous tile's sums are done
    if (tid < TJ) {
      const int row = jt * TJ + tid;
      const bool real = row < nj;
      const size_t o = static_cast<size_t>(row) * 3;
      Xj[tid] = real ? pos_j[o] : kFar;
      Yj[tid] = real ? pos_j[o + 1] : kFar;
      Zj[tid] = real ? pos_j[o + 2] : kFar;
      Mj[tid] = real ? (kMass ? mass_j[row] : 1.f) : 0.f;
    }
    __syncthreads();
    const bool mask = !overlap_only || jt == it;
    const float xi = Xi[r_own], yi = Yi[r_own], zi = Zi[r_own];
    const int c0 = half * (TJ / 2);
#pragma unroll 4
    for (int c = c0; c < c0 + TJ / 2; ++c) {
      float dx, dy, dz;
      const float w = weight<kMass>(xi, yi, zi, Xj[c], Yj[c], Zj[c], Mj[c],
                                    softening, mask, dx, dy, dz);
      sx += w * dx;
      sy += w * dy;
      sz += w * dz;
    }
  }

  // Epilogue: add the two halves in a fixed order; F = S.
  float* part = scratch + (half * TI + r_own) * 4;
  part[0] = sx;
  part[1] = sy;
  part[2] = sz;
  __syncthreads();
  if (tid >= TI) return;
  const int row = it * TI + tid;
  if (row >= ni) return;
  const float* a = scratch + tid * 4;
  const float* b = a + TI * 4;
  float f[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) f[q] = __fadd_rn(a[q], b[q]);
  float* o = out + static_cast<size_t>(row) * 3;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (sums != nullptr) sums[static_cast<size_t>(row) * 3 + q] = f[q];
    o[q] = f[q];
  }
}

// ---------------------------------------------------------- launches ---

using Kernel = void (*)(const float*, int, const float*, const float*, int,
                        float*, float*, float, int);

// The kernel for (bf16, masses), and its threads per CTA.
Kernel pick(bool bf16, bool mass, int* threads) {
  *threads = bf16 ? kBf16Threads : kFp32Threads;
  if (bf16) return mass ? mxu_bf16_kernel<true> : mxu_bf16_kernel<false>;
  return mass ? mxu_fp32_kernel<true> : mxu_fp32_kernel<false>;
}

}  // namespace

// pos_i (ni, 3), pos_j (nj, 3), mass_j (nj,) or NULL (unit masses); out
// (ni, 3) forces; sums (ni, 8) raw [hi | lo] sums in bf16 mode, (ni, 3)
// (sum w d, the forces) in fp32 mode, or NULL; fp32, contiguous, on the
// current device. bf16: 1 for pair_dtype="bfloat16", 0 for "float32".
// overlap_only: mask d2 == 0 only in
// the j tile that is the CTA's own receiver range (square calls). Returns
// cudaGetLastError() after the launch.
extern "C" int mxu_force_launch(const float* pos_i, int ni, const float* pos_j,
                                const float* mass_j, int nj, float* out,
                                float* sums, float softening,
                                int overlap_only, int bf16, void* stream) {
  if (ni == 0) return 0;
  int threads = 0;
  const Kernel kernel = pick(bf16, mass_j != nullptr, &threads);
  kernel<<<(ni + TI - 1) / TI, threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      pos_i, ni, pos_j, mass_j, nj, out, sums, softening, overlap_only);
  return static_cast<int>(cudaGetLastError());
}

// out[3]: registers per thread, local bytes per thread and CTAs per SM of
// the kernel mxu_force_launch runs for (bf16, masses).
extern "C" int mxu_force_info(int bf16, int masses, int* out) {
  int threads = 0;
  const Kernel kernel = pick(bf16, masses, &threads);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
