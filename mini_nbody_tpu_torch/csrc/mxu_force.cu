// B6: the ordered tensor-core hybrid force. Pair weights in fp32 on the CUDA
// cores, the weighted sums as products on the tensor cores:
//
//   F_i = sum_j w_ij (p_j - p_i) = S[:3] - p_i S[3],   S = W @ [p_j | 1],
//
// with d = p_j - p_i, d2 = |d|^2, inv = rsqrt(d2 + softening),
// w = (inv inv) inv, w = 0 where d2 == 0 (masked tiles only), w *= m_j.
//
// Replaces mini_nbody_tpu/ops/mxu_force.py:98 `_hybrid_kernel` (its pair
// math `_pair_sums`, :69; `body_force_mxu`, :259). Two precision classes, one
// kernel with a template flag:
//   bf16 (pair_dtype="bfloat16", JAX's Precision.DEFAULT): W is rounded to
//        bf16 in shared memory and multiplied with wmma m32n8k16 into the
//        (TJ, 8) compensated operand [vhi | vlo] of v = [p_j | 1]
//        (vhi = bf16(v), vlo = bf16(v - vhi)), fp32 accumulation; the
//        epilogue folds hi + lo. Without the lo half the epilogue's
//        cancellation (S[:3] and p_i S[3] large and nearly equal) turns the
//        bf16 rounding of v into per-body error tails.
//   fp32 (pair_dtype="float32", JAX's Precision.HIGHEST): fp32 FMAs over
//        the W tile on the CUDA cores, no tensor cores, summing w d (the
//        identity's right-hand side, F_i = sum_j w_ij d_ij) rather than
//        w [p_j | 1]. Chosen over 3xTF32 products: it is the fp32 class by
//        construction and costs 3 FMAs per pair against the ~12 operations
//        of w that both would pay. The identity form in sequential fp32
//        sums loses ~ulp(w |p|) per add, which the epilogue's cancellation
//        turns into errors above the fp32 class near close pairs (measured
//        on the card: beyond 1e-4 of the force scale at N = 3001, softening
//        1e-9); the d form has no cancellation.
//
// Design (B14's forward twin, csrc/vjp_mxu.cu): one CTA of 256 threads per
// 128 receivers, looping over 128-body j tiles staged in shared memory. bf16:
// all threads compute the 128 x 128 W tile (two columns per thread, one
// packed bf16x2 store), then warp (m, h) runs the wmma products of row tile
// m (32 rows) over half h of the tile's 8 k-steps into a fresh fragment,
// and adds that partial into its running sums (a fragment held in registers
// across every j tile) with round-to-nearest fp32 adds. The tensor cores'
// fp32 accumulation does not round to nearest: carried across the 8192 j
// tiles of N = 2^20, its bias reached a third of the force scale after the
// epilogue's cancellation (measured on the card); a partial per tile keeps
// each product chain to 64 columns, as K2's per-slot partials do. fp32:
// thread (r, h) sums half h of each tile's columns for receiver r in
// registers. The two halves are added in a fixed order in the epilogue.
// There is no reaction side and there are
// no atomics: each CTA writes its own rows, so B6 is deterministic, and a
// maskless run is bitwise the masked one wherever no d2 == 0 pair is
// dropped (w feeds the products unchanged).
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
//
// What bounds it on an H100: the fp32 pipeline of w, ~12 operations and one
// rsqrt per ordered pair (13 with a mass); the products are 32 x 8 x 16
// (N = 8) and keep the tensor cores mostly idle, and the W tile is written
// once and read once from shared memory. 48,640 bytes of shared memory per
// CTA in bf16 mode, 11,776 in fp32 mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr float kFar = 1.0e18f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TI = 128;      // receivers per CTA
constexpr int TJ = 128;      // sources per j tile
constexpr int LD = TJ + 8;   // bf16 row stride of the W tile
constexpr int kKSteps = TJ / 16;
static_assert(TI == TJ, "overlap_only assumes equal i and j tiles");
static_assert(TI / 32 * 2 == kWarps, "one warp per (row tile, k half)");
static_assert(2 * TI == kThreads, "two threads per receiver in fp32 mode");

using Frag = wmma::fragment<wmma::accumulator, 32, 8, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 32, 8, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 32, 8, 16, __nv_bfloat16,
                             wmma::row_major>;

// Byte offsets of the shared-memory buffers.
template <bool kBf16>
struct Layout {
  static constexpr size_t w = 0;                                 // TI x LD
  static constexpr size_t v = kBf16 ? TI * LD * 2 : 0;           // TJ x 8
  static constexpr size_t scratch = v + (kBf16 ? TJ * 8 * 2 : 0);
  static constexpr size_t pos = scratch + kWarps * 32 * 8 * 4;   // fp32
  static constexpr size_t bytes = pos + (3 * TI + 4 * TJ) * 4;
};

// fp32 w and d of one ordered pair, each operation rounded on its own in
// the plain version's order.
template <bool kMass>
__device__ __forceinline__ float weight(float xi, float yi, float zi,
                                        float xj, float yj, float zj,
                                        float mj, float softening, bool mask,
                                        float& dx, float& dy, float& dz) {
  dx = __fsub_rn(xj, xi);
  dy = __fsub_rn(yj, yi);
  dz = __fsub_rn(zj, zi);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float inv = rsqrtf(__fadd_rn(d2, softening));
  float w = __fmul_rn(__fmul_rn(inv, inv), inv);
  if (mask && d2 == 0.f) w = 0.f;
  return kMass ? __fmul_rn(w, mj) : w;
}

template <bool kBf16, bool kMass>
__global__ void __launch_bounds__(kThreads)
    mxu_force_kernel(const float* __restrict__ pos_i, int ni,
                     const float* __restrict__ pos_j,
                     const float* __restrict__ mass_j, int nj,
                     float* __restrict__ out, float* __restrict__ sums,
                     float softening, int overlap_only) {
  using L = Layout<kBf16>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem + L::w);
  __nv_bfloat16* V = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* scratch = reinterpret_cast<float*>(smem + L::scratch);
  float* Xi = reinterpret_cast<float*>(smem + L::pos);
  float* Yi = Xi + TI;
  float* Zi = Yi + TI;
  float* Xj = Zi + TI;
  float* Yj = Xj + TJ;
  float* Zj = Yj + TJ;
  float* Mj = Zj + TJ;

  const int it = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < TI) {
    const int row = it * TI + tid;
    const bool real = row < ni;
    Xi[tid] = real ? pos_i[static_cast<size_t>(row) * 3] : 0.f;
    Yi[tid] = real ? pos_i[static_cast<size_t>(row) * 3 + 1] : 0.f;
    Zi[tid] = real ? pos_i[static_cast<size_t>(row) * 3 + 2] : 0.f;
  }

  const int warp = tid / 32;
  const int m = warp % (TI / 32), kh = warp / (TI / 32);
  Frag acc, part;
  wmma::fill_fragment(acc, 0.f);
  const int r_own = tid % TI, half = tid / TI;  // fp32 mode
  float sx = 0.f, sy = 0.f, sz = 0.f;

  const int n_jt = (nj + TJ - 1) / TJ;
  for (int jt = 0; jt < n_jt; ++jt) {
    __syncthreads();  // the previous tile's products are done
    if (tid < TJ) {
      const int row = jt * TJ + tid;
      const bool real = row < nj;
      const size_t o = static_cast<size_t>(row) * 3;
      const float x = real ? pos_j[o] : kFar;
      const float y = real ? pos_j[o + 1] : kFar;
      const float z = real ? pos_j[o + 2] : kFar;
      Xj[tid] = x;
      Yj[tid] = y;
      Zj[tid] = z;
      Mj[tid] = real ? (kMass ? mass_j[row] : 1.f) : 0.f;
      if constexpr (kBf16) {
        const float v[4] = {x, y, z, 1.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat16 hi = __float2bfloat16_rn(v[q]);
          const __nv_bfloat16 lo =
              __float2bfloat16_rn(v[q] - __bfloat162float(hi));
          const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
          V[tid * 8 + q] = real ? hi : zero;
          V[tid * 8 + 4 + q] = real ? lo : zero;
        }
      }
    }
    __syncthreads();
    const bool mask = !overlap_only || jt == it;

    if constexpr (kBf16) {
      const float2* Xj2 = reinterpret_cast<const float2*>(Xj);
      const float2* Yj2 = reinterpret_cast<const float2*>(Yj);
      const float2* Zj2 = reinterpret_cast<const float2*>(Zj);
      const float2* Mj2 = reinterpret_cast<const float2*>(Mj);
      for (int e = tid; e < TI * TJ / 2; e += kThreads) {
        const int r = e / (TJ / 2), c2 = e % (TJ / 2);
        const float xi = Xi[r], yi = Yi[r], zi = Zi[r];
        const float2 x = Xj2[c2], y = Yj2[c2], z = Zj2[c2], mm = Mj2[c2];
        float dx, dy, dz;
        const float w0 = weight<kMass>(xi, yi, zi, x.x, y.x, z.x, mm.x,
                                       softening, mask, dx, dy, dz);
        const float w1 = weight<kMass>(xi, yi, zi, x.y, y.y, z.y, mm.y,
                                       softening, mask, dx, dy, dz);
        *reinterpret_cast<__nv_bfloat162*>(W + r * LD + 2 * c2) =
            __floats2bfloat162_rn(w0, w1);
      }
      __syncthreads();
      wmma::fill_fragment(part, 0.f);
#pragma unroll
      for (int kk = 0; kk < kKSteps / 2; ++kk) {
        const int k = kh * (kKSteps / 2) + kk;
        FragB b;
        wmma::load_matrix_sync(b, V + k * 16 * 8, 8);
        FragA a;
        wmma::load_matrix_sync(a, W + m * 32 * LD + k * 16, LD);
        wmma::mma_sync(part, a, b, part);
      }
#pragma unroll
      for (int q = 0; q < part.num_elements; ++q)
        acc.x[q] = __fadd_rn(acc.x[q], part.x[q]);
    } else {
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
  }

  // Epilogue: add the two halves in a fixed order; bf16: fold hi + lo and
  // F = S[:3] - p_i S[3]; fp32: F = S.
  constexpr int kCols = kBf16 ? 8 : 3;
  if constexpr (kBf16) {
    wmma::store_matrix_sync(scratch + warp * 32 * 8, acc, 8,
                            wmma::mem_row_major);
  } else {
    float* part = scratch + (half * TI + r_own) * 4;
    part[0] = sx;
    part[1] = sy;
    part[2] = sz;
  }
  __syncthreads();
  if (tid >= TI) return;
  const int row = it * TI + tid;
  if (row >= ni) return;
  float s[kCols];
  if constexpr (kBf16) {
    const float* a = scratch + (tid / 32) * 32 * 8 + (tid % 32) * 8;
    const float* b = a + (TI / 32) * 32 * 8;  // the other k half
#pragma unroll
    for (int q = 0; q < 8; ++q) s[q] = __fadd_rn(a[q], b[q]);
  } else {
    const float* a = scratch + tid * 4;
    const float* b = a + TI * 4;
#pragma unroll
    for (int q = 0; q < 3; ++q) s[q] = __fadd_rn(a[q], b[q]);
  }
  if (sums != nullptr) {
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      sums[static_cast<size_t>(row) * kCols + q] = s[q];
  }
  float* o = out + static_cast<size_t>(row) * 3;
  if constexpr (kBf16) {
    float f[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = __fadd_rn(s[q], s[q + 4]);
    o[0] = __fsub_rn(f[0], __fmul_rn(Xi[tid], f[3]));
    o[1] = __fsub_rn(f[1], __fmul_rn(Yi[tid], f[3]));
    o[2] = __fsub_rn(f[2], __fmul_rn(Zi[tid], f[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 3; ++q) o[q] = s[q];
  }
}

template <bool kBf16, bool kMass>
int launch(const float* pos_i, int ni, const float* pos_j,
           const float* mass_j, int nj, float* out, float* sums,
           float softening, int overlap_only, cudaStream_t stream) {
  constexpr size_t smem = Layout<kBf16>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_force_kernel<kBf16, kMass>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (ni + TI - 1) / TI;
  mxu_force_kernel<kBf16, kMass><<<grid, kThreads, smem, stream>>>(
      pos_i, ni, pos_j, mass_j, nj, out, sums, softening, overlap_only);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mass = mass_j != nullptr;
  if (bf16 && mass)
    return launch<true, true>(pos_i, ni, pos_j, mass_j, nj, out, sums,
                              softening, overlap_only, s);
  if (bf16)
    return launch<true, false>(pos_i, ni, pos_j, mass_j, nj, out, sums,
                               softening, overlap_only, s);
  if (mass)
    return launch<false, true>(pos_i, ni, pos_j, mass_j, nj, out, sums,
                               softening, overlap_only, s);
  return launch<false, false>(pos_i, ni, pos_j, mass_j, nj, out, sums,
                              softening, overlap_only, s);
}
