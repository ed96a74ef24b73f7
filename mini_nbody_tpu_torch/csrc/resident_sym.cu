// B15: a whole trajectory in one launch: `steps` Euler steps (or Yoshida-4
// substeps) of pair-once forces and in-place integration, with the state
// kept on the card between steps, for one system or B independent systems.
//
// Replaces mini_nbody_tpu/ops/resident_sym.py:441 `_kernel` (its
// pallas_calls at :634 `simulate_resident_sym` and :772
// `simulate_resident_sym_ensemble`): forces in the fp32 class
// (`_force_block`, `_force_fold_block` with mxu=False) or the bf16 class
// (mxu=True, the compensated [hi | lo] operand of `_mxu_operand`), then the
// identity-form integrate of `_integrate_block`.
//
// The TPU kernel walks a lexicographic grid (steps, force bands, integrate
// slots) over an (8 nb, T) sublane-major state in VMEM with whole-buffer
// accumulators; none of that carries over. Here one cooperative launch
// (cudaLaunchCooperativeKernel, as many CTAs as can be co-resident) walks,
// for every step:
//   force   for each piece of the tri slot list (ops/slot_pipe.py
//           tri_slot_list, fold or not) and each system, the CTAs take the
//           slots in turn and run the streamed kernels' own slot bodies
//           (csrc/slot_body.cuh: K3's fp32_slot, K2's mxu_slot), which
//           store two partial tiles per slot;
//   reduce  after a grid barrier, one thread per element of each target
//           block's tile adds that block's partials in slot order (the
//           plan of ops/slot_pipe.plan_pieces; slot_body::ordered_sum, the
//           loop of csrc/slot_reduce.cu) and adds the sum into the
//           accumulator; a grid barrier;
//   integrate  one thread per body forms the force from the accumulator
//           (fp32: the sums; bf16: s[:3] - p s[3] after folding the
//           [hi | lo] columns), zeroes the accumulator row, kicks and
//           drifts in place (Euler: v += dt F, x += dt v; leapfrog and
//           Yoshida-4: the (kick_a, kick_b, drift) triple picked by
//           (step + y4_phase) mod 3, the two half-kicks unmerged as the
//           streamed loop adds them) and, in the bf16 class,
//           rebuilds the body's operand [m p | m] split into bf16 hi and
//           its fp32 remainder; a grid barrier.
// The pieces (ops/slot_pipe.PIECE_SLOTS slots) bound the partials' scratch:
// at the cap, N = 131,072 and T = 128, the tri list has 524,800 slots, whose
// K2-width partials would take 4.3 GB per step; a piece takes 537 MB (201
// MB in the fp32 class). The state (32 B per body, 4 MB at the cap), the
// accumulators and the operands stay in device memory, where the 50 MB L2
// holds them at small N. No atomics: every sum is in a fixed order, so each
// run is bitwise the last, and a system of an ensemble (its own rows, the
// same slot list, the same pieces) is bitwise its standalone run.
//
// Pads (C4): every pad body's pairs get w = 0 (slot_body's kPads), on top
// of the self diagonal and, unless coincident is 'fast', every d2 == 0
// pair. A pad never gains a force, so it stays at FAR with zero velocity;
// in the reference a 'fast' fold gave FAR-vs-FAR pad pairs softening^-1.5
// weights that were integrated every step.
//
// What bounds it on an H100: at the cap, the forces' fp32 pipeline, as K3
// and K2 (per unordered pair and step, 19 fp32 operations in the fp32
// class, JAX's count, resident_sym.py:656; K2's 12 fp32 and 32 tensor-core
// operations in the bf16 class); at small N, the three grid barriers per step and
// piece and the few slots per CTA. Every arithmetic step of the integrate
// and the operand is written with round-to-nearest intrinsics in the plain
// version's order (no FMA contraction), as ops/integrators.py computes it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace cg = cooperative_groups;

namespace {

struct Args {
  const int* slots;    // (S, 3) tri slot list (kind, bi, bj)
  const int* pieces;   // (P, 4): first slot, slots, first target, end target
  const int* targets;  // (targets, 3): block, first entry, end entry
  const int* entries;  // a target's tiles in slot order (local slot * 2 +
                       // side, within its piece)
  float* pos;          // (B np, KP): x, y, z[, m] (fp32 class), x, y, z (bf16)
  float* vel;          // (B np, 3)
  const float* mass;   // (B np) or null: the bf16 class's masses
  float* q;            // (B np, 8): the bf16 class's operands
  float* acc;          // (B np, W), zero on entry, zero on exit
  float* part;         // B x (largest piece) x 2 tiles of (T, W)
  long long np;        // padded rows per system
  int n_sys, n_real, n_pieces, steps, y4, y4_phase, mask_offdiag, fast;
  float dt, softening;
  float y4c[9];        // (kick_a, kick_b, drift) for r = 0, 1, 2
};

// v = [m p | m] split into bf16(v) and v - bf16(v) (K2's _pack).
__device__ __forceinline__ void build_operand(const Args& a, long long i) {
  const float m = a.mass != nullptr ? a.mass[i] : 1.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = k < 3 ? __fmul_rn(a.pos[i * 3 + k], m) : m;
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    a.q[i * 8 + k] = hi;
    a.q[i * 8 + 4 + k] = __fsub_rn(v, hi);
  }
}

template <bool kMxu, int KP, int W>
__device__ __forceinline__ void integrate(const Args& a, long long i,
                                          int step) {
  float* p = a.pos + i * KP;
  float* v = a.vel + i * 3;
  float* s = a.acc + i * W;
  float f[3];
  if (kMxu) {
    const float s3 = __fadd_rn(s[3], s[7]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      f[k] = __fsub_rn(__fadd_rn(s[k], s[k + 4]), __fmul_rn(p[k], s3));
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k] = s[k];
  }
#pragma unroll
  for (int k = 0; k < W; ++k) s[k] = 0.f;
  float ka = a.dt, kb = 0.f, h = a.dt;
  if (a.y4) {
    const int r = (step + a.y4_phase) % 3;
    ka = a.y4c[3 * r];
    kb = a.y4c[3 * r + 1];
    h = a.y4c[3 * r + 2];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float vn = __fadd_rn(v[k], __fmul_rn(ka, f[k]));
    if (a.y4) vn = __fadd_rn(vn, __fmul_rn(kb, f[k]));
    v[k] = vn;
    p[k] = __fadd_rn(p[k], __fmul_rn(h, vn));
  }
  if (kMxu) build_operand(a, i);
}

template <int T, bool kMxu, int K, bool kFast>
__global__ void __launch_bounds__(kMxu ? slot_body::mxu_threads<T>()
                                       : slot_body::fp32_threads<T>())
    resident_kernel(Args a) {
  constexpr int W = kMxu ? 8 : 3;   // partial and accumulator width
  constexpr int KP = kMxu ? 3 : K;  // position row width
  constexpr int kTileElems = T * W;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long rows = a.np * a.n_sys;

  if (kMxu) {
    for (long long i = tid; i < rows; i += stride) build_operand(a, i);
    grid.sync();
  }
  for (int step = 0; step < a.steps; ++step) {
    for (int pc = 0; pc < a.n_pieces; ++pc) {
      const int s0 = a.pieces[4 * pc], n = a.pieces[4 * pc + 1];
      const int t0 = a.pieces[4 * pc + 2], nt = a.pieces[4 * pc + 3] - t0;
      // Force: unit u is slot s0 + u % n of system u / n.
      const long long units = static_cast<long long>(a.n_sys) * n;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const long long sys = u / n;
        const int s = s0 + static_cast<int>(u - sys * n);
        __syncthreads();  // the previous slot is done with shared memory
        const int kind = a.slots[3 * s];
        const int bi = a.slots[3 * s + 1];
        const int bj = a.slots[3 * s + 2];
        float* out = a.part + u * 2 * kTileElems;
        const float* pos = a.pos + sys * a.np * KP;
        if (kMxu) {
          const float* q = a.q + sys * a.np * 8;
          slot_body::mxu_slot<T, false, true>(
              kind, bi, bj, pos, pos, q, q, out, a.softening, a.fast,
              a.mask_offdiag, a.n_real, smem);
        } else {
          slot_body::fp32_slot<T, K, kFast, true>(
              kind, bi, bj, pos, pos, out, a.softening, a.n_real,
              reinterpret_cast<float*>(smem));
        }
      }
      grid.sync();
      // Reduce: each target block's partials in slot order.
      const long long work = static_cast<long long>(a.n_sys) * nt *
                             kTileElems;
      for (long long u = tid; u < work; u += stride) {
        const int elem = static_cast<int>(u % kTileElems);
        const long long tt = u / kTileElems;
        const long long sys = tt / nt;
        const int t = t0 + static_cast<int>(tt - sys * nt);
        const float* base = a.part + sys * n * 2 * kTileElems + elem;
        a.acc[sys * a.np * W +
              static_cast<long long>(a.targets[3 * t]) * kTileElems + elem] +=
            slot_body::ordered_sum(base, a.entries, a.targets[3 * t + 1],
                                   a.targets[3 * t + 2], kTileElems);
      }
      grid.sync();
    }
    for (long long i = tid; i < rows; i += stride)
      integrate<kMxu, KP, W>(a, i, step);
    grid.sync();
  }
}

template <int T, bool kMxu, int K, bool kFast>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = resident_kernel<T, kMxu, K, kFast>;
  constexpr int threads = kMxu ? slot_body::mxu_threads<T>()
                               : slot_body::fp32_threads<T>();
  constexpr size_t smem = kMxu ? slot_body::mxu_smem_bytes<T>()
                               : slot_body::fp32_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(per_sm * sms), dim3(threads), params,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int dispatch(const Args& a, int mxu, int k, cudaStream_t s) {
  if (mxu) return launch<T, true, 3, false>(a, s);
  if (k == 3 && a.fast) return launch<T, false, 3, true>(a, s);
  if (k == 3) return launch<T, false, 3, false>(a, s);
  if (k == 4 && a.fast) return launch<T, false, 4, true>(a, s);
  if (k == 4) return launch<T, false, 4, false>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// slots (S, 3) int32 tri slot list; pieces (n_pieces, 4), targets (., 3) and
// entries int32, the reduction plan (ops/resident_sym.resident_plan); pos
// (n_sys np, k) fp32 packed (x, y, z[, m]) in the fp32 class (k = 3 or 4),
// (n_sys np, 3) in the bf16 class (mxu = 1, k = 3), with mass (n_sys np) or
// NULL and q (n_sys np, 8) scratch; vel (n_sys np, 3); acc (n_sys np, 3|8)
// zeroed; part n_sys x (largest piece) x 2 tiles of (tile, 3|8); np a
// multiple of tile; n_real real bodies per system (the rest are pads).
// y4c: 9 host floats (a (kick_a, kick_b, drift) triple for each step mod
// 3: Yoshida-4's cycle, or leapfrog's (dt / 2, dt / 2, dt) thrice), or NULL
// for Euler steps. tile: 64 or 128. All device
// tensors fp32 (but the plan) and contiguous on the current device.
// Returns cudaGetLastError() after the
// launch, or the launch's error (a cooperative launch that does not fit is
// refused, never shrunk).
extern "C" int resident_sym_launch(
    const int* slots, const int* pieces, int n_pieces, const int* targets,
    const int* entries, float* pos, float* vel, const float* mass, float* q,
    float* acc, float* part, int n_sys, long long np, int n_real, int steps,
    float dt, float softening, int fast, int mask_offdiag, const float* y4c,
    int y4_phase, int tile, int mxu, int k, void* stream) {
  if (steps < 1 || n_sys < 1 || n_pieces < 1 || np % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{slots, pieces, targets, entries, pos, vel, mass, q, acc, part,
         np, n_sys, n_real, n_pieces, steps, y4c != nullptr, y4_phase,
         mask_offdiag, fast, dt, softening, {}};
  if (y4c != nullptr)
    for (int i = 0; i < 9; ++i) a.y4c[i] = y4c[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64) return dispatch<64>(a, mxu, k, s);
  if (tile == 128) return dispatch<128>(a, mxu, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
