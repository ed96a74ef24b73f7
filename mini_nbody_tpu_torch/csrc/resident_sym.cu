// B15: a whole trajectory in one launch: `steps` Euler steps (or leapfrog
// and Yoshida-4 substeps, with their opening and closing passes) of
// pair-once forces and in-place integration, with the state kept on the
// card between passes, for one system or B independent systems.
//
// Replaces mini_nbody_tpu/ops/resident_sym.py:441 `_kernel` (its
// pallas_calls at :634 `simulate_resident_sym` and :772
// `simulate_resident_sym_ensemble`, and the leapfrog and Yoshida-4 drivers
// around them, :868-898 and :930-994, whose end passes ran outside the
// kernel): forces in the fp32 class (`_force_block`, `_force_fold_block`
// with mxu=False) or the bf16 class (mxu=True, the compensated [hi | lo]
// operand of `_mxu_operand`), then the identity-form integrate of
// `_integrate_block`.
//
// The TPU kernel walks a lexicographic grid (steps, force bands, integrate
// slots) over an (8 nb, T) sublane-major state in VMEM with whole-buffer
// accumulators; none of that carries over. Here one cooperative launch
// (cudaLaunchCooperativeKernel) first copies the caller's bodies into its
// padded state (FAR positions, zero velocities and masses for the pads;
// in the bf16 class each body's operand [m p | m] split into bf16 hi and
// its fp32 remainder), then, for every force pass:
//   force   for each piece of the tri slot list (ops/slot_pipe.py
//           tri_slot_list, fold or not) and each system, the CTAs walk the
//           slots as the streamed kernels do (walk_units: the next
//           slot's blocks load into registers while one computes) and run
//           their slot bodies (csrc/slot_body.cuh: K3's fp32 body, K2's
//           bf16 body), which store two partial tiles per slot; a grid
//           barrier;
//   reduce  (every piece but the last) one thread per element of each
//           target block's tile adds that block's partials in slot order
//           (the plan of ops/slot_pipe.plan_pieces; slot_body::ordered_sum,
//           the loop of csrc/slot_reduce.cu) into the accumulator; a grid
//           barrier;
//   integrate  one thread per body adds its row of the last piece's
//           partials in slot order (slot_body::ordered_row_sum, bitwise
//           ordered_sum per column) to the accumulator value (0 when the
//           step is one piece, as the streamed reduce adds into zeros; a
//           body whose block is no target of the last piece keeps the
//           accumulator as it stands), forms the force (fp32: the sums;
//           bf16: s[:3] - p s[3] after folding the [hi | lo] columns), and
//           kicks and drifts in place: Euler v += dt F, x += dt v; a
//           leapfrog or Yoshida-4 substep the (kick_a, kick_b, drift)
//           triple picked by (step + y4_phase) mod 3, the two half-kicks
//           unmerged as the streamed loop adds them; the opening pass v +=
//           h/2 F, x += h v; the closing pass v += h/2 F and no drift (a
//           flag, not a zero coefficient: v + 0 F turns a -0 velocity into
//           +0). In the bf16 class it rebuilds the body's operand; the last
//           pass writes the real bodies to the caller's outputs; a grid
//           barrier before the next pass.
// So a step of one piece costs two grid barriers, and the reduce's round
// trip through the accumulator is gone. The pieces (ops/slot_pipe.
// PIECE_SLOTS slots) bound the partials' scratch: at the cap, N = 131,072
// and T = 128, the tri list has 524,800 slots, whose K2-width partials
// would take 4.3 GB per pass; a piece takes 537 MB (201 MB in the fp32
// class). Up to N ~ 46,000 at T = 128 the list is one piece. No atomics:
// every sum is in a fixed order, so each run is bitwise the last, a run is
// bitwise the streamed loop at the same tile and slot list, and a system
// of an ensemble (its own rows, the same slot list, the same pieces) is
// bitwise its standalone run.
//
// Pads (C4): every pair that touches a pad gets w = 0, on top of the self
// diagonal and, unless coincident is 'fast', every d2 == 0 pair: each pad
// of a block sits at its own far point (load_body), so the pair's r2
// overflows and its weight is 0 exactly, as a real body's against a FAR
// pad in the streamed kernels, with no mask in the slot bodies (their
// registers stay the streamed kernels'). A pad never gains a force, and is
// not integrated: it stays put with zero velocity. In the reference a
// 'fast' fold gave FAR-vs-FAR pad pairs softening^-1.5 weights that were
// integrated every step.
//
// What bounds it on an H100: at large N, the forces' fp32 pipeline, as K3
// and K2 (per unordered pair and pass, 19 fp32 operations in the fp32
// class, JAX's count, resident_sym.py:656; K2's 12 fp32 and 32 tensor-core
// operations in the bf16 class). The force phase is compiled for the warps
// an SM of the streamed kernel whose body it runs (K3 16: two CTAs of 256
// threads at T = 128; K2 12), so it runs as many CTAs an SM (res_min_ctas
// for the exceptions). At small N, the latency of one slot and of the two
// grid barriers a pass: the grid is the co-resident CTAs, cut to the work
// (the slots of a piece, or one thread per body), so a small run's
// barriers wait on few CTAs. The occupancy query runs once per
// instantiation and device. Every arithmetic
// step of the integrate and the operand is written with round-to-nearest
// intrinsics in the plain version's order (no FMA contraction), as
// ops/integrators.py computes it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "slot_body.cuh"

namespace cg = cooperative_groups;

namespace {

struct Args {
  const int* slots;        // (S, 3) tri slot list (kind, bi, bj)
  const int* pieces;       // (P, 4): first slot, slots, first target, end
  const int* targets;      // (targets, 3): block, first entry, end entry
  const int* entries;      // a target's tiles in slot order (local slot * 2
                           // + side, within its piece)
  const int* last_target;  // (nb): the last piece's target of each block,
                           // or -1
  const float* pos_in;     // (B n, 3) the caller's bodies
  const float* vel_in;     // (B n, 3)
  const float* mass_in;    // (B n) or null (unit masses)
  float* pos_out;          // (B n, 3) after the last pass
  float* vel_out;          // (B n, 3)
  float* pos;              // (B np, KP): x, y, z[, m] (fp32 class), x, y, z
  float* vel;              // (B np, 3)
  float* q;                // (B np, 8): the bf16 class's operands
  float* acc;              // (B np, W) for a run of several pieces, else null
  float* part;             // B x (largest piece) x 2 tiles of (T, W)
  unsigned long long* bar; // the grid barrier's arrivals
  long long np;            // padded rows per system
  int rows;                // n_sys np, at most RESIDENT_SYM_MAX_N
  int n_sys, n_real, n_pieces, steps, ends, y4, y4_phase, mask_offdiag, fast;
  float dt, softening, far;
  // (kick_a, kick_b, drift) for r = 0, 1, 2, then the end passes' half-kick
  // and the opening drift
  float coef[11];
};

// One pass's update: v += ka F (+ kb F when two), x += h v when drift.
struct Kick {
  float ka, kb, h;
  bool two, drift;
};

__device__ __forceinline__ Kick pass_kick(const Args& a, int g, int passes) {
  if (a.ends && g == 0) return {a.coef[9], 0.f, a.coef[10], false, true};
  if (a.ends && g == passes - 1) return {a.coef[9], 0.f, 0.f, false, false};
  if (!a.y4) return {a.dt, 0.f, a.dt, false, true};
  const int r = (g - a.ends + a.y4_phase) % 3;
  return {a.coef[3 * r], a.coef[3 * r + 1], a.coef[3 * r + 2], true, true};
}

// A body's mass: the caller's, 0 for a pad, 1 with unit masses.
__device__ __forceinline__ float body_mass(const Args& a, long long sys,
                                           int r) {
  if (a.mass_in == nullptr) return 1.f;
  return r < a.n_real ? a.mass_in[sys * a.n_real + r] : 0.f;
}

// v = [m p | m] split into bf16(v) and v - bf16(v) (K2's _pack).
__device__ __forceinline__ void build_operand(const Args& a, long long i,
                                              long long sys, int r) {
  const float m = body_mass(a, sys, r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = k < 3 ? __fmul_rn(a.pos[i * 3 + k], m) : m;
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    a.q[i * 8 + k] = hi;
    a.q[i * 8 + 4 + k] = __fsub_rn(v, hi);
  }
}

// Row i of the padded state from the caller's bodies, its accumulator row
// zeroed, its operand built. Pad k of a system (row n_real + k) sits at
// (k + 1) FAR on every axis, with zero velocity and zero mass: any two
// bodies of a pair that touches a pad are at least FAR apart, so the pair's
// w is 0 exactly in both classes' bodies (C4) and a pad never moves.
template <bool kMxu, int KP, int W>
__device__ __forceinline__ void load_body(const Args& a, long long i) {
  const long long sys = i / a.np;
  const int r = static_cast<int>(i - sys * a.np);
  const bool real = r < a.n_real;
  const long long j = sys * a.n_real + r;
  const float far = __fmul_rn(a.far, static_cast<float>(r - a.n_real + 1));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.pos[i * KP + k] = real ? a.pos_in[j * 3 + k] : far;
    a.vel[i * 3 + k] = real ? a.vel_in[j * 3 + k] : 0.f;
  }
  if (KP == 4) a.pos[i * KP + 3] = body_mass(a, sys, r);
  if (a.acc != nullptr)
#pragma unroll
    for (int k = 0; k < W; ++k) a.acc[i * W + k] = 0.f;
  if (kMxu) build_operand(a, i, sys, r);
}

// Lanes per body of the fused reduce and integrate: the bf16 class sums
// each of its W = 8 columns on a lane of its own (then lane 0 gathers them
// with shuffles), the fp32 class its 3 columns on one thread.
template <bool kMxu>
__host__ __device__ constexpr int body_lanes() {
  return kMxu ? 8 : 1;
}

// The fused reduce and integrate of element e (body e / L, column e % L
// of its L lanes) after the last piece of a pass (last_n: that piece's
// slots, the systems' stride in part). A pad keeps its state: its sums
// (zeros) are never read. Every lane of a warp takes part (the bf16
// class's shuffles): rows L is a multiple of 32, as is the grid's stride.
template <int T, bool kMxu, int KP, int W>
__device__ __forceinline__ void integrate(const Args& a, int e,
                                          const Kick& kk, int last_n,
                                          bool last) {
  constexpr int kTileElems = T * W;
  constexpr int L = body_lanes<kMxu>();
  const long long i = e / L;
  const long long sys = i / a.np;
  const int r = static_cast<int>(i - sys * a.np);
  const bool real = r < a.n_real;
  const int t = real ? a.last_target[r / T] : -1;
  const float* row = a.part + sys * last_n * 2 * kTileElems + (r % T) * W;
  float s[W];
  if (kMxu) {
    const int col = e % L;
    float mine = a.acc != nullptr ? a.acc[i * W + col] : 0.f;
    if (t >= 0)
      mine = __fadd_rn(mine, slot_body::ordered_sum(
                                 row + col, a.entries, a.targets[3 * t + 1],
                                 a.targets[3 * t + 2], kTileElems));
    if (a.acc != nullptr) a.acc[i * W + col] = 0.f;
    const int lane0 = (threadIdx.x & 31) & ~(L - 1);
#pragma unroll
    for (int k = 0; k < W; ++k)
      s[k] = __shfl_sync(0xffffffffu, mine, lane0 + k);
    if (col != 0) return;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      s[k] = a.acc != nullptr ? a.acc[i * W + k] : 0.f;
    if (t >= 0) {
      float sum[W];
      slot_body::ordered_row_sum<W>(row, a.entries, a.targets[3 * t + 1],
                                    a.targets[3 * t + 2], kTileElems, sum);
#pragma unroll
      for (int k = 0; k < W; ++k) s[k] = __fadd_rn(s[k], sum[k]);
    }
    if (a.acc != nullptr)
#pragma unroll
      for (int k = 0; k < W; ++k) a.acc[i * W + k] = 0.f;
  }
  if (!real) return;
  float* p = a.pos + i * KP;
  float* v = a.vel + i * 3;
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
  float vn[3], pn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vn[k] = __fadd_rn(v[k], __fmul_rn(kk.ka, f[k]));
    if (kk.two) vn[k] = __fadd_rn(vn[k], __fmul_rn(kk.kb, f[k]));
    pn[k] = kk.drift ? __fadd_rn(p[k], __fmul_rn(kk.h, vn[k])) : p[k];
  }
  if (last) {
    const long long j = (sys * a.n_real + r) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.pos_out[j + k] = pn[k];
      a.vel_out[j + k] = vn[k];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = vn[k];
    p[k] = pn[k];
  }
  if (kMxu && kk.drift) build_operand(a, i, sys, r);
}

// The CTA's place in the schedule: the pass g, the piece pc, its first
// slot s0, its n slots and the units of the force phase (n a system). It
// lives in shared memory, so the force phase, whose body takes K3's or
// K2's whole register budget, keeps it out of registers.
struct Place {
  int g, pc, s0, n, units;
};

// Thread 0 moves the CTA to pass g, piece pc, once every thread has read
// the place before.
__device__ __forceinline__ void set_place(const Args& a, Place& at, int g,
                                          int pc) {
  __syncthreads();
  if (threadIdx.x == 0)
    at = {g, pc, a.pieces[4 * pc], a.pieces[4 * pc + 1],
          a.n_sys * a.pieces[4 * pc + 1]};
  __syncthreads();
}

// The force phase's shared memory: two areas, which the slots' turns
// alternate between. In the fp32 class an area is the body's whole shared
// memory (K3's layout); in the bf16 class it is the staged blocks, and the
// two share one body scratch after them (a turn's barrier separates one
// slot's use of it from the next), so that four CTAs fit an SM.
template <int T, bool kMxu>
__host__ __device__ constexpr size_t area_bytes() {
  return kMxu ? slot_body::mxu_stage_bytes<T>()
              : slot_body::fp32_smem_bytes<T>();
}

template <int T, bool kMxu>
constexpr size_t res_smem() {
  return 2 * area_bytes<T, kMxu>() +
         (kMxu ? slot_body::mxu_smem_bytes<T>() - area_bytes<T, kMxu>() : 0);
}

// One turn of the force phase's slot loop (walk_units), in area kArea: the
// unit s's blocks finish staging (store), a barrier, thread 0 reads the
// triple two turns ahead into the ring, the next unit's blocks start
// loading for the other area, and the unit computes. False when the CTA
// has no unit left. kArea is a constant, so the body's shared addresses
// stay immediates.
template <int kArea, class Read, class Load, class Store, class Compute>
__device__ __forceinline__ bool walk_turn(const Place& at,
                                          slot_body::Slot* ring, int& s,
                                          Read read, Load load, Store store,
                                          Compute compute) {
  if (s >= at.units) return false;
  const int stride = gridDim.x, k = s / stride % 3;
  store(kArea);
  // The unit's blocks are staged; every thread is done with the turn
  // before, so the other area and the ring entry it read are free.
  __syncthreads();
  if (threadIdx.x == 0 && s + 2 * stride < at.units)
    ring[(k + 2) % 3] = read(s + 2 * stride);
  if (s + stride < at.units) load(ring[(k + 1) % 3], s + stride, 1 - kArea);
  compute(ring[k].kind, s, kArea);
  s += stride;
  return true;
}

// The force phase's slot loop, walk_slots' schedule (slot_body.cuh) on two
// shared areas: this CTA takes units blockIdx.x, blockIdx.x + gridDim.x,
// ... of the place's piece over every system (unit u: slot s0 + u % n of
// system u / n); on its turn t a unit computes in area t % 2 while load
// (slot, u, area) fetches the next unit's blocks for the other area, and
// store(area) finishes a unit's staging before the barrier that opens its
// turn: one barrier a slot, besides the body's own. The units' slot
// triples go through a ring of three in shared memory, thread 0 reading
// each two turns ahead, so no triple is held in registers across a slot's
// compute.
template <class Load, class Store, class Compute>
__device__ __forceinline__ void walk_units(const Args& a, const Place& at,
                                           slot_body::Slot* ring, Load load,
                                           Store store, Compute compute) {
  auto read = [&](int u) {
    return slot_body::read_slot(a.slots, at.s0 + u % at.n);
  };
  int s = blockIdx.x;
  if (threadIdx.x == 0) {
    if (s < at.units) ring[0] = read(s);
    if (s + gridDim.x < at.units) ring[1] = read(s + gridDim.x);
  }
  __syncthreads();
  if (s < at.units) load(ring[0], s, 0);
  while (walk_turn<0>(at, ring, s, read, load, store, compute) &&
         walk_turn<1>(at, ring, s, read, load, store, compute)) {
  }
}

// cp.async of 4 bytes from device to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The fp32 class's stage: a slot's blocks bi and bj of pos (x, y, z[, m]
// rows) copied into an area as Fp32Stage::store lays them out (a float4 a
// body, block bi then bj) with cp.async, so the next slot's copy holds no
// registers while one computes. fp32_wait finishes this thread's copies.
template <int T, int K>
__device__ __forceinline__ void fp32_copy(int bi, int bj, const float* pos,
                                          float* area) {
  const float* ga = pos + static_cast<long long>(bi) * T * K;
  const float* gb = pos + static_cast<long long>(bj) * T * K;
  // The thread's offsets are the same every slot: read threadIdx anew, so
  // the compiler does not hold them across the slot's compute.
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  for (int t = tid; t < T * K; t += slot_body::fp32_threads<T>()) {
    const int r = t / K, k = t - K * r;
    cp_async4(area + 4 * r + k, ga + t);
    cp_async4(area + 4 * (T + r) + k, gb + t);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fp32_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The force phase of the place's piece over every system, the partials of
// unit u at part + u 2 tiles.
template <int T, bool kMxu, int K, bool kFast>
__device__ __forceinline__ void force_piece(const Args& a, const Place& at,
                                            slot_body::Slot* ring,
                                            unsigned char* smem) {
  constexpr int W = kMxu ? 8 : 3;
  constexpr int KP = kMxu ? 3 : K;
  constexpr long long kTileElems = T * W;
  constexpr size_t kArea = area_bytes<T, kMxu>();
  if constexpr (kMxu) {
    float* scratch = reinterpret_cast<float*>(smem + 2 * kArea);
    slot_body::MxuStage<T> stage;
    walk_units(
        a, at, ring,
        [&](const slot_body::Slot& sl, int u, int) {
          const long long sys = u / at.n;
          const float* p = a.pos + sys * a.np * KP;
          const float* q = a.q + sys * a.np * 8;
          stage.load(sl.bi, sl.bj, p, p, q, q);
        },
        [&](int area) { stage.store(smem + area * kArea); },
        [&](int kind, int u, int area) {
          slot_body::mxu_compute<T, false>(
              kind, a.part + u * 2 * kTileElems, a.softening, a.fast,
              a.mask_offdiag, smem + area * kArea, scratch);
        });
  } else {
    walk_units(
        a, at, ring,
        [&](const slot_body::Slot& sl, int u, int area) {
          fp32_copy<T, K>(
              sl.bi, sl.bj,
              a.pos + static_cast<long long>(u / at.n) * a.np * KP,
              reinterpret_cast<float*>(smem + area * kArea));
        },
        [&](int) { fp32_wait(); },
        [&](int kind, int u, int area) {
          slot_body::fp32_compute<T, K, kFast>(
              kind, a.part + u * 2 * kTileElems, a.softening,
              reinterpret_cast<float*>(smem + area * kArea));
        });
  }
}

// A grid barrier on the launch's arrival count (zeroed before the first,
// a cooperative_groups one): the k-th is passed once k gridDim.x CTAs have
// arrived. Thread 0 is read anew each time (asm volatile): the compiler
// would otherwise keep cooperative_groups' "first thread" predicate from
// the kernel's start to its end, across the force phase.
__device__ __forceinline__ void grid_sync(unsigned long long* bar) {
  __syncthreads();
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  if (tid == 0) {
    __threadfence();
    const unsigned long long arrived = atomicAdd(bar, 1ull);
    const unsigned long long target =
        (arrived / gridDim.x + 1) * gridDim.x;
    unsigned long long now;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(now)
                   : "l"(bar)
                   : "memory");
    } while (now < target);
    __threadfence();
  }
  __syncthreads();
}

// This thread's index in the grid, read anew at each call (asm volatile):
// the compiler would otherwise hold it in a register from one phase to the
// next, across the force phase, whose body needs them all.
__device__ __forceinline__ int grid_rank() {
  int r;
  asm volatile(
      "{\n .reg .u32 t, c, n;\n mov.u32 t, %%tid.x;\n"
      " mov.u32 c, %%ctaid.x;\n mov.u32 n, %%ntid.x;\n"
      " mad.lo.u32 %0, c, n, t;\n}"
      : "=r"(r));
  return r;
}

// The reduce of piece pc (every piece of a pass but the last): each target
// block's partials in slot order into the accumulator, one thread per
// element.
template <int T, int W>
__device__ __forceinline__ void reduce_piece(const Args& a, int pc) {
  constexpr int kTileElems = T * W;
  const int n = a.pieces[4 * pc + 1];
  const int t0 = a.pieces[4 * pc + 2], nt = a.pieces[4 * pc + 3] - t0;
  const int work = a.n_sys * nt * kTileElems;
  for (int u = grid_rank(); u < work; u += gridDim.x * blockDim.x) {
    const int elem = u % kTileElems;
    const int tt = u / kTileElems;
    const int sys = tt / nt;
    const int t = t0 + tt - sys * nt;
    const float* base =
        a.part + static_cast<long long>(sys) * n * 2 * kTileElems + elem;
    a.acc[sys * a.np * W + static_cast<long long>(a.targets[3 * t]) *
                               kTileElems + elem] +=
        slot_body::ordered_sum(base, a.entries, a.targets[3 * t + 1],
                               a.targets[3 * t + 2], kTileElems);
  }
}

template <int T, bool kMxu>
__host__ __device__ constexpr int res_threads() {
  return kMxu ? slot_body::mxu_threads<T>() : slot_body::fp32_threads<T>();
}

// Warps an SM an instantiation is compiled for (kWarps). The fp32 class:
// K3's kFp32Warps = 16 at T = 128 (2 CTAs of 256 threads, 128 registers);
// 12 at T = 64 (6 CTAs of 64 threads), where the body spills at 128
// registers. The bf16 class has two: K2's kMxuWarps = 12 for passes of
// more than kWideUnits force units (systems x the slots of the largest
// piece), and kWideWarps = 16 (4 CTAs of 128 threads at T = 128, a few
// bytes spilled) for passes of at most kWideUnits, where a CTA runs one or
// two slots and more CTAs an SM beat K2's registers (on an H100 the wide
// one won up to N = 8192 and lost from 16,384).
constexpr int kWideWarps = 16;
constexpr long long kWideUnits = 4096;

template <int T>
__host__ __device__ constexpr int fp32_warps() {
  return T == 128 ? slot_body::kFp32Warps : 12;
}

template <int T, bool kMxu, int kWarps>
__host__ __device__ constexpr int res_min_ctas() {
  return slot_body::stream_min_ctas(res_threads<T, kMxu>(), kWarps);
}

// No value of the schedule stays in registers across the force phase: the
// place is in shared memory, and every other value a phase needs is read
// from the arguments or recomputed there.
template <int T, bool kMxu, int K, bool kFast, int kWarps>
__global__ void __launch_bounds__(res_threads<T, kMxu>(),
                                  res_min_ctas<T, kMxu, kWarps>())
    resident_kernel(Args a) {
  constexpr int W = kMxu ? 8 : 3;   // partial and accumulator width
  constexpr int KP = kMxu ? 3 : K;  // position row width
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Place at;
  __shared__ slot_body::Slot ring[3];
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.bar = 0;
  for (int i = grid_rank(); i < a.rows; i += gridDim.x * blockDim.x)
    load_body<kMxu, KP, W>(a, i);
  cg::this_grid().sync();
  set_place(a, at, 0, 0);
  for (;;) {
    force_piece<T, kMxu, K, kFast>(a, at, ring, smem);
    grid_sync(a.bar);
    const int g = at.g, pc = at.pc;
    if (pc + 1 < a.n_pieces) {
      reduce_piece<T, W>(a, pc);
      grid_sync(a.bar);
      set_place(a, at, g, pc + 1);
      continue;
    }
    const int passes = a.steps + 2 * a.ends;
    const Kick kk = pass_kick(a, g, passes);
    const bool last = g + 1 == passes;
    for (int e = grid_rank(); e < a.rows * body_lanes<kMxu>();
         e += gridDim.x * blockDim.x)
      integrate<T, kMxu, KP, W>(a, e, kk, at.n, last);
    if (last) return;
    grid_sync(a.bar);
    set_place(a, at, g + 1, 0);
  }
}

constexpr int kMaxDevices = 64;

// CTAs per SM of a kernel at its launch's shared memory, and the card's
// SMs (the kernel's attribute set first).
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* per_sm,
                      int* sms) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  return err;
}

// units: the most force units of a pass (systems x the largest piece).
template <int T, bool kMxu, int K, bool kFast, int kWarps>
int launch(const Args& a, long long units, cudaStream_t stream) {
  auto kernel = resident_kernel<T, kMxu, K, kFast, kWarps>;
  constexpr int threads = res_threads<T, kMxu>();
  constexpr size_t smem = res_smem<T, kMxu>();
  // The co-resident CTAs of this instantiation on each device, queried at
  // its first launch there (0 until then).
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int most = dev < kMaxDevices ? resident[dev] : 0;
  if (most == 0) {
    int per_sm = 0, sms = 0;
    err = occupancy(kernel, threads, smem, &per_sm, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    most = per_sm * sms;
    if (dev < kMaxDevices) resident[dev] = most;
  }
  // The grid: as many CTAs as the largest phase has work for (a unit of
  // the force phase, or a CTA's worth of bodies' lanes), at most the
  // co-resident ones.
  const long long bodies =
      (static_cast<long long>(a.rows) * body_lanes<kMxu>() + threads - 1) /
      threads;
  long long ctas = units > bodies ? units : bodies;
  if (ctas > most) ctas = most;
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(static_cast<unsigned>(ctas)),
                                    dim3(threads), params, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local memory bytes per thread (spills) and CTAs per
// SM of one instantiation, at its launch's shared memory.
template <int T, bool kMxu, int K, bool kFast, int kWarps>
int info(int* out) {
  auto kernel = resident_kernel<T, kMxu, K, kFast, kWarps>;
  int sms = 0;
  cudaError_t err = occupancy(kernel, res_threads<T, kMxu>(),
                              res_smem<T, kMxu>(), &out[2], &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

#define NBODY_RES_DISPATCH(T, CALL)                                   \
  if (mxu && wide) return CALL(T, true, 3, false, kWideWarps);        \
  if (mxu) return CALL(T, true, 3, false, slot_body::kMxuWarps);      \
  if (k == 3 && fast) return CALL(T, false, 3, true, fp32_warps<T>()); \
  if (k == 3) return CALL(T, false, 3, false, fp32_warps<T>());       \
  if (k == 4 && fast) return CALL(T, false, 4, true, fp32_warps<T>()); \
  if (k == 4) return CALL(T, false, 4, false, fp32_warps<T>());       \
  return static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// slots (S, 3) int32 tri slot list; pieces (n_pieces, 4), targets (., 3),
// entries and last_target (nb) int32, the reduction plan (ops/resident_sym.
// resident_plan), largest its largest piece's slots; pos_in, vel_in
// (n_sys n_real, 3) and mass_in (n_sys n_real) or NULL (unit masses), the
// bodies, read once; pos_out, vel_out (n_sys n_real, 3), written after the
// last pass. Scratch: pos (n_sys np, k) fp32 packed (x, y, z[, m]) in the
// fp32 class (k = 3 or 4, 4 when mass_in is given), (n_sys np, 3) in the
// bf16 class (mxu = 1, k = 3) with q (n_sys np, 8); vel (n_sys np, 3); acc
// (n_sys np, 3|8) when n_pieces > 1, else NULL; part n_sys x largest x 2
// tiles of (tile, 3|8), 16-byte aligned; bar 8 bytes for the grid
// barrier. np a multiple of tile; far the pads' coordinate. The passes: steps Euler steps (coef NULL) or steps
// substeps of coef's (kick_a, kick_b, drift) cycle at y4_phase, with
// ends = 1 an opening pass (coef[9] half-kick, coef[10] drift) before them
// and a closing pass (coef[9] half-kick) after. tile: 64 or 128. The bf16
// class runs its kWideWarps instantiation when a pass has at most
// kWideUnits force units (n_sys x largest), else K2's warps. All device
// pointers contiguous on the current device. Returns cudaGetLastError()
// after the launch, or the launch's error (a cooperative launch that does
// not fit is refused, never shrunk).
extern "C" int resident_sym_launch(
    const int* slots, const int* pieces, int n_pieces, const int* targets,
    const int* entries, const int* last_target, int largest,
    const float* pos_in, const float* vel_in, const float* mass_in,
    float* pos_out, float* vel_out, float* pos, float* vel, float* q,
    float* acc, float* part, unsigned long long* bar, int n_sys,
    long long np, int n_real, int steps,
    int ends, float dt, float softening, float far, int fast,
    int mask_offdiag, const float* coef, int y4_phase, int tile, int mxu,
    int k, void* stream) {
  if (steps < 0 || steps + 2 * ends < 1 || (ends && coef == nullptr) ||
      n_sys < 1 || n_pieces < 1 || np % tile != 0 || np * n_sys > (1 << 30) ||
      (n_pieces > 1) != (acc != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{slots, pieces, targets, entries, last_target, pos_in, vel_in,
         mass_in, pos_out, vel_out, pos, vel, q, acc, part, bar, np,
         static_cast<int>(np * n_sys), n_sys, n_real, n_pieces, steps,
         ends != 0, coef != nullptr, y4_phase, mask_offdiag, fast, dt,
         softening, far, {}};
  if (coef != nullptr)
    for (int i = 0; i < 11; ++i) a.coef[i] = coef[i];
  const long long units = static_cast<long long>(n_sys) * largest;
  const bool wide = units <= kWideUnits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NBODY_RES_LAUNCH(T, M, K, F, W) launch<T, M, K, F, W>(a, units, s)
  if (tile == 64) { NBODY_RES_DISPATCH(64, NBODY_RES_LAUNCH) }
  if (tile == 128) { NBODY_RES_DISPATCH(128, NBODY_RES_LAUNCH) }
#undef NBODY_RES_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[3]: registers per thread, local bytes per thread and CTAs per SM of
// the kernel resident_sym_launch runs for (tile, mxu, k, fast), in the bf16
// class its kWideWarps instantiation when wide.
extern "C" int resident_sym_info(int tile, int mxu, int k, int fast,
                                 int wide, int* out) {
#define NBODY_RES_INFO(T, M, K, F, W) info<T, M, K, F, W>(out)
  if (tile == 64) { NBODY_RES_DISPATCH(64, NBODY_RES_INFO) }
  if (tile == 128) { NBODY_RES_DISPATCH(128, NBODY_RES_INFO) }
#undef NBODY_RES_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}
