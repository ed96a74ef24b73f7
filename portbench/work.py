"""The work a cell's problem needs, and the card's peaks.

A roofline share here is the least time the card could take for the work
the *problem* needs, over the device time the program took. The work is
counted from the problem alone: its bodies, its precision class, whether it
has masses, and the force passes and VJPs its integrator and loss need.
Which route runs it (``direct`` over ordered pairs, ``sym`` or ``sym_mxu``
pair-once, the band, the resident kernel) and whether a pass is computed
again under checkpointing do not enter, so a route change is read against
the same yardstick.

Counts, per unordered pair of bodies (each pair needs one reciprocal square
root; a mass adds a multiply on each side in the fp32 class):

* fp32 class (mini-nbody's arithmetic, ``auto`` and ``sym``): w from d,
  r2 and rsqrt^3 takes 12 operations with the rsqrt counted as 1, and each
  side's sum w d takes 6: 24 a pair, 26 with masses.
* bf16 class (bf16 pair weights, fp32 accumulation, ``sym_mxu``): w in fp32
  (12) and both sides' sums on the tensor cores, two sides of 8 columns of
  multiply-adds (32).
* a bf16-class VJP: 30 fp32 operations and 64 tensor-core operations a pair
  (the count of the port's pair-once bf16 backward); an fp32-class VJP 44
  fp32 operations a pair.

Bytes: each input read once and each output written once (positions and
masses in, forces or the VJP out); the pair work bounds every cell here.

Peaks (NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates): 67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16 on
them, 3.35 TB/s of HBM3. The special-function unit returns 16 rsqrts per
clock per SM (CUDA's throughput table for compute capability 9.0) on 132
SMs at the 1.98 GHz boost clock. The bound is the largest of the four
times, as the pipes run at once.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAKS = {
    "fp32": 67e12,
    "tensor": 989e12,
    "rsqrt": 16 * 132 * 1.98e9,
    "bytes": 3.35e12,
}

#: Operations a pair of one force pass, by precision class: (fp32,
#: tensor-core); masses add MASS_OPS fp32 operations in the fp32 class.
PASS_OPS = {"fp32": (24, 0), "bf16": (12, 32)}
MASS_OPS = {"fp32": 2, "bf16": 0}
#: Operations a pair of one force VJP, by precision class.
VJP_OPS = {"fp32": (44, 0), "bf16": (30, 64)}

F32 = 4


@dataclass(frozen=True)
class Work:
    """Operations, rsqrts and bytes of some work on the card."""

    fp32: float = 0.0
    tensor: float = 0.0
    rsqrt: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.fp32 + other.fp32, self.tensor + other.tensor,
                    self.rsqrt + other.rsqrt, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.fp32 * k, self.tensor * k, self.rsqrt * k,
                    self.bytes * k)

    __rmul__ = __mul__

    def times(self, peaks=PEAKS) -> dict:
        """Seconds each resource needs at its peak."""
        return {"fp32": self.fp32 / peaks["fp32"],
                "tensor": self.tensor / peaks["tensor"],
                "rsqrt": self.rsqrt / peaks["rsqrt"],
                "bytes": self.bytes / peaks["bytes"]}

    def bound_s(self, peaks=PEAKS) -> float:
        """The least seconds the card could take: the largest time."""
        return max(self.times(peaks).values())

    def bound_by(self, peaks=PEAKS) -> str:
        t = self.times(peaks)
        return max(t, key=t.get)


def pairs(n: int) -> float:
    """Unordered pairs of distinct bodies among n."""
    n = float(n)
    return n * (n - 1.0) / 2.0


def force_pass(n: int, cls: str, masses: bool) -> Work:
    """One force pass over n bodies in precision class cls."""
    fp32, tensor = PASS_OPS[cls]
    if masses:
        fp32 += MASS_OPS[cls]
    p = pairs(n)
    nbytes = n * (3 + 3 + (1 if masses else 0)) * F32
    return Work(p * fp32, p * tensor, p, nbytes)


def force_vjp(n: int, cls: str, masses: bool) -> Work:
    """One force VJP in the positions over n bodies in class cls."""
    fp32, tensor = VJP_OPS[cls]
    p = pairs(n)
    nbytes = n * (3 + 3 + 3 + (1 if masses else 0)) * F32
    return Work(p * fp32, p * tensor, p, nbytes)


#: Force passes a step of each integrator needs, and the passes before the
#: first step (the leapfrog family carries the acceleration).
PASSES_PER_STEP = {"euler": 1, "leapfrog": 1, "yoshida4": 3, "rk4": 4}
OPENING_PASSES = {"euler": 0, "leapfrog": 1, "yoshida4": 1, "rk4": 0}


def problem(config: dict, workload: dict) -> dict:
    """The work of one timed call of a cell, from its configuration (the
    precision class, masses, integrator) and its workload (bodies, systems,
    steps, kind) alone: {"force": Work, "vjp": Work, "step": Work,
    "passes": force passes, "vjps": VJPs, "interactions": N^2 a pass
    times passes}.

    A trajectory of s steps from a carried state needs s passes a step; a
    rollout gradient also its opening pass and, its loss being on the final
    velocities, the VJP of every step's force; an
    ensemble call starts each system from its initial state, so it needs
    its opening passes too."""
    cls, masses = config["class"], bool(config["masses"])
    integ = config["integrator"]
    n, systems = int(workload["n"]), int(workload.get("systems", 1))
    steps = int(workload["steps_per_call"])
    kind = workload["kind"]
    passes = steps * PASSES_PER_STEP[integ]
    vjps = 0
    if kind in ("rollout_grad", "ensemble_sweep"):
        passes += OPENING_PASSES[integ]
    if kind == "rollout_grad":
        if integ != "leapfrog":
            raise ValueError("rollout_grad counts leapfrog rollouts only")
        vjps = steps
    passes *= systems
    vjps *= systems
    force = passes * force_pass(n, cls, masses)
    vjp = vjps * force_vjp(n, cls, masses)
    return {"force": force, "vjp": vjp, "step": force + vjp,
            "passes": passes, "vjps": vjps,
            "interactions": float(n) * float(n) * passes}
