"""Run the reference FPGA's own operating envelope end to end, on the
PyTorch + CUDA port (counterpart of examples/reference_envelope.py).

The reference accelerator serves N <= 32,767 bodies (its RAM depth) at a
hypothetical peak of 3.0 GInteractions/s (12 lanes @ 250 MHz; BASELINE.md).
This demo sweeps exactly that envelope:

  * config-1 scale (N=4096, dt=0.01, 1000 Euler steps per timed call),
  * the envelope edge (N=32,767, the reference's hard cap),
  * a leapfrog drift check at the edge (mass mode, softening 1e-2),

and prints measured GInteractions/s beside the device's name and the
reference's 3.0 G/s (wall time per simulate() call after a warm call; N at
or below sim.RESIDENT_AUTO_MAX_N routes the whole trajectory through the
resident kernel on the card).

Run: python examples/torch/reference_envelope.py [--quick] [--cpu]
(--quick shrinks sizes ~16x and steps to 10.)
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

REFERENCE_GIPS = 3.0  # hypothetical FPGA peak (BASELINE.md)


def main(quick: bool = False, cpu: bool = False) -> int:
    import torch

    from mini_nbody_tpu_torch import SimConfig, init, simulate
    from mini_nbody_tpu_torch.ops import diagnostics as diag

    device = torch.device("cpu" if cpu else "cuda")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    div = 16 if quick else 1
    steps = 10 if quick else 1000

    print(f"device: {name}  (reference envelope: N <= 32,767 @ "
          f"{REFERENCE_GIPS} G/s hyp.)")

    # 1. Reference config 1: N=4096, dt=0.01, Euler; then the edge.
    for i, n in enumerate((4096 // div, 32767 // div)):
        gen = torch.Generator(device=device).manual_seed(i)
        s = init.uniform_random(n, generator=gen, device=device)
        cfg = SimConfig(n=n, dt=0.01, steps=steps)
        simulate(cfg, s)  # warm: the build and first-use costs
        sync()
        t0 = time.perf_counter()
        simulate(cfg, s)
        sync()
        sec = time.perf_counter() - t0
        gips = n * n * steps / sec / 1e9
        print(f"N={n:6d} euler  {steps} steps: {sec*1e3:8.1f} ms  "
              f"{gips:7.1f} GInter/s on {name}  "
              f"({gips / REFERENCE_GIPS:6.1f}x the reference peak)")

    # 2. Drift gate at the envelope edge: leapfrog, mass mode.
    n = 32767 // div
    gen = torch.Generator(device=device).manual_seed(1)
    s = init.plummer(n, generator=gen, device=device)
    cfg = SimConfig(n=n, dt=1e-3, steps=steps, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    e0 = float(diag.total_energy(s, cfg.softening))
    out = simulate(cfg, s)
    e1 = float(diag.total_energy(out, cfg.softening))
    drift = abs(e1 - e0) / abs(e0)
    print(f"N={n:6d} leapfrog drift over {steps} steps: {drift:.2e} "
          f"(gate at 1k steps: <= 1e-5)")
    if not drift < 1e-4:
        raise SystemExit(f"energy drift {drift:.2e} over the 1e-4 bound")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    a = ap.parse_args()
    sys.exit(main(a.quick, a.cpu))
