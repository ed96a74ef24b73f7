"""Each cell's check at a size a CPU test can hold: the program's plain CPU
path passes, and the control and every fault a cell can have come out not
correct, under the limits the workload files hold for the full size.

A run here skips run.py's look for a card and drives the rest of a run
(inputs, warm-up, window, check) with ``run_cell(device="cpu")``; a fault
breaks the timed path underneath through the driver. The exchange between
chips is not among the faults: every cell runs on one card.

On the CPU every cell takes the port's plain path: the streamed slot sums
where the card runs K2 or K3, in fp32 where the card's K2 rounds to bf16.
Where that path's own error at these sizes reads above a full-size limit,
the cell's entry in SMALL sets the limit for this size.
"""

import json

import pytest
import torch

from portbench import run

C1, C2 = "mininbody-fp32.n1m-euler", "plummer3-bf16.grad262k"
C3, C4 = "plummer3-bf16.n262k-leapfrog", "mininbody-fp32.sweep4k"
C5 = "mininbody-bf16.n1m-euler"
CELLS = [C1, C2, C3, C4, C5]


def limits(cell, **at_this_size):
    """The workload file's limits, with those named replaced."""
    wl = json.loads((run.HERE / "workloads" / f"{cell}.json").read_text())
    return {**wl["limits"], **at_this_size}


SMALL = {
    # at 512 bodies no pair is close enough for the control's error to
    # reach the full size's start limit: the plain path of the control
    # reads dv_err.start and dx_err.start 4.7e-5-4.0e-4, the program's
    # 5.6e-7-5.7e-6 (4 seeds)
    C1: {"n": 512, "check": {"sample_rows": 64, "full_start": True},
         "limits": limits(C1, **{"dv_err.start": 1.5e-5,
                                 "dx_err.start": 1.5e-5})},
    C2: {"n": 512},
    C3: {"n": 512},
    C4: {"n": 4096, "systems": 2},
    # steps 2-10 on the fp32 plain path at 512 bodies read dx_err.p99.steps
    # 2.3e-4-9.1e-4 (3 seeds), the control 0.085-0.89
    C5: {"n": 512, "check": {"sample_rows": 64, "full_start": True},
         "limits": limits(C5, **{"dx_err.p99.steps": 5e-3})},
}
SEED = 2**31 + 977


def run_small(cell, control=False, hook=None, seconds=0.3):
    return run.run_cell(cell, SEED, seconds, False, device="cpu",
                        control=control, workload_overrides=SMALL[cell],
                        driver_hook=hook)


def failed(result):
    return sorted(k for k, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes(cell):
    result = run_small(cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    result = run_small(cell, control=True)
    assert not result["correct"], result["checks"]


# The faults: the step returns its state unchanged (the gradient cell:
# the update is skipped); half of the bodies (or systems) left out (the
# gradient cell: the loss over half of the bodies, doubled as a mean would
# be); one answer altered where it is produced.

def kind(driver) -> str:
    return type(driver).__module__.rsplit(".", 1)[-1]


def unchanged(driver):
    if kind(driver) == "rollout_grad":
        driver.lr = 0.0
        return
    if kind(driver) == "ensemble_sweep":
        driver.run = lambda: tuple(t.clone() for t in driver.s0[:2])
    else:
        driver.run = lambda pos, vel, mass: (pos.clone(), vel.clone())


def half_left_out(driver):
    if kind(driver) == "rollout_grad":
        # the loss over half of the bodies, scaled up as a mean would be
        driver.loss_fn = lambda y: 2.0 * (y[:y.shape[0] // 2] ** 2).sum()
        return
    run_ = driver.run
    if kind(driver) == "ensemble_sweep":
        def ens():
            pos, vel = run_()
            half = pos.shape[0] // 2
            pos, vel = pos.clone(), vel.clone()
            pos[half:], vel[half:] = driver.s0[0][half:], driver.s0[1][half:]
            return pos, vel
        driver.run = ens
    else:
        def one(pos, vel, mass):
            half = pos.shape[0] // 2
            p, v = run_(pos[:half].contiguous(), vel[:half].contiguous(),
                        mass[:half].contiguous())
            return torch.cat([p, pos[half:]]), torch.cat([v, vel[half:]])
        driver.run = one


def altered(driver):
    # the largest answer: a body's gradient or velocity, or a system's
    # velocities (a small one can be altered without changing anything);
    # where the cell compares percentiles of the bodies and no worst body
    # (the bf16 class, whose own error on a body in one of the closest
    # pairs of 2^20 bodies is up to 15 median changes), one tile of the
    # bodies' velocities, 1/32 of them as a tile of 128 is of 4096
    if kind(driver) == "rollout_grad":
        def iterate(x, _orig=driver.iterate):
            loss, grad = _orig(x)
            grad = grad.clone()
            grad[grad.norm(dim=1).argmax()] *= 2.0
            return loss, grad
        driver.iterate = iterate
        return
    run_ = driver.run
    if kind(driver) == "ensemble_sweep":
        def ens():  # one system's answer
            pos, vel = run_()
            vel = vel.clone()
            vel[-1] *= 1.01
            return pos, vel
        driver.run = ens
    else:
        tile = not any(k.startswith(("dv_err.", "dx_err."))
                       and k.count(".") == 1 for k in driver.wl["limits"])

        def one(pos, vel, mass):
            p, v = run_(pos, vel, mass)
            v = v.clone()
            n = v.shape[0]
            if tile:
                v[n // 4:n // 4 + n // 32] *= 1.01
            else:
                v[v.norm(dim=1).argmax()] *= 1.01
            return p, v
        driver.run = one


def few_bodies_off(driver):
    # 1/256 of the bodies' velocities 10% off on every call: under the 1%
    # that the 99th percentile sees, over the 0.1% that the 99.9th does
    run_ = driver.run

    def one(pos, vel, mass):
        p, v = run_(pos, vel, mass)
        v = v.clone()
        n = v.shape[0]
        v[n // 4:n // 4 + n // 256] *= 1.1
        return p, v
    driver.run = one


def test_a_few_wrong_bodies_fail_the_bf16_cell():
    result = run_small(C5, hook=few_bodies_off)
    assert failed(result) == ["dv_err.p999.start"]


def tile_off(driver):
    # one tile of a system, 1/32 of its bodies (128 of 4096 at full size),
    # its change over the call 3% off: under half and over 1% of the rows
    run_ = driver.run

    def ens():
        pos, vel = run_()
        n = pos.shape[1]
        rows = slice(n // 4, n // 4 + n // 32)
        x0, v0 = driver.s0[0][1, rows], driver.s0[1][1, rows]
        pos, vel = pos.clone(), vel.clone()
        pos[1, rows] = x0 + 0.97 * (pos[1, rows] - x0)
        vel[1, rows] = v0 + 0.97 * (vel[1, rows] - v0)
        return pos, vel
    driver.run = ens


def test_one_wrong_tile_fails_the_sweep():
    result = run_small(C4, hook=tile_off)
    assert not result["correct"], result["checks"]
    assert failed(result)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_fails(cell, fault):
    result = run_small(cell, hook=fault)
    assert not result["correct"], result["checks"]
    assert failed(result)
