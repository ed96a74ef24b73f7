"""Each cell's check at a size a CPU test can hold: the program's plain CPU
path passes, and the control and every fault a cell can have come out not
correct, under the limits the workload files hold for the full size.

A run here skips run.py's look for a card and drives the rest of a run
(inputs, warm-up, window, check) with ``run_cell(device="cpu")``; a fault
breaks the timed path underneath through the driver. The exchange between
chips is not among the faults: every cell runs on one card.
"""

import pytest
import torch

from portbench import run

C1, C2 = "mininbody-fp32.n1m-euler", "plummer3-bf16.grad262k"
C3, C4 = "plummer3-bf16.n262k-leapfrog", "mininbody-fp32.sweep4k"
SMALL = {
    C1: {"n": 512, "check": {"sample_rows": 64, "full_start": True}},
    C2: {"n": 512},
    C3: {"n": 512},
    C4: {"n": 4096, "systems": 2},
}
SEED = 2**31 + 977


def run_small(cell, control=False, hook=None, seconds=0.3):
    return run.run_cell(cell, SEED, seconds, False, device="cpu",
                        control=control, workload_overrides=SMALL[cell],
                        driver_hook=hook)


def failed(result):
    return sorted(k for k, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("cell", [C1, C2, C3, C4])
def test_the_program_passes(cell):
    result = run_small(cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", [C1, C2, C3, C4])
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
    # velocities (a small one can be altered without changing anything)
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
        def one(pos, vel, mass):
            p, v = run_(pos, vel, mass)
            v = v.clone()
            v[v.norm(dim=1).argmax()] *= 1.01
            return p, v
        driver.run = one


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
@pytest.mark.parametrize("cell", [C1, C2, C3, C4])
def test_a_fault_fails(cell, fault):
    result = run_small(cell, hook=fault)
    assert not result["correct"], result["checks"]
    assert failed(result)
