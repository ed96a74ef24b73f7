"""The problem-fixed counts and the card's peaks (portbench/work.py)."""

import json
import math
from pathlib import Path

import pytest

from portbench import work

HERE = Path(__file__).resolve().parents[1]


def load(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


def test_fp32_pass_at_2_20_is_bound_by_fp32_operations():
    w = work.force_pass(1 << 20, "fp32", masses=False)
    assert w.bound_by() == "fp32"
    assert w.bound_s() == pytest.approx(0.197, abs=0.5e-3)


def test_bf16_pass_at_262144_is_bound_by_the_sfu():
    w = work.force_pass(262144, "bf16", masses=True)
    assert w.bound_by() == "rsqrt"
    assert w.bound_s() == pytest.approx(8.2e-3, abs=0.05e-3)
    assert work.PEAKS["rsqrt"] == 16 * 132 * 1.98e9


def test_bf16_pass_without_masses_at_2_20_is_bound_by_the_sfu():
    # the headline's class: 5.5e11 pairs at 4.18e12 rsqrt/s
    w = work.force_pass(1 << 20, "bf16", masses=False)
    assert w.bound_by() == "rsqrt"
    assert w.bound_s() == pytest.approx(0.1315, abs=0.5e-3)
    assert w.fp32 == 12 * work.pairs(1 << 20)
    assert w.tensor == 32 * work.pairs(1 << 20)
    assert w.bytes == (1 << 20) * 6 * work.F32


def test_bf16_vjp_at_262144():
    w = work.force_vjp(262144, "bf16", masses=True)
    assert w.bound_by() == "fp32"
    assert w.bound_s() == pytest.approx(15.4e-3, abs=0.05e-3)


def test_masses_add_two_operations_in_the_fp32_class_only():
    n = 4096
    assert (work.force_pass(n, "fp32", True).fp32
            == 26 * work.pairs(n))
    assert (work.force_pass(n, "bf16", True).fp32
            == work.force_pass(n, "bf16", False).fp32)


@pytest.mark.parametrize("config,cell", [
    ("mininbody-fp32", "mininbody-fp32.n1m-euler"),
    ("mininbody-fp32", "mininbody-fp32.sweep4k"),
    ("plummer3-bf16", "plummer3-bf16.n262k-leapfrog"),
    ("plummer3-bf16", "plummer3-bf16.grad262k"),
    ("mininbody-bf16", "mininbody-bf16.n1m-euler"),
])
def test_the_count_is_the_same_whatever_route_runs_it(config, cell):
    cfg, wl = load("configs", config), load("workloads", cell)
    want = work.problem(cfg, wl)
    for backend in ("auto", "torch", "direct", "sym", "sym_mxu", "mxu"):
        for traversal in ("auto", "slots", "band"):
            got = work.problem({**cfg, "backend": backend,
                                "traversal": traversal}, wl)
            assert got["step"] == want["step"]
            assert got["passes"] == want["passes"]
    for remat in ("none", "step", "sqrt"):
        got = work.problem(cfg, {**wl, "remat": remat})
        assert got["step"] == want["step"]


def test_cells_count_the_passes_and_vjps_their_problem_needs():
    p1 = work.problem(load("configs", "mininbody-fp32"),
                      load("workloads", "mininbody-fp32.n1m-euler"))
    assert (p1["passes"], p1["vjps"]) == (1, 0)
    assert p1["interactions"] == float(1 << 40)
    p2 = work.problem(load("configs", "plummer3-bf16"),
                      load("workloads", "plummer3-bf16.grad262k"))
    # the opening pass and one a step; a loss on the final velocities needs
    # every step's force VJP
    assert (p2["passes"], p2["vjps"]) == (11, 10)
    p3 = work.problem(load("configs", "plummer3-bf16"),
                      load("workloads", "plummer3-bf16.n262k-leapfrog"))
    assert (p3["passes"], p3["vjps"]) == (10, 0)
    p4 = work.problem(load("configs", "mininbody-fp32"),
                      load("workloads", "mininbody-fp32.sweep4k"))
    assert (p4["passes"], p4["vjps"]) == (640, 0)
    # 64 systems x 10 Euler passes of 4096 bodies: ~1.92 ms at the bound
    assert p4["step"].bound_s() == pytest.approx(1.92e-3, abs=0.01e-3)


def test_the_bf16_headline_counts_one_pass_without_masses():
    p5 = work.problem(load("configs", "mininbody-bf16"),
                      load("workloads", "mininbody-bf16.n1m-euler"))
    assert (p5["passes"], p5["vjps"]) == (1, 0)
    assert p5["interactions"] == float(1 << 40)
    assert p5["step"] == work.force_pass(1 << 20, "bf16", masses=False)


def test_work_adds_and_scales():
    a = work.Work(1.0, 2.0, 3.0, 4.0)
    assert a + a == 2 * a == a * 2
    assert math.isclose(work.Work(bytes=3.35e12).bound_s(), 1.0)
