"""Reading a Chrome trace: busy and idle time, layer seconds, the breakdown
and the per-layer readers, on a trace made up here."""

import importlib.util
from pathlib import Path

import pytest

from portbench import profiling, work

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def made_up_trace():
    return profiling.Trace([
        ev("user_annotation", profiling.WINDOW_SPAN, 1000.0, 1000.0),
        ev("user_annotation", "portbench.trajectory.call", 1000.0, 1000.0),
        ev("cpu_op", "aten::empty", 1100.0, 50.0),
        # a kernel that starts before the window is clipped to it
        ev("kernel", "void (anonymous namespace)::symmetric_force_kernel"
           "<128, true>(int const*, int)", 900.0, 400.0),
        ev("kernel", "void slot_reduce_kernel(float const*)", 1200.0,
           100.0),
        ev("gpu_memcpy", "Memcpy DtoD", 1250.0, 100.0),
        ev("kernel", "void vjp_rect_mxu_kernel<128>(float const*)", 1500.0,
           400.0),
        ev("cuda_runtime", "cudaLaunchKernel", 1400.0, 80.0),
    ])


def test_busy_idle_and_layers():
    t = made_up_trace()
    assert t.window_s == pytest.approx(1e-3)
    # busy: [1000, 1350] and [1500, 1900]
    assert t.busy_s == pytest.approx(750e-6)
    assert t.gaps() == [(1350.0, 1500.0), (1900.0, 2000.0)]
    force = profiling.layer_patterns("force_kernels")
    assert t.ops_seconds(force) == pytest.approx(300e-6)
    assert t.ops_seconds(profiling.layer_patterns("reduction")) == \
        pytest.approx(100e-6)
    assert t.ops_seconds(profiling.layer_patterns("vjp_kernels")) == \
        pytest.approx(400e-6)
    assert t.ops_count() == 4


def test_breakdown_names_ops_and_gaps():
    b = made_up_trace().breakdown()
    assert b["device_ops"][0] == ["vjp_rect_mxu_kernel<128>",
                                  pytest.approx(400e-6)]
    assert ["symmetric_force_kernel<128, true>",
            pytest.approx(300e-6)] in b["device_ops"]
    gaps = dict(b["idle_gaps"])
    # the first gap's middle (1425) lies in the launch call, the second's
    # only in the benchmark's call span
    assert gaps["cudaLaunchKernel"] == pytest.approx(150e-6)
    assert gaps["portbench.trajectory.call"] == pytest.approx(100e-6)


def read_metric(name, reading):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(reading)


def test_readers():
    problem = {"force": work.Work(fp32=67e12 * 150e-6),
               "vjp": work.Work(fp32=67e12 * 100e-6),
               "step": work.Work(fp32=67e12 * 250e-6), "passes": 2}
    r = profiling.Reading(made_up_trace(), 1, problem)
    assert read_metric("force_roofline.sim", r) == pytest.approx(50.0)
    assert read_metric("vjp_roofline.grad", r) == pytest.approx(25.0)
    assert read_metric("idle.sim", r) == pytest.approx(25.0)
    assert read_metric("step_mfu.grad", r) == pytest.approx(25.0)
    assert read_metric("reduce.ms_per_pass.sim", r) == pytest.approx(0.05)
    assert read_metric("kernels_per_call.sweep", r) == 4
    # the sweep's layer also counts the slot-order sums
    assert read_metric("force_roofline.sweep", r) == pytest.approx(
        100.0 * 150e-6 / 400e-6)


def test_a_layer_that_ran_nothing_reads_nothing():
    t = profiling.Trace([
        ev("user_annotation", profiling.WINDOW_SPAN, 0.0, 10.0),
        ev("kernel", "void other_kernel()", 1.0, 2.0)])
    r = profiling.Reading(t, 1, {"force": work.Work(fp32=1.0),
                                 "passes": 1})
    assert read_metric("force_roofline.sim", r) is None
    assert read_metric("reduce.ms_per_pass.sim", r) is None


def test_every_metric_of_benchmark_json_has_a_reader():
    import json

    bench = json.loads((METRICS.parents[1] / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (METRICS / f"{m['name']}.py").is_file(), m["name"]
