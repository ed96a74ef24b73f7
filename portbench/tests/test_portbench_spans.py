"""The readers of the program's own spans (spans.py and the dispatch.*,
recomputed_passes.* metrics), on traces made up here."""

import importlib.util
from pathlib import Path

import pytest

from portbench import profiling, spans, work

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NEW = ("dispatch.idle.sim", "dispatch.idle.grad", "dispatch.idle.sweep",
       "dispatch.syncs_per_call.grad", "recomputed_passes.grad")


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def read_metric(name, reading):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(reading)


def reading(events, calls=1, passes=11):
    window = [ev("user_annotation", profiling.WINDOW_SPAN, 0.0, 1000.0)]
    return profiling.Reading(profiling.Trace(window + events), calls,
                             {"passes": passes, "force": work.Work()})


def test_a_gap_half_inside_a_force_span_counts_half():
    # busy [0, 400] and [600, 1000]: the gap [400, 600] is half inside
    # the force span [300, 500]
    r = reading([ev("kernel", "k", 0.0, 400.0),
                 ev("kernel", "k", 600.0, 400.0),
                 ev("user_annotation", "nbody.force", 300.0, 200.0)])
    assert read_metric("dispatch.idle.sim", r) == pytest.approx(10.0)
    assert read_metric("idle.sim", r) == pytest.approx(20.0)


def test_spans_of_two_threads_are_united_not_added():
    # the forward thread's force span and the autograd thread's vjp span
    # both cover [450, 550] of the gap [400, 600]
    r = reading([ev("kernel", "k", 0.0, 400.0),
                 ev("kernel", "k", 600.0, 400.0),
                 ev("user_annotation", "nbody.force", 420.0, 130.0),
                 ev("user_annotation", "nbody.vjp", 450.0, 140.0)])
    assert read_metric("dispatch.idle.grad", r) == pytest.approx(17.0)


def test_only_the_dispatch_spans_count_toward_dispatch_idle():
    r = reading([ev("kernel", "k", 0.0, 400.0),
                 ev("user_annotation", "nbody.simulate.streamed", 0.0,
                    1000.0),
                 ev("user_annotation", "nbody.resident", 900.0, 50.0)])
    assert read_metric("dispatch.idle.sweep", r) == pytest.approx(5.0)
    assert read_metric("idle.sweep", r) == pytest.approx(60.0)


def test_a_sync_outside_the_programs_spans_is_not_counted():
    r = reading([
        ev("user_annotation", "nbody.coincident_scan", 100.0, 100.0),
        ev("cuda_runtime", "cudaStreamSynchronize", 150.0, 20.0),
        ev("user_annotation", "nbody.vjp", 300.0, 100.0),
        ev("cuda_runtime", "cudaDeviceSynchronize", 390.0, 20.0),
        # the benchmark's own wait, after the program returned
        ev("cuda_runtime", "cudaDeviceSynchronize", 500.0, 20.0),
        ev("cuda_runtime", "cudaLaunchKernel", 320.0, 5.0),
    ], calls=2)
    assert read_metric("dispatch.syncs_per_call.grad", r) == 1.0


def test_recomputed_passes_are_the_force_spans_beyond_the_problems():
    forces = [ev("user_annotation", "nbody.force", 10.0 + 20.0 * k, 15.0)
              for k in range(40)]
    r = reading(forces, calls=2, passes=11)
    assert read_metric("recomputed_passes.grad", r) == 9.0


def test_a_trace_without_the_programs_spans_reads_nothing():
    r = reading([ev("kernel", "k", 0.0, 400.0),
                 ev("user_annotation", "portbench.rollout_grad.call", 0.0,
                    1000.0),
                 ev("cuda_runtime", "cudaStreamSynchronize", 500.0, 10.0)])
    for name in NEW:
        assert read_metric(name, r) is None, name


def test_union_and_overlap():
    assert spans._union([(5, 8), (0, 3), (2, 4), (9, 20)], 1, 10) == [
        [1, 4], [5, 8], [9, 10]]
    assert spans._overlap([[0, 4], [6, 10]], [[3, 7]]) == 2
