"""The port's spans and counter registry (mini_nbody_tpu_torch/utils/tracing).

On the CPU: the program's ``nbody.*`` spans in a ``profile_trace`` of
simulate calls on each route, ensembles, trajectories and a checkpointed
rollout with its backward (one ``nbody.force`` span a force pass,
recomputed passes included; one ``nbody.vjp`` a force VJP; one
``nbody.resident`` a B15 trajectory); ``annotate`` with no profiler
recording never enters ``record_function``; the route counters and
``coincident.scan`` follow the route taken; ``nbody-torch run --trace
DIR`` writes the trace and reports the counters the run moved. The GPU
tests read the launch counters (tests/test_torch_gpu.py)."""

import json

import pytest
import torch

from mini_nbody_tpu_torch import (BodyState, SimConfig, cli, init,
                                  make_differentiable_ensemble_force,
                                  make_differentiable_force, make_rollout_fn,
                                  simulate, simulate_ensemble, trajectory,
                                  trajectory_ensemble)
from mini_nbody_tpu_torch.ops import autodiff
from mini_nbody_tpu_torch.ops import sym_mxu_force as sm
from mini_nbody_tpu_torch.sim import init_carry
from mini_nbody_tpu_torch.utils import tracing

torch.set_num_threads(1)


def _state(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init.plummer(n, generator=gen, device="cpu")


def _spans(path):
    """The trace's user spans: (name, start us, end us), in start order."""
    events = json.loads((path / tracing.TRACE_FILE).read_text())
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"])
                  for e in events["traceEvents"]
                  if e.get("cat") == "user_annotation")


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _moved(before):
    return dict(tracing.counters() - before)


def test_simulate_is_one_span_holding_one_force_span_a_pass(tmp_path):
    cfg = SimConfig(n=64, steps=10, dt=1e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    state = _state(64)
    with tracing.profile_trace(str(tmp_path), device="cpu"):
        simulate(cfg, state)
    spans = _spans(tmp_path)
    (sim,) = _named(spans, "nbody.simulate.streamed")
    forces = _named(spans, "nbody.force")
    assert len(forces) == 11  # the opening pass and one a step
    assert all(sim[1] <= f[1] and f[2] <= sim[2] for f in forces)
    assert not _named(spans, "nbody.resident")


def _pair(s):
    """Two systems of s's bodies, the second's in reverse order."""
    return BodyState(pos=torch.stack([s.pos, s.pos.flip(0)]),
                     vel=torch.stack([s.vel, s.vel]),
                     mass=torch.stack([s.mass, s.mass]))


def test_ensembles_and_trajectories_keep_one_force_span_a_pass(tmp_path):
    s = _state(64, seed=6)
    st = _pair(s)
    cfg = SimConfig(n=64, steps=3, dt=1e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True, backend="sym",
                    resident=False)
    with tracing.profile_trace(str(tmp_path), device="cpu"):
        simulate_ensemble(cfg, st)
        trajectory(cfg, s, 3)
        trajectory_ensemble(cfg, st, 3)
        force = make_differentiable_ensemble_force(cfg)
        p = st.pos.clone().requires_grad_(True)
        (force(p, st.mass) ** 2).sum().backward()
    spans = _spans(tmp_path)
    (ens,) = _named(spans, "nbody.simulate_ensemble.streamed")
    forces = _named(spans, "nbody.force")
    # 4 passes (the opening one and one a step) in each of the three
    # runs, and the differentiable force's one
    assert len(forces) == 13
    assert sum(ens[1] <= f[1] and f[2] <= ens[2] for f in forces) == 4
    assert len(_named(spans, "nbody.trajectory")) == 2
    assert len(_named(spans, "nbody.vjp")) == 1


def test_resident_and_fused_routes_keep_their_spans(tmp_path):
    # B15 runs the whole trajectory in one launch: one nbody.resident span
    # and no force span; the fused Euler step (K5) is one force pass a step
    s = _state(64, seed=7)
    with tracing.profile_trace(str(tmp_path), device="cpu"):
        simulate(SimConfig(n=64, steps=3, dt=1e-3, softening=1e-2,
                           use_masses=True, resident=True), s)
        simulate(SimConfig(n=64, steps=3, dt=1e-3, softening=1e-2,
                           backend="direct", fused_integrate=True), s)
    spans = _spans(tmp_path)
    (res,) = _named(spans, "nbody.simulate.resident")
    (b15,) = _named(spans, "nbody.resident")
    assert res[1] <= b15[1] and b15[2] <= res[2]
    (streamed,) = _named(spans, "nbody.simulate.streamed")
    forces = _named(spans, "nbody.force")
    assert len(forces) == 3
    assert all(streamed[1] <= f[1] and f[2] <= streamed[2] for f in forces)


def test_sqrt_rollout_and_backward_count_every_pass(tmp_path):
    # init_carry's opening pass, 10 forward passes and the 9 that the 3
    # checkpointed segments of 3 steps recompute in the backward: 20
    # force spans; one VJP a step: 10 vjp spans, all through B13's route.
    cfg = SimConfig(n=64, dt=1e-3, softening=1e-2, integrator="leapfrog",
                    backend="sym_mxu", use_masses=True)
    s = _state(64, seed=1)
    before = tracing.counters()
    with tracing.profile_trace(str(tmp_path), device="cpu"):
        carry = init_carry(cfg, s)
        p = s.pos.clone().requires_grad_(True)
        out, _ = make_rollout_fn(cfg, 10, remat="sqrt")(
            (BodyState(pos=p, vel=s.vel, mass=s.mass), carry[1]))
        (out.vel ** 2).sum().backward()
    spans = _spans(tmp_path)
    assert len(_named(spans, "nbody.force")) == 20
    assert len(_named(spans, "nbody.vjp")) == 10
    assert len(_named(spans, "nbody.rollout")) == 1
    assert _moved(before) == {"route.vjp.B13": 10}


def test_annotate_without_a_profiler_never_enters_record_function(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(tracing, "record_function", refuse)
    with tracing.annotate("nbody.test"):
        pass
    out = simulate(SimConfig(n=32, steps=2, integrator="leapfrog"),
                   _state(32))
    assert torch.isfinite(out.pos).all()
    # while a profiler records, the same span does enter it
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="nbody.test"):
            with tracing.annotate("nbody.test"):
                pass


def test_counters_are_a_snapshot():
    snap = tracing.counters()
    tracing.count("test.snapshot", 2)
    assert snap["test.snapshot"] + 2 == tracing.counters()["test.snapshot"]
    assert _moved(snap) == {"test.snapshot": 2}


@pytest.mark.parametrize("resident", [True, False, None])
def test_simulate_counts_its_route(resident):
    cfg = SimConfig(n=64, steps=3, dt=1e-3, softening=1e-2,
                    use_masses=True, resident=resident)
    before = tracing.counters()
    simulate(cfg, _state(64, seed=2))
    # resident=None routes to B15 on a CUDA state only
    route = "resident" if resident else "streamed"
    assert _moved(before) == {f"route.simulate.{route}": 1}


@pytest.mark.parametrize("resident", [True, False])
def test_simulate_ensemble_counts_its_route(resident):
    st = _pair(_state(64, seed=3))
    cfg = SimConfig(n=64, steps=3, dt=1e-3, softening=1e-2,
                    use_masses=True, backend="sym", resident=resident)
    before = tracing.counters()
    simulate_ensemble(cfg, st)
    route = "resident" if resident else "streamed"
    assert _moved(before) == {f"route.ensemble.{route}": 1}


@pytest.mark.parametrize("backend,bound,vjp", [
    ("torch", None, "torch"), ("sym", None, "B11"), ("sym", 32, "B10"),
    ("sym_mxu", None, "B13"), ("sym_mxu", 32, "B14")])
def test_vjp_route_is_counted(monkeypatch, backend, bound, vjp):
    if bound is not None:
        monkeypatch.setattr(autodiff, "_SYM_BWD_MAX", bound)
    s = _state(64, seed=4)
    force = make_differentiable_force(SimConfig(
        n=64, backend=backend, softening=1e-2, use_masses=True))
    p = s.pos.clone().requires_grad_(True)
    out = force(p, s.mass)
    before = tracing.counters()
    (out ** 2).sum().backward()
    assert _moved(before) == {f"route.vjp.{vjp}": 1}


@pytest.mark.parametrize("gate,scans", [(None, 0), (0, 1)])
def test_the_duplicate_scan_is_counted_where_it_runs(tmp_path, monkeypatch,
                                                     gate, scans):
    # K2's gate is infinite on the card: 'auto' is 'masked' with no scan;
    # lowered, every 'auto' call scans once, in its own span.
    if gate is not None:
        monkeypatch.setattr(sm, "COINCIDENT_AUTO_MIN_N", gate)
    pos = _state(64, seed=5).pos
    before = tracing.counters()
    with tracing.profile_trace(str(tmp_path), device="cpu"):
        got = sm.body_force_sym_mxu(pos, coincident="auto")
    assert tracing.counters()["coincident.scan"] - \
        before["coincident.scan"] == scans
    assert len(_named(_spans(tmp_path), "nbody.coincident_scan")) == scans
    assert torch.equal(got, sm.body_force_sym_mxu(pos, coincident="masked"))


def test_cli_run_trace_writes_the_trace_and_reports_counters(tmp_path,
                                                             capsys):
    cli.main(["run", "--n", "64", "--steps", "3", "--integrator",
              "leapfrog", "--init", "plummer", "--device", "cpu",
              "--trace", str(tmp_path / "tr")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["trace"] == str(tmp_path / "tr" / tracing.TRACE_FILE)
    assert report["counters"] == {"route.simulate.streamed": 1}
    spans = _spans(tmp_path / "tr")
    assert len(_named(spans, "nbody.simulate.streamed")) == 1
    assert len(_named(spans, "nbody.force")) == 4


def test_cli_run_trace_refuses_the_sharded_path(tmp_path):
    with pytest.raises(SystemExit, match="--trace"):
        cli.main(["run", "--n", "64", "--device", "cpu", "--devices", "2",
                  "--trace", str(tmp_path)])
