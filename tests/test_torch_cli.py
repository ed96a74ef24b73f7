"""Port vs JAX package: the command line (mini_nbody_tpu_torch/cli.py).

Mirrors JAX's CLI tests (tests/test_cli.py) in process on the CPU with
``--device cpu``: run / resume / periodic checkpoints / trajectories /
ensembles, check's gates, and bench and shmoo with the harness's card
timing monkeypatched (the harness refuses to time the CPU, which the CLI
reports with a message). Against JAX on the same files: the report keys,
``ok`` and precision class of ``check``; a JAX checkpoint resumed by both
CLIs, energy at rtol 1e-5 and momentum at atol 1e-5 of sum |m v| (both
packages integrate in fp32, in different orders). The sharded path runs on
a one-rank gloo group (``--devices 1``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mini_nbody_tpu import cli as jcli
from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.utils import checkpoint as jckpt
from mini_nbody_tpu_torch import cli
from mini_nbody_tpu_torch.utils import autotune, harness, shmoo
from mini_nbody_tpu_torch.utils import checkpoint as ckpt

CPU = ["--device", "cpu"]
H100 = harness.CHIP_PEAKS["h100"]


def _run(capsys, argv, device=CPU):
    cli.main([*argv, *device])
    return capsys.readouterr().out.strip()


def _last(out):
    return json.loads(out.splitlines()[-1])


@pytest.fixture
def card_timing(monkeypatch):
    """The harness's card timings and peaks, stood in for on the CPU."""
    monkeypatch.setattr(harness, "chip_peaks", lambda name=None: H100)
    monkeypatch.setattr(harness, "time_step_fn",
                        lambda step, carry, reps=3, warmup=1: 2e-3)
    monkeypatch.setattr(shmoo, "time_resident",
                        lambda cfg, state, reps: 1e-5)


def test_run_save_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    rep = _last(_run(capsys, ["run", "--n", "128", "--steps", "3",
                              "--backend", "torch", "--save", ck,
                              "--energy"]))
    assert rep["steps"] == 3 and rep["checkpoint"] == ck and "energy" in rep
    rep = _last(_run(capsys, ["run", "--n", "128", "--steps", "2",
                              "--backend", "torch", "--resume", ck]))
    assert rep["n"] == 128 and set(rep) == {"n", "steps", "wall_s",
                                            "momentum"}


def test_resumed_run_is_simulate(tmp_path, capsys):
    """3 + 2 Euler steps through --save / --resume are bitwise 5 steps of
    simulate from the same seed."""
    from mini_nbody_tpu_torch import SimConfig, init, simulate

    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _run(capsys, ["run", "--n", "96", "--steps", "3", "--save", a])
    _run(capsys, ["run", "--n", "96", "--steps", "2", "--resume", a,
                  "--save", b])
    got, step, cfg_dict = ckpt.load(b, device="cpu")
    gen = torch.Generator().manual_seed(0)
    want = simulate(SimConfig(n=96, steps=5),
                    init.uniform_random(96, generator=gen, device="cpu"))
    assert step == 5 and cfg_dict["backend"] == "auto"
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)


@pytest.mark.parametrize("backend,jax_backend", [
    ("torch", "jnp"), ("sym", "sym"), ("sym_mxu", "sym_mxu")])
def test_check_reports_jax_keys_ok_and_class(backend, jax_backend, capsys):
    argv = ["check", "--n", "256", "--steps", "2", "--softening", "1e-2",
            "--init", "plummer"]
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--backend", backend, *CPU])
    assert e.value.code == 0
    port = _last(capsys.readouterr().out)
    with pytest.raises(SystemExit) as e:
        jcli.main([*argv, "--backend", jax_backend])
    assert e.value.code == 0
    ref = _last(capsys.readouterr().out)
    assert set(port) == set(ref)
    assert port["ok"] is ref["ok"] is True
    assert port["precision_class"] == ref["precision_class"]
    assert port["backend"] == backend
    assert port["force_max_rel_err"] < (5e-2 if backend == "sym_mxu"
                                        else 1e-4)


def test_check_gate_fails_with_exit_code_1(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["check", "--n", "128", "--steps", "1", "--backend", "sym",
                  "--force-tol", "1e-12", *CPU])
    assert e.value.code == 1
    assert _last(capsys.readouterr().out)["ok"] is False


def test_check_accepts_jax_backend_names(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["check", "--n", "128", "--steps", "1", "--backend",
                  "pallas", *CPU])
    assert e.value.code == 0
    assert _last(capsys.readouterr().out)["backend"] == "direct"


def test_resume_of_a_jax_checkpoint_matches_jax(tmp_path, capsys):
    """JAX's checkpoint resumed by both CLIs for 3 leapfrog steps."""
    state = jinit.plummer(jax.random.key(7), 128)
    path = jckpt.save(tmp_path / "jax_ck", state, step=11)
    argv = ["run", "--n", "128", "--steps", "3", "--softening", "1e-2",
            "--dt", "1e-3", "--integrator", "leapfrog", "--init", "plummer",
            "--resume", str(path), "--energy"]
    port = _last(_run(capsys, [*argv, "--backend", "torch"]))
    jcli.main([*argv, "--backend", "jnp"])
    ref = _last(capsys.readouterr().out)
    np.testing.assert_allclose(port["energy"], ref["energy"], rtol=1e-5)
    scale = float(np.abs(np.asarray(state.vel)
                         * np.asarray(state.mass)[:, None]).sum())
    np.testing.assert_allclose(port["momentum"], ref["momentum"],
                               rtol=0, atol=1e-5 * scale)


def test_run_periodic_checkpointing(tmp_path, capsys):
    ck = str(tmp_path / "periodic.npz")
    rep = _last(_run(capsys, ["run", "--n", "64", "--steps", "6",
                              "--backend", "torch", "--save", ck,
                              "--save-every", "2"]))
    assert rep["checkpoint"] == ck
    _, step, _ = ckpt.load(ck, device="cpu")
    assert step == 6


def test_run_periodic_checkpointing_stops_on_nonfinite(tmp_path, capsys,
                                                       monkeypatch):
    from mini_nbody_tpu_torch import sim

    real = sim.simulate

    def poisoned(cfg, state, steps=None):
        out = real(cfg, state, steps)
        out.pos[0, 0] = float("nan")
        return out

    monkeypatch.setattr(sim, "simulate", poisoned)
    with pytest.raises(FloatingPointError, match="at step 2"):
        _run(capsys, ["run", "--n", "64", "--steps", "6", "--backend",
                      "torch", "--save", str(tmp_path / "p.npz"),
                      "--save-every", "2"])


def test_run_trajectory_dump(tmp_path, capsys):
    path = tmp_path / "traj.npz"
    rep = _last(_run(capsys, ["run", "--n", "64", "--steps", "6", "--dt",
                              "1e-3", "--softening", "1e-2", "--backend",
                              "torch", "--trajectory", str(path),
                              "--save-every", "2"]))
    assert rep["trajectory"] == str(path)
    d = np.load(path)
    assert d["pos_history"].shape == (3, 64, 3)
    assert int(d["save_every"]) == 2
    assert np.isfinite(d["pos_history"]).all()


def test_run_coincident_flag(capsys):
    rep = _last(_run(capsys, ["run", "--n", "96", "--steps", "2",
                              "--backend", "sym_mxu", "--coincident",
                              "fast"]))
    assert rep["n"] == 96 and rep["steps"] == 2


def test_run_ensemble(capsys):
    rep = _last(_run(capsys, ["run", "--n", "96", "--steps", "2",
                              "--backend", "sym_mxu", "--ensemble", "3",
                              "--init", "plummer"]))
    assert rep["ensemble"] == 3 and rep["n"] == 96
    assert rep["momentum_max_abs"] < 1e-3


def test_run_ensemble_trajectory_dump(tmp_path, capsys):
    path = tmp_path / "ens_traj.npz"
    rep = _last(_run(capsys, ["run", "--n", "96", "--steps", "4",
                              "--ensemble", "2", "--init", "plummer",
                              "--trajectory", str(path), "--save-every",
                              "2"]))
    assert rep["ensemble"] == 2
    d = np.load(path)
    assert d["pos_history"].shape == (2, 2, 96, 3)  # (S, B, N, 3)
    assert np.isfinite(d["pos_history"]).all()


@pytest.mark.parametrize("flag", ["resume", "save"])
def test_run_ensemble_rejects_resume_and_save(tmp_path, flag):
    with pytest.raises(SystemExit, match=flag):
        cli.main(["run", "--n", "64", "--ensemble", "2", f"--{flag}",
                  str(tmp_path / "x.npz"), *CPU])


def test_run_without_a_card_exits_with_a_message(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        cli.main(["run", "--n", "64"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv", [
    ["bench", "--n", "64"], ["shmoo", "--sizes", "64"],
    ["tune", "--n", "64"], ["run", "--n", "64", "--autotune"]])
def test_card_timing_on_the_cpu_is_refused(argv, capsys):
    with pytest.raises(SystemExit, match="CUDA") as e:
        cli.main([*argv, *CPU])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_bench_reports(card_timing, capsys):
    rep = _last(_run(capsys, ["bench", "--n", "256", "--backend", "sym",
                              "--reps", "1"]))
    assert rep["backend"] == "sym" and rep["device"] == "cpu"
    assert rep["seconds"] == 2e-3
    t = harness.Throughput(n=256, steps=1, seconds=2e-3)
    assert rep["roofline_frac"] == t.roofline_fraction("sym", H100)
    assert set(rep) == {"device", "backend", "pair_dtype", "n", "steps",
                        "seconds", "ginteractions_per_s", "per_device",
                        "gflops_20c", "roofline_frac"}


def test_bench_resident(card_timing, capsys):
    rep = _last(_run(capsys, ["bench", "--n", "256", "--backend", "sym_mxu",
                              "--resident", "on", "--reps", "1"]))
    assert rep["backend"] == "sym_mxu (resident)" and rep["seconds"] == 1e-5


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_shmoo(card_timing, capsys, fmt, tmp_path):
    out = _run(capsys, ["shmoo", "--sizes", "128,256", "--backend", "jnp",
                        "--reps", "1", "--format", fmt])
    if fmt == "jsonl":
        rows = [json.loads(x) for x in out.splitlines()]
        assert [r["n"] for r in rows] == [128, 256]
        assert {r["backend"] for r in rows} == {"torch"}
    else:
        assert out.splitlines()[0] == ",".join(shmoo.FIELDS)
        assert len(out.splitlines()) == 3
    path = tmp_path / "shmoo.out"
    assert _run(capsys, ["shmoo", "--sizes", "128", "--backend", "torch",
                         "--reps", "1", "--format", fmt, "--out",
                         str(path)]) == ""
    assert path.read_text().splitlines()[0].startswith(
        "n,backend" if fmt == "csv" else '{"backend"')


def test_tune_reports_jax_keys_and_fills_the_cache(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "t.json"))
    monkeypatch.setattr(autotune, "device_name",
                        lambda device="cuda": "NVIDIA_H100_80GB_HBM3")
    monkeypatch.setattr(autotune, "_default_measure",
                        lambda cfg, reps, device: {64: 2.0, 128: 1.0}[
                            cfg.sym_tile])
    rep = _last(_run(capsys, ["tune", "--n", "4096", "--backend", "sym"]))
    assert rep["sym_tile"] == 128 and rep["cache"] == str(tmp_path /
                                                          "t.json")
    assert set(rep) == {"backend", "n", "sym_tile", "sym_chunk",
                        "sym_bwd_tile", "resident_tile", "tile_i", "tile_j",
                        "cache"}
    # run --autotune reads it back: a measurement now would fail
    monkeypatch.setattr(autotune, "_default_measure", None)
    seen = []
    real = autotune._apply_cached
    monkeypatch.setattr(autotune, "_apply_cached",
                        lambda cfg, params, fields=None:
                        seen.append(params) or real(cfg, params, fields))
    _run(capsys, ["run", "--n", "4096", "--steps", "1", "--backend", "sym",
                  "--autotune"])
    assert seen and seen[0]["sym_tile"] == 128


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_devices_runs_the_sharded_path(one_rank, capsys):
    from mini_nbody_tpu_torch.utils import tracing

    before = tracing.counters()["comm.all_gather"]
    sharded = _last(_run(capsys, ["run", "--n", "96", "--steps", "2",
                                  "--devices", "1", "--comm",
                                  "all_gather"]))
    assert tracing.counters()["comm.all_gather"] > before
    single = _last(_run(capsys, ["run", "--n", "96", "--steps", "2",
                                 "--backend", "direct"]))
    assert sharded["momentum"] == single["momentum"]


def test_devices_needs_the_world_size(one_rank):
    with pytest.raises(SystemExit, match="on 2 ranks"):
        cli.main(["run", "--n", "96", "--devices", "2", *CPU])
    with pytest.raises(SystemExit, match="on 4 ranks"):
        cli.main(["run", "--n", "96", "--devices", "2x2", "--comm", "grid",
                  *CPU])


def test_devices_without_torchrun_exits(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["run", "--n", "96", "--devices", "1", *CPU])


def test_module_runs_as_a_script():
    out = subprocess.run(
        [sys.executable, "-m", "mini_nbody_tpu_torch.cli", "run", "--n",
         "64", "--steps", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["n"] == 64
