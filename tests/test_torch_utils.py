"""Port vs JAX package: the harness's roofline, tracing, checkpoints, the
shmoo and the autotuner (mini_nbody_tpu_torch/utils/).

Against JAX on the same inputs: Throughput's arithmetic, roofline_path for
every JAX (backend, pair_dtype, masses, sharded), StepMetrics rows under one
clock, checkpoints written by either package loaded bitwise by the other,
and the shmoo's CSV / JSON text byte for byte. The autotuner's tests mirror
JAX's (tests/test_utils.py) on the port's candidate tables with injected
measurements. The sharded checkpoints run on 1 (in process), 2 and 4 gloo
ranks (tests/_torch_ckpt_worker.py, spawned together). Card timings are
monkeypatched here: the harness refuses to time the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mini_nbody_tpu import SimConfig as JConfig
from mini_nbody_tpu.models import init as jinit
from mini_nbody_tpu.utils import checkpoint as jckpt
from mini_nbody_tpu.utils import harness as jharness
from mini_nbody_tpu.utils import shmoo as jshmoo
from mini_nbody_tpu.utils import tracing as jtracing
from mini_nbody_tpu_torch import BodyState, SimConfig, make_mesh
from mini_nbody_tpu_torch.ops.force import make_force_fn
from mini_nbody_tpu_torch.ops.reference import body_force_torch
from mini_nbody_tpu_torch.parallel import _comm
from mini_nbody_tpu_torch.parallel.sharded import shard_state
from mini_nbody_tpu_torch.utils import autotune, harness, shmoo, tracing
from mini_nbody_tpu_torch.utils import checkpoint as ckpt
from mini_nbody_tpu_torch.utils.config import (JAX_BACKENDS, RESIDENT_TILES,
                                               SYM_BWD_TILES)

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _torch_ckpt_worker as W  # noqa: E402

H100 = harness.CHIP_PEAKS["h100"]


def _np_state(n, seed=0, masses=True):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = (0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    mass = (rng.uniform(0.5, 1.5, n) / n if masses
            else np.ones(n)).astype(np.float32)
    return pos, vel, mass


def _cpu_state(n, seed=0, masses=True):
    return BodyState.from_numpy(*_np_state(n, seed, masses), device="cpu")


# ---------------------------------------------------------------- harness


@pytest.mark.parametrize("n,steps,seconds,n_devices",
                         [(1000, 2, 1.0, 2), (1 << 20, 1, 0.4772, 1),
                          (64, 1, 10.0, 4)])
def test_throughput_arithmetic_equals_jax(n, steps, seconds, n_devices):
    t = harness.Throughput(n=n, steps=steps, seconds=seconds,
                           n_devices=n_devices)
    j = jharness.Throughput(n=n, steps=steps, seconds=seconds,
                            n_devices=n_devices)
    assert t.interactions == j.interactions
    assert t.ginteractions_per_s == j.ginteractions_per_s
    assert t.ginteractions_per_s_per_device == \
        j.ginteractions_per_s_per_device
    assert t.gflops == j.gflops


def test_report_without_a_path_is_the_throughput_dict(monkeypatch):
    t = harness.Throughput(n=1000, steps=2, seconds=1.0, n_devices=2)
    rep = t.report()
    assert rep == {"n": 1000, "steps": 2, "seconds": 1.0,
                   "ginteractions_per_s": t.ginteractions_per_s,
                   "per_device": t.ginteractions_per_s_per_device,
                   "gflops_20c": t.gflops}
    monkeypatch.setattr(harness, "chip_peaks", lambda name=None: H100)
    with_path = t.report(path="sym")
    assert with_path.pop("roofline_frac") == t.roofline_fraction("sym", H100)
    assert with_path == rep


#: JAX (backend, pair_dtype) -> the port's roofline path, with and without
#: masses, on one device and sharded.
_JAX_PATH_CASES = [("auto", "float32"), ("jnp", "float32"),
                   ("pallas", "float32"), ("sym", "float32"),
                   ("sym_mxu", "float32"), ("mxu", "float32"),
                   ("mxu", "bfloat16")]


def _expected_path(backend, pair_dtype, masses, sharded):
    # The port's 'auto' is JAX's 'auto' on its TPU (utils/config.py:246-253:
    # 'sym' on one device, 'pallas' sharded) on every device; JAX's CPU run
    # here would resolve it to 'jnp'.
    if backend == "auto":
        backend = "pallas" if sharded else "sym"
    jpath = jharness.roofline_path(
        JConfig(n=64, backend=backend, pair_dtype=pair_dtype,
                use_masses=masses), sharded=sharded)
    mass = "_mass" if masses else ""
    if jpath == "vpu":
        return "direct"
    if jpath in ("sym", "sym_mass"):
        return jpath
    if jpath == "sym_mxu":
        return "sym_mxu"
    assert jpath == "mxu"
    return "mxu_bf16" + mass if pair_dtype == "bfloat16" else "mxu_fp32"


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("backend,pair_dtype", _JAX_PATH_CASES)
def test_roofline_path_maps_every_jax_combination(backend, pair_dtype,
                                                  masses, sharded):
    jcfg = JConfig(n=64, backend=backend, pair_dtype=pair_dtype,
                   use_masses=masses)
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    got = harness.roofline_path(cfg, sharded=sharded)
    assert got == _expected_path(backend, pair_dtype, masses, sharded)
    assert got in harness.PATHS


def test_roofline_path_band_counts_its_column_partials():
    cfg = SimConfig(n=1 << 20, backend="sym_mxu", traversal="band")
    assert harness.roofline_path(cfg) == "sym_mxu_band"
    band = harness.pass_work("sym_mxu_band", 1 << 20)
    slots = harness.pass_work("sym_mxu", 1 << 20)
    # 8 tri calls of 1024 * 1023 / 2 tiles and 28 cross calls of 1024^2,
    # each (128, 8) fp32 partial written and read once.
    tiles = 8 * 1024 * 1023 // 2 + 28 * 1024 * 1024
    assert band["bytes"] - slots["bytes"] == tiles * 128 * 8 * 4 * 2
    assert {k: band[k] for k in ("fp32", "bf16", "rsqrts")} == \
        {k: slots[k] for k in ("fp32", "bf16", "rsqrts")}


def test_chip_peaks_picks_the_row_by_name_and_raises_otherwise(monkeypatch):
    assert harness.chip_peaks("NVIDIA H100 80GB HBM3") is H100
    with pytest.raises(ValueError, match="no peak rates"):
        harness.chip_peaks("NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Some Unknown GPU")
    with pytest.raises(ValueError, match="Some Unknown GPU"):
        harness.chip_peaks()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NotOnCard):
        harness.chip_peaks()


#: PERF.md's card times for one 2^20 force pass (ms) and the bound time
#: chip_smoke.py gives each (ms): roofline_frac is their ratio.
@pytest.mark.parametrize("backend,pair_dtype,pass_ms,bound_ms", [
    ("direct", "float32", 526.4, 328.2), ("auto", "float32", 492.9, 196.9),
    ("sym_mxu", "float32", 477.0, 131.5),
    ("mxu", "bfloat16", 559.0, 262.9)])
def test_roofline_fraction_at_the_card_times(backend, pair_dtype, pass_ms,
                                             bound_ms):
    n = 1 << 20
    cfg = SimConfig(n=n, backend=backend, pair_dtype=pair_dtype)
    t = harness.Throughput(n=n, steps=1, seconds=pass_ms / 1e3)
    frac = t.roofline_fraction(harness.roofline_path(cfg), H100)
    assert frac == pytest.approx(bound_ms / pass_ms, rel=1e-3)
    assert 0 < frac <= 1


def test_chip_smoke_bound_is_the_harness_bound():
    import chip_smoke

    assert chip_smoke.PEAKS is H100
    args = (1.1e12 * 20, 24 * (1 << 20), 3e12, 5.5e11)
    assert chip_smoke.bound(*args) == harness.bound(*args, peaks=H100)
    assert (chip_smoke.OPS_ORDERED, chip_smoke.OPS_PAIR_ONCE,
            chip_smoke.OPS_PAIR_ONCE_MASS, chip_smoke.OPS_K2_FP32,
            chip_smoke.OPS_K2_MMA, chip_smoke.OPS_B6_FP32,
            chip_smoke.OPS_B6_MASS, chip_smoke.OPS_B6_MMA) == (
        20, 24, 26, 12, 32, 12, 13, 16)


def test_card_timers_refuse_the_cpu():
    with pytest.raises(harness.NotOnCard):
        harness.time_steps_call(lambda k: None, "cpu", 20)
    with pytest.raises(harness.NotOnCard):
        shmoo.time_resident(SimConfig(n=64, resident=True),
                            _cpu_state(64), reps=1)


# ---------------------------------------------------------------- tracing


def test_profile_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    step_fn = make_force_fn(SimConfig(n=64, backend="torch"))
    pos = _cpu_state(64).pos
    with tracing.profile_trace(str(tmp_path / "trace"), device="cpu") as p:
        with tracing.annotate("force_span"):
            out = step_fn(pos, pos)
    assert out.shape == (64, 3)
    events = json.loads((tmp_path / "trace" / tracing.TRACE_FILE)
                        .read_text())["traceEvents"]
    assert "force_span" in {e.get("name") for e in events}
    # the program's own span of the force pass, inside the caller's
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    outer, inner = spans["force_span"], spans["nbody.force"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert any(a.key == "force_span" for a in p.key_averages())


def test_profile_trace_on_cuda_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NotOnCard):
        with tracing.profile_trace(str(tmp_path)):
            pass


def test_step_metrics_rows_equal_jax(monkeypatch):
    clock = iter([10.0, 10.5, 11.25, 11.25, 13.0])
    ticks = []

    def perf_counter():
        ticks.append(next(clock))
        return ticks[-1]

    monkeypatch.setattr(time, "perf_counter", perf_counter)
    port = tracing.StepMetrics(n=4096, n_devices=1).start()
    rows_port = [port.tick(10, energy=-1.0), port.tick(5),
                 port.tick(5, drift=1e-7), port.tick(3)]
    clock = iter([10.0, 10.5, 11.25, 11.25, 13.0])
    ref = jtracing.StepMetrics(n=4096, n_devices=1).start()
    rows_jax = [ref.tick(10, energy=-1.0), ref.tick(5),
                ref.tick(5, drift=1e-7), ref.tick(3)]
    assert rows_port == rows_jax
    assert port.jsonl() == ref.jsonl()


# ------------------------------------------------------------- checkpoint


@pytest.mark.parametrize("jcfg", [
    JConfig(n=64, steps=7, backend="jnp", softening=1e-2),
    JConfig(n=64, steps=3, backend="sym_mxu", comm="ring",
            mesh_shape=(8,), use_masses=True)])
def test_jax_checkpoint_loads_bitwise_in_the_port(tmp_path, jcfg):
    state = jinit.plummer(jax.random.key(3), 64)
    path = jckpt.save(tmp_path / "jax_ck", state, step=42, cfg=jcfg)
    s2, step, cfg_dict = ckpt.load(tmp_path / "jax_ck", device="cpu")
    assert step == 42
    for f in ("pos", "vel", "mass"):
        want = np.asarray(getattr(state, f))
        got = getattr(s2, f).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)
    cfg = ckpt.restore_config(cfg_dict)
    assert cfg == SimConfig.from_dict(dataclasses.asdict(jcfg))
    assert cfg.backend == JAX_BACKENDS[jcfg.backend]
    assert path.exists()


def test_port_checkpoint_loads_bitwise_in_jax(tmp_path):
    state = _cpu_state(100, seed=4)
    ckpt.save(tmp_path / "port_ck", state, step=9,
              cfg=SimConfig(n=100, backend="sym"))
    js, step, cfg_dict = jckpt.load(tmp_path / "port_ck")
    assert step == 9
    for f in ("pos", "vel", "mass"):
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(state, f).numpy())
    # A config on a name both packages share restores in JAX too.
    assert jckpt.restore_config(dict(cfg_dict, interpret=None)).backend \
        == "sym"


@pytest.mark.parametrize("backend", ["torch", "direct"])
def test_port_checkpoint_roundtrip_restores_port_configs(tmp_path, backend):
    state = _cpu_state(64, seed=5)
    cfg = SimConfig(n=64, steps=7, backend=backend, comm="grid",
                    mesh_shape=(2, 2))
    written = ckpt.save(tmp_path / "ck.npz", state, step=3, cfg=cfg)
    s2, step, cfg_dict = ckpt.load(written, device="cpu")
    assert step == 3 and ckpt.restore_config(cfg_dict) == cfg
    for f in ("pos", "vel", "mass"):
        assert torch.equal(getattr(s2, f), getattr(state, f))


def test_checkpoint_suffixless_path_roundtrip(tmp_path):
    state = _cpu_state(16, seed=6)
    written = ckpt.save(tmp_path / "ck", state, step=3)
    assert written.exists() and written.suffix == ".npz"
    s2, step, cfg_dict = ckpt.load(tmp_path / "ck", device="cpu")
    assert step == 3 and cfg_dict is None
    assert torch.equal(s2.pos, state.pos)


CK_N = W.N
_ck_state = W.ck_state


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned_ckpts(tmp_path_factory):
    """A one-rank checkpoint of _ck_state (written in this process), then
    2 and 4 gloo ranks spawned together (tests/_torch_ckpt_worker.py):
    each saves its world's checkpoint and loads its own and the one-rank
    one onto its mesh."""
    root = tmp_path_factory.mktemp("ckpt")
    dist.init_process_group("gloo", init_method=f"file://{root}/rdv1",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1,))
        ckpt.save_sharded(root / "ck_w1", mesh,
                          shard_state(_ck_state(), mesh, pad_far=True),
                          step=5, cfg=SimConfig(n=CK_N))
    finally:
        dist.destroy_process_group()
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    for world in (2, 4):
        for rank in range(world):
            log = open(root / f"w{world}r{rank}.log", "w")
            procs.append((world, rank, log, subprocess.Popen(
                [sys.executable, str(TESTS / "_torch_ckpt_worker.py"),
                 str(world), str(rank), str(root / f"rdv{world}"),
                 str(root)], env=env, stdout=log,
                stderr=subprocess.STDOUT)))
    try:
        for *_, p in procs:
            p.wait(timeout=240)
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for world, rank, _, p in procs:
        assert p.returncode == 0, (root / f"w{world}r{rank}.log").read_text()
    return root


def _equal_states(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("pos", "vel", "mass"))


def test_save_load_sharded_one_rank(one_rank, tmp_path):
    mesh = make_mesh((1,))
    state = _ck_state()
    local = shard_state(state, mesh, pad_far=True)
    before = dict(_comm.CALLS)
    path = ckpt.save_sharded(tmp_path / "ck", mesh, local, step=4,
                             cfg=SimConfig(n=CK_N))
    back, step, cfg_dict = ckpt.load_sharded(path, mesh, pad_far=True)
    assert _comm.CALLS == before  # no all-gather, no collective at all
    assert step == 4 and cfg_dict["n"] == CK_N
    assert _equal_states(back, local)
    whole, _, _ = ckpt.load_sharded(path, device="cpu")
    assert _equal_states(whole, state)
    assert sorted(p.name for p in path.iterdir()) == ["meta.json",
                                                      "rank0.npz"]


@pytest.mark.parametrize("world", [2, 4])
def test_save_load_sharded_multi_rank(spawned_ckpts, world, one_rank):
    """Each rank of the spawned world wrote only its rows (no all-gather,
    checked in the worker) and restored its block bitwise from its own and
    from the one-rank checkpoint; here the world's checkpoint restores
    whole, and onto a one-rank mesh, bitwise."""
    path = spawned_ckpts / f"ck_w{world}"
    meta = json.loads((path / "meta.json").read_text())
    assert meta["world"] == world and meta["n"] == CK_N
    rows = [np.load(path / f"rank{r}.npz")["pos"].shape[0]
            for r in range(world)]
    assert sum(rows) == CK_N  # the pads are not saved
    whole, step, _ = ckpt.load_sharded(path, device="cpu")
    assert step == 5 + world and _equal_states(whole, _ck_state())
    mesh = make_mesh((1,))
    back, _, _ = ckpt.load_sharded(path, mesh, pad_far=True)
    assert _equal_states(back, shard_state(_ck_state(), mesh, pad_far=True))


# ------------------------------------------------------------------ shmoo


def _rows():
    return [{"n": 4096, "backend": "sym_resident", "seconds": 2.6e-05,
             "ginteractions_per_s": 645.277, "per_device": 645.277,
             "gflops_20c": 12905.5, "roofline_frac": 0.0917},
            {"n": 262144, "backend": "sym", "seconds": 0.031,
             "ginteractions_per_s": 2216.7, "per_device": 2216.7,
             "gflops_20c": 44334.0, "roofline_frac": 0.4, "extra": 1}]


@pytest.mark.parametrize("fmt", ["to_csv", "to_jsonl"])
def test_shmoo_text_is_byte_identical_to_jax(fmt):
    assert getattr(shmoo, fmt)(_rows()) == getattr(jshmoo, fmt)(_rows())
    assert shmoo.FIELDS == jshmoo.FIELDS


@pytest.fixture
def card_timing(monkeypatch):
    """The harness's card timings and peaks, stood in for on the CPU: every
    step takes 2 ms, every resident step 10 us."""
    monkeypatch.setattr(harness, "chip_peaks", lambda name=None: H100)
    monkeypatch.setattr(harness, "time_step_fn",
                        lambda step, carry, reps=3, warmup=1: 2e-3)
    monkeypatch.setattr(shmoo, "time_resident",
                        lambda cfg, state, reps: 1e-5)


def test_shmoo_sweep_rows(card_timing):
    rows = shmoo.sweep(SimConfig(n=256, backend="torch"),
                       [256, 512], reps=1, device="cpu")
    assert [r["n"] for r in rows] == [256, 512]
    assert [r["backend"] for r in rows] == ["torch", "torch"]
    for r in rows:
        t = harness.Throughput(n=r["n"], steps=1, seconds=2e-3)
        assert r["roofline_frac"] == t.roofline_fraction("direct", H100)
        assert r["ginteractions_per_s"] == t.ginteractions_per_s
        assert "steps" not in r
    text = shmoo.to_csv(rows)
    assert text.splitlines()[0].startswith("n,backend,")
    assert len(text.splitlines()) == 3


def test_shmoo_sweep_follows_the_resident_route(card_timing, monkeypatch):
    import mini_nbody_tpu_torch.sim as tsim

    seen = []

    def route(cfg, steps, device):
        seen.append(steps)
        return cfg.n <= 128

    monkeypatch.setattr(tsim, "_route_resident", route)
    rows = shmoo.sweep(SimConfig(n=64, backend="sym_mxu"), [64, 256],
                       reps=1, device="cpu")
    assert [r["backend"] for r in rows] == ["sym_mxu_resident", "sym_mxu"]
    assert rows[0]["seconds"] == 1e-5
    assert seen == [shmoo.RESIDENT_STEPS] * 2
    assert min(tsim.RESIDENT_AUTO_MIN_STEPS.values()) <= \
        max(tsim.RESIDENT_AUTO_MIN_STEPS.values()) <= shmoo.RESIDENT_STEPS


def test_shmoo_sweep_refuses_cpu_timing():
    with pytest.raises(harness.NotOnCard):
        shmoo.sweep(SimConfig(n=64, backend="torch"), [64], reps=1,
                    device="cpu")


def test_shmoo_sweep_on_a_mesh(card_timing, one_rank):
    mesh = make_mesh((1,))
    rows = shmoo.sweep(SimConfig(n=96, mesh_shape=(1,)), [96], reps=1,
                       mesh=mesh)
    assert rows[0]["backend"] == "direct" and rows[0]["per_device"] == \
        rows[0]["ginteractions_per_s"]


# --------------------------------------------------------------- autotune


@pytest.fixture
def card_name(monkeypatch):
    """The autotune key's card name, stood in for on the CPU."""
    monkeypatch.setattr(autotune, "device_name",
                        lambda device="cuda": "NVIDIA_H100_80GB_HBM3")


def _fake_measure(table):
    calls = []

    def measure(cfg, reps):
        calls.append(cfg)
        key = (cfg.sym_tile if cfg.effective_backend() in ("sym", "sym_mxu")
               else cfg.tile_i)
        v = table[key]
        if isinstance(v, Exception):
            raise v
        return v

    return measure, calls


def test_key_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    key = autotune._key(SimConfig(n=3000, backend="sym", use_masses=True))
    assert key == ("NVIDIA_H100_80GB_HBM3|sym|mass|4096|float32|w1|auto")
    assert autotune._key(SimConfig(n=3000), ensemble=5).endswith("|ens8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NotOnCard):
        autotune._key(SimConfig(n=3000))
    with pytest.raises(harness.NotOnCard):
        autotune.device_name("cpu")


def test_cache_path_env(monkeypatch, tmp_path):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "t.json"))
    assert autotune.cache_path() == tmp_path / "t.json"
    monkeypatch.delenv(autotune.CACHE_ENV)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune.cache_path() == (tmp_path / "mini_nbody_tpu_torch"
                                     / "autotune.json")


def test_picks_fastest_sym_tile_and_caches(tmp_path, card_name):
    cfg = SimConfig(n=4096, backend="sym_mxu")
    table = {64: 3.0, 128: 1.0}
    measure, calls = _fake_measure(table)
    path = tmp_path / "tune.json"
    best = autotune.tune(cfg, measure=measure, path=path)
    assert best.sym_tile == 128 and len(calls) == len(autotune.SYM_TILES)
    # cache hit: no re-measure
    measure2, calls2 = _fake_measure(table)
    assert autotune.tune(cfg, measure=measure2, path=path).sym_tile == 128
    assert calls2 == []
    # a different bucket -> a fresh measurement
    autotune.tune(cfg.replace(n=65536), measure=measure2, path=path)
    assert len(calls2) == len(autotune.SYM_TILES)


def test_direct_tunes_rows_a_cta(tmp_path, card_name):
    measure, calls = _fake_measure({256: 2.0, 512: 1.5, 1024: 1.0})
    best = autotune.tune(SimConfig(n=4096, backend="direct"),
                         measure=measure, path=tmp_path / "t.json")
    assert best.tile_i == 1024
    assert [c.tile_i for c in calls] == list(autotune.DIRECT_TILES)


@pytest.mark.parametrize("backend", ["mxu", "torch"])
def test_nothing_to_tune_measures_the_config_once(tmp_path, card_name,
                                                  backend):
    cfg = SimConfig(n=4096, backend=backend, pair_dtype="bfloat16")
    calls = []

    def measure(c, reps):
        calls.append(c)
        return 1.0

    assert autotune.tune(cfg, measure=measure, path=tmp_path / "t.json") \
        == cfg
    assert calls == [cfg]


def test_a_refused_shape_is_recorded(tmp_path, card_name):
    cfg = SimConfig(n=4096, backend="sym")
    measure, _ = _fake_measure({64: ValueError("tile 64 refused"),
                                128: 1.0})
    path = tmp_path / "t.json"
    assert autotune.tune(cfg, measure=measure, path=path).sym_tile == 128
    results = json.loads(path.read_text())[autotune._key(cfg)]["results"]
    assert any(v == "failed: tile 64 refused" for v in results.values())


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: launch failed"),
                                 OSError("nvcc failed")])
def test_other_failures_propagate(tmp_path, card_name, exc):
    measure, _ = _fake_measure({64: 1.0, 128: exc})
    with pytest.raises(type(exc), match=str(exc)):
        autotune.tune(SimConfig(n=4096, backend="sym"), measure=measure,
                      path=tmp_path / "t.json")
    assert not (tmp_path / "t.json").exists()


def test_all_candidates_refused_raises(tmp_path, card_name):
    measure, _ = _fake_measure({t: ValueError("no")
                                for t in autotune.SYM_TILES})
    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.tune(SimConfig(n=4096, backend="sym"), measure=measure,
                      path=tmp_path / "t.json")


def test_chunk_phase_when_n_spans_chunks(tmp_path, card_name):
    seen = []

    def measure(cand, reps):
        seen.append((cand.sym_tile, cand.sym_chunk))
        base = {64: 2.0, 128: 1.0}[cand.sym_tile]
        return base * (0.9 if cand.sym_chunk == 262144 else 1.0)

    best = autotune.tune(SimConfig(n=262144, backend="sym_mxu"),
                         measure=measure, path=tmp_path / "t.json")
    assert (best.sym_tile, best.sym_chunk) == (128, 262144)
    assert seen == [(64, None), (128, None), (128, 262144)]


def test_resident_config_sweeps_resident_tile_only(tmp_path, card_name):
    seen = []

    def measure(cand, reps):
        assert cand.resident
        seen.append(cand.resident_tile)
        return {64: 2.0, 128: 1.0}[cand.resident_tile]

    best = autotune.tune(SimConfig(n=4096, backend="sym_mxu", resident=True),
                         measure=measure, path=tmp_path / "t.json")
    assert best.resident_tile == 128 and seen == list(RESIDENT_TILES)


def test_backward_phase_and_cache(tmp_path, card_name):
    cfg = SimConfig(n=4096, backend="sym")

    def measure(cand, reps):
        return {64: 3.0, 128: 1.0}[cand.sym_tile]

    def measure_bwd(cand, reps):
        return {64: 1.0, 128: 2.0}[cand.sym_bwd_tile]

    path = tmp_path / "t.json"
    best = autotune.tune(cfg, measure=measure, path=path, backward=True,
                         measure_bwd=measure_bwd)
    assert best.sym_tile == 128 and best.sym_bwd_tile == 64
    assert [t for t in SYM_BWD_TILES] == [64, 128]

    def boom(*_):
        raise AssertionError("cache miss")

    assert autotune.tune(cfg, measure=boom, path=path, backward=True,
                         measure_bwd=boom).sym_bwd_tile == 64
    # an explicit user override survives the cache hit
    assert autotune.tune(cfg.replace(sym_bwd_tile=128), measure=boom,
                         path=path, backward=True).sym_bwd_tile == 128


def test_apply_cached_applies_family_fields_only():
    params = {"sym_tile": 64, "sym_chunk": 262144, "tile_i": 1024,
              "tile_j": 2048, "sym_bwd_tile": 64, "resident_tile": 128}
    cfg = SimConfig(n=4096, backend="sym", sym_chunk=65536)
    got = autotune._apply_cached(cfg, params)
    assert (got.sym_tile, got.sym_chunk, got.tile_i) == (64, 65536, 512)
    assert autotune._apply_cached(SimConfig(n=4096, backend="direct"),
                                  params).tile_i == 1024


def test_sym_tile_threads_into_the_kernel():
    state = _cpu_state(256, seed=2, masses=False)
    cfg = SimConfig(n=256, backend="sym", softening=1e-2, sym_tile=64,
                    sym_chunk=128)
    f = make_force_fn(cfg)(state.pos, state.pos, None)
    ref = body_force_torch(state.pos.double(), state.pos.double(),
                           softening=1e-2)
    np.testing.assert_allclose(f.double().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5 * ref.abs().max().item())


def test_ensemble_sweeps_streamed_and_resident_head_to_head(tmp_path,
                                                            card_name):
    cfg = SimConfig(n=1024, backend="sym_mxu")
    seen = []

    def measure(cand, b, reps):
        assert b == 8
        if cand.resident:
            seen.append(("res", cand.resident_tile))
            return {64: 2.0, 128: 0.5}[cand.resident_tile]
        seen.append(("str", cand.sym_tile))
        return 1.0

    path = tmp_path / "t.json"
    best = autotune.tune_ensemble(cfg, 8, measure=measure, path=path)
    assert best.resident is True and best.resident_tile == 128
    assert seen == [("str", t) for t in autotune.ENSEMBLE_TILES] + [
        ("res", t) for t in RESIDENT_TILES]

    def boom(*_):
        raise AssertionError("cache miss")

    best2 = autotune.tune_ensemble(cfg, 8, measure=boom, path=path)
    assert best2.resident is True and best2.resident_tile == 128
    calls = []
    autotune.tune_ensemble(cfg, 512, measure=lambda c, b, r:
                           calls.append(c) or 1.0, path=path)
    assert calls  # another B bucket: measured again


def test_ensemble_streamed_win_pins_resident_false(tmp_path, card_name):
    def measure(cand, b, reps):
        if cand.resident:
            return 2.0
        return 0.5 if cand.sym_tile == 64 else 1.0

    best = autotune.tune_ensemble(SimConfig(n=1024, backend="sym"), 8,
                                  measure=measure, path=tmp_path / "t.json")
    assert best.resident is False and best.sym_tile == 64


@pytest.mark.parametrize("n,b,integrator,want_resident", [
    (16384, 64, "euler", False),     # B Np over RESIDENT_SYM_MAX_N
    (1024, 8, "rk4", False),         # no resident rk4
    (1024, 8, "leapfrog", True)])
def test_ensemble_resident_candidates_are_admissible(tmp_path, card_name, n,
                                                     b, integrator,
                                                     want_resident):
    seen = []

    def measure(cand, bb, reps):
        seen.append(bool(cand.resident))
        return 1.0

    autotune.tune_ensemble(SimConfig(n=n, backend="sym_mxu",
                                     integrator=integrator), b,
                           measure=measure, path=tmp_path / "t.json")
    assert any(seen) == want_resident


def test_cached_rate(tmp_path, card_name):
    cfg = SimConfig(n=65536, backend="sym_mxu")
    path = tmp_path / "t.json"
    assert autotune.cached_rate(cfg, path=path) is None
    autotune.tune(cfg, measure=lambda c, r: 1e-2, path=path)
    assert autotune.cached_rate(cfg, path=path) == pytest.approx(
        65536.0 ** 2 / 1e-2 / 1e9)
