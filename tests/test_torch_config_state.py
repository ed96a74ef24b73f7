"""Port (mini_nbody_tpu_torch) vs JAX package: SimConfig validation and
from_dict, BodyState padding and numpy round trips, uniform_random by
distribution, and the port's import staying free of JAX."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mini_nbody_tpu.models.state import BodyState as JBodyState
from mini_nbody_tpu.ops.pallas_compat import fast_rsqrt_cube as j_fast
from mini_nbody_tpu.utils import config as jconfig
from mini_nbody_tpu_torch import BodyState, SimConfig, body_force, init
from mini_nbody_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = ("import sys, mini_nbody_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'mini_nbody_tpu' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_constants_match():
    assert tconfig.SOFTENING == jconfig.SOFTENING
    assert tconfig.DT == jconfig.DT
    assert tconfig.FAR == jconfig.FAR
    assert tconfig.COINCIDENT_MODES == jconfig.COINCIDENT_MODES
    for x, m in [(0, 8), (1, 8), (8, 8), (9, 128), (300, 64)]:
        assert tconfig.round_up(x, m) == jconfig.round_up(x, m)
    for s in (1e-9, 1e-12, 1e-13, 1e-2):
        assert tconfig.fast_rsqrt_cube(s) == j_fast(s)


@pytest.mark.parametrize("kw", [
    dict(n=0), dict(n=-3), dict(integrator="verlet"), dict(tile_i=7),
    dict(tile_j=100), dict(coincident="sometimes"), dict(traversal="zigzag"),
    dict(comm="mesh"), dict(backend="cuda"),
    dict(comm="grid", mesh_shape=(4,)), dict(comm="ring", mesh_shape=(2, 2)),
    dict(mesh_shape=(2, 2)),
    dict(resident=True, mesh_shape=(2,)),
])
def test_validation_mirrors_jax(kw):
    kw = {"n": 64, **kw}
    with pytest.raises(ValueError):
        jconfig.SimConfig(**kw)
    with pytest.raises(ValueError):
        SimConfig(**kw)


def test_fused_integrate_needs_one_card():
    # JAX's rule (backend 'pallas' there, 'direct' here).
    for cfg, kw in ((jconfig.SimConfig, dict(backend="pallas")),
                    (SimConfig, dict(backend="direct"))):
        cfg(n=64, fused_integrate=True, **kw)
        with pytest.raises(ValueError, match="single"):
            cfg(n=64, fused_integrate=True, mesh_shape=(2,), **kw)


@pytest.mark.parametrize("kw", [
    dict(backend="sym_mxu", traversal="band"), dict(traversal="band"),
])
def test_unported_options_raise(kw):
    # traversal='band' is ported (B16, tests/test_torch_band.py): what JAX
    # accepts, the port accepts; an unknown traversal raises in both.
    jcfg = jconfig.SimConfig(n=64, **kw)
    cfg = SimConfig(n=64, **kw)
    assert (cfg.backend, cfg.traversal) == (jcfg.backend, jcfg.traversal)
    for make in (jconfig.SimConfig, SimConfig):
        with pytest.raises(ValueError, match="traversal"):
            make(n=64, traversal="rows")


@pytest.mark.parametrize("kw", [
    dict(comm="ring_sym"), dict(mesh_shape=(2,)), dict(comm="ring"),
    dict(mesh_shape=(2, 2), comm="grid"), dict(comm="grid"),
])
def test_sharding_options_accepted(kw):
    # The sharded path is ported (parallel/): what JAX accepts, the port
    # accepts, field for field.
    jcfg = jconfig.SimConfig(n=64, **kw)
    cfg = SimConfig(n=64, **kw)
    assert (cfg.mesh_shape, cfg.comm) == (jcfg.mesh_shape, jcfg.comm)


def test_auto_is_direct_under_sharding():
    # JAX: auto stays on its ordered kernel under sharding (pallas, not
    # sym); the port's ordered kernel is 'direct'.
    cfg = SimConfig(n=64, mesh_shape=(2,))
    assert cfg.effective_backend() == "sym"
    assert cfg.effective_backend(sharded=True) == "direct"
    assert cfg.replace(backend="sym_mxu").effective_backend(
        sharded=True) == "sym_mxu"


@pytest.mark.parametrize("jax_backend,port_backend", [
    ("auto", "auto"), ("jnp", "torch"), ("pallas", "direct"),
    ("sym_mxu", "sym_mxu"), ("sym", "sym"),
])
def test_from_dict_maps_backends(jax_backend, port_backend):
    jcfg = jconfig.SimConfig(
        n=300, dt=0.005, steps=7, softening=1e-2, integrator="leapfrog",
        backend=jax_backend, tile_i=256, tile_j=1024, sym_tile=64,
        sym_chunk=128, use_masses=True, split_w=True, coincident="masked",
        traversal="slots", resident=False, interpret=True)
    cfg = SimConfig.from_dict(dataclasses.asdict(jcfg))
    assert cfg.backend == port_backend
    for f in dataclasses.fields(cfg):
        if f.name != "backend":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("kw", [dict(traversal="band"),
                                dict(resident_tile=512)])
def test_from_dict_rejects_unported(kw):
    # pair_dtype, backend "mxu", resident, resident_tile and the band
    # traversal are ported (test_torch_mxu_force.py, test_torch_resident.py,
    # test_torch_band.py); a resident tile the card kernel is not built for
    # is refused as sym_bwd_tile's are.
    d = dataclasses.asdict(jconfig.SimConfig(n=8, **kw))
    if "resident_tile" in kw:
        with pytest.raises(ValueError):
            SimConfig.from_dict(d)
    else:
        assert SimConfig.from_dict(d).traversal == "band"


def test_from_dict_maps_mesh():
    # JAX keeps mesh_shape as a tuple (a list after a JSON round trip).
    d = dataclasses.asdict(jconfig.SimConfig(n=8, mesh_shape=(2, 4),
                                             comm="grid"))
    d["mesh_shape"] = list(d["mesh_shape"])
    cfg = SimConfig.from_dict(d)
    assert cfg.mesh_shape == (2, 4) and cfg.comm == "grid"


def test_auto_resolves_by_device(monkeypatch):
    # 'auto' is 'sym' on every device, as JAX's single-chip auto; it never
    # asks whether a card is present.
    def no_probe():
        raise AssertionError("auto must not look for a card")

    monkeypatch.setattr(torch.cuda, "is_available", no_probe)
    cfg = SimConfig(n=8)
    assert cfg.effective_backend() == "sym" == tconfig.AUTO_BACKEND
    assert SimConfig(n=8, backend="sym_mxu").effective_backend() == "sym_mxu"
    assert cfg.replace(backend="direct").effective_backend() == "direct"
    p = torch.from_numpy(_np_state(40)[0])
    assert torch.equal(body_force(p, p, backend="auto"),
                       body_force(p, p, backend="sym"))


def _np_state(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


@pytest.mark.parametrize("far", [False, True])
def test_pad_unpad_match_jax(far):
    pos, vel, mass = _np_state(100)
    j = JBodyState.create(pos, vel, mass).pad_to(128, far=far)
    t = BodyState.from_numpy(pos, vel, mass, device="cpu").pad_to(128,
                                                                   far=far)
    assert t.n == j.n == 128
    for a, b in zip(t.to_numpy(), (j.pos, j.vel, j.mass)):
        np.testing.assert_array_equal(a, np.asarray(b))
    u = t.unpad(100)
    for a, b in zip(u.to_numpy(), (pos, vel, mass)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        t.pad_to(64)


def test_create_defaults_and_validation():
    pos, vel, _ = _np_state(16)
    s = BodyState.create(pos, vel, device="cpu")
    j = JBodyState.create(pos, vel)
    np.testing.assert_array_equal(s.mass.numpy(), np.asarray(j.mass))
    assert s.dtype == torch.float32 and s.device.type == "cpu"
    for bad in [dict(pos=pos[:, :2], vel=vel[:, :2]),
                dict(pos=pos, vel=vel[:8]),
                dict(pos=pos, vel=vel, mass=np.ones(3, np.float32))]:
        with pytest.raises(ValueError):
            JBodyState.create(**bad)
        with pytest.raises(ValueError):
            BodyState.create(**bad, device="cpu")


def test_numpy_round_trip_from_jax_state():
    pos, vel, mass = _np_state(33, seed=5)
    j = JBodyState.create(pos, vel, mass)
    t = BodyState.from_numpy(np.asarray(j.pos), np.asarray(j.vel),
                             np.asarray(j.mass), device="cpu")
    for a, b in zip(t.to_numpy(), (pos, vel, mass)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_uniform_random_distribution():
    # Same distribution as the JAX initializer (tests/test_models.py), not
    # the same stream: torch.Generator and jax.random differ.
    s = init.uniform_random(4096, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    for arr in (s.pos, s.vel):
        a = arr.numpy()
        assert a.min() >= -1.0 and a.max() <= 1.0
        assert abs(a.mean()) < 0.02
        assert abs(a.var() - 1 / 3) < 0.02
    assert torch.all(s.mass == 1.0)
    again = init.uniform_random(4096,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    assert torch.equal(s.pos, again.pos) and torch.equal(s.vel, again.vel)
    jax_pos = np.asarray(jax.random.uniform(jax.random.key(0), (4096, 3),
                                            minval=-1.0, maxval=1.0))
    assert abs(jax_pos.mean() - s.pos.numpy().mean()) < 0.03


def _raises_without_a_card(call):
    """The entry point targets the card: it lands there, or, where there is
    no card, PyTorch's own error stops it (never a silent CPU run)."""
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


@pytest.mark.parametrize("entry", [
    "uniform_random", "plummer", "cold_sphere", "two_cluster", "create",
    "from_numpy"])
def test_entry_points_default_to_the_card(entry):
    pos, vel, mass = _np_state(8)
    calls = {
        "create": lambda: BodyState.create(pos, vel, mass),
        "from_numpy": lambda: BodyState.from_numpy(pos, vel, mass),
    }
    call = calls.get(entry) or (lambda: getattr(init, entry)(8))
    _raises_without_a_card(call)


@pytest.mark.parametrize("kw", [
    dict(fused_integrate=True, backend="direct", integrator="leapfrog"),
    dict(fused_integrate=True, backend="auto"),
    dict(fused_integrate=True, backend="sym"),
])
def test_fused_integrate_rule_mirrors_jax(kw):
    jkw = dict(kw, backend={"direct": "pallas"}.get(kw["backend"],
                                                      kw["backend"]))
    with pytest.raises(ValueError):
        jconfig.SimConfig(n=64, **jkw)
    with pytest.raises(ValueError):
        SimConfig(n=64, **kw)
    ok = SimConfig(n=64, fused_integrate=True, backend="direct")
    assert SimConfig.from_dict(dataclasses.asdict(jconfig.SimConfig(
        n=64, fused_integrate=True, backend="pallas"))) == ok
