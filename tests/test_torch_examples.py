"""The port's demos (examples/torch/), its entry points
(mini_nbody_tpu_torch/entry.py) and its import boundary, on the CPU.

Each demo runs end to end at a tiny size with ``--cpu`` (the markers of
JAX's tests/test_examples.py and test_cli.py); ``dryrun_multichip`` runs its
gloo ranks; ``entry()`` gives JAX's step at N = 16,384. One test reads the
port, its demos and chip_smoke.py for any import of jax or of the JAX
package: the card machine has no JAX.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"


def _run(script, *args, timeout=300):
    # One thread each: the suite runs several workers at once.
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / script), "--cpu", *args],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    return out.stdout


def test_cold_collapse_quick():
    out = _run("cold_collapse.py", "--n", "128", "--steps", "20",
               "--interval", "10")
    assert '"drift"' in out and '"virial"' in out


def test_infer_masses_quick():
    # 120 Adam iterations at n=16 converge well past the script's 5% gate
    out = _run("infer_masses.py", "--n", "16", "--steps", "10", "--iters",
               "120")
    assert out.strip().endswith("OK")


def test_optimize_impact_quick():
    out = _run("optimize_impact.py", "--n", "48", "--steps", "10",
               "--iters", "25")
    assert '"miss_distance"' in out


def test_parameter_sweep_quick():
    # steps=200 kept: the contraction / expansion trend the script asserts
    # needs the free-fall time; n and B shrunk.
    out = _run("parameter_sweep.py", "--b", "4", "--n", "64", "--steps",
               "200")
    assert '"sweep_trend": "ok"' in out and '"device": "cpu"' in out


def test_reference_envelope_quick():
    out = _run("reference_envelope.py", "--quick")
    assert "leapfrog drift" in out and "GInter/s on cpu" in out


def test_multihost_cpu():
    out = _run("multihost_cpu.py")
    assert "multihost OK: 2 processes" in out


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip(n_ranks):
    from mini_nbody_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(n_ranks)


def test_entry_step_on_the_cpu():
    from mini_nbody_tpu_torch import SimConfig
    from mini_nbody_tpu_torch.entry import entry
    from mini_nbody_tpu_torch.sim import make_step_fn

    step, (carry,) = entry(device="cpu")
    state, acc = carry
    assert state.pos.shape == (16384, 3) and torch.equal(
        acc, torch.zeros_like(state.pos))
    out, _ = step((state.unpad(512), acc[:512]))
    want, _ = make_step_fn(SimConfig(n=512))((state.unpad(512), acc[:512]))
    assert torch.equal(out.pos, want.pos)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("where", ["mini_nbody_tpu_torch", "examples/torch",
                                   "chip_smoke.py"])
def test_no_jax_import(where):
    paths = ([ROOT / where] if where.endswith(".py")
             else sorted((ROOT / where).rglob("*.py")))
    assert paths
    bad = [(str(p.relative_to(ROOT)), m) for p in paths for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "mini_nbody_tpu")]
    assert bad == []
