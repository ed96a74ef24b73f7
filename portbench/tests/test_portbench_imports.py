"""What the benchmark loads: never JAX, jaxlib, flax or the JAX package
(compared by whole top-level name, since the port's name begins with the
JAX package's), and no part of the port in the reference."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"


def loaded_top_names(code: str) -> set:
    """Top-level names of every module a fresh interpreter holds after
    running ``code`` from the repository's root."""
    script = ("import sys\n" + code + "\n"
              "print(' '.join(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def module_files(sub: str):
    return sorted((PB / sub).glob("*.py"))


def loader(path: Path) -> str:
    return ("import importlib.util\n"
            f"s = importlib.util.spec_from_file_location('m', {str(path)!r})\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))")


def test_run_and_every_traffic_metric_and_reference_module_load_no_jax():
    code = ["sys.path.insert(0, '.')",
            "import portbench.run, portbench.profiling, portbench.work",
            "import portbench.inputs, portbench.compare"]
    for sub in ("traffic", "reference"):
        for f in module_files(sub):
            if f.stem != "__init__":
                code.append(f"import portbench.{sub}.{f.stem}")
    for f in module_files("metrics"):
        code.append(loader(f))
    # the traffic modules import the port when a driver is built: load it
    code.append("import mini_nbody_tpu_torch, mini_nbody_tpu_torch.sim")
    names = loaded_top_names("\n".join(code))
    assert "mini_nbody_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "mini_nbody_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_top_names(
        "sys.path.insert(0, '.')\n"
        "import portbench.reference.force, portbench.reference.integrate\n"
        "import portbench.inputs, portbench.compare, portbench.work")
    assert "mini_nbody_tpu_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "mini_nbody_tpu"}


@pytest.mark.parametrize("names,found", [
    (["mini_nbody_tpu_torch", "mini_nbody_tpu_torch.sim", "torch"], []),
    (["jax._src.core", "numpy"], ["jax"]),
    (["mini_nbody_tpu", "flax.linen"], ["flax", "mini_nbody_tpu"]),
])
def test_the_guard_compares_whole_top_level_names(monkeypatch, names,
                                                  found):
    from portbench import run

    fake = {n: object() for n in names}
    monkeypatch.setattr(run.sys, "modules", fake)
    assert run.forbidden_modules() == found


def test_without_a_card_a_run_exits_3_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mininbody-fp32.sweep4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp",
                          "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr
