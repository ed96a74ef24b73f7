"""Run one cell of BENCHMARK.json once, on the machine it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The run makes its inputs on the card from the
seed, warms up the cell's own shapes (set-up, timed from process start to
the first timed call), then makes timed calls for ``--seconds`` seconds,
each awaited before the next, and reports over the window's whole time.
With ``--trace 1`` the same run profiles ``trace.calls`` calls after the
first ``trace.after`` and reports the cell's per-layer metrics, read from
that trace by ``metrics/<name>.py``, in place of the end-to-end ones.
After the window the program's state is freed and its outputs are held to
the plain reference (``traffic/<kind>.py``'s check, with the limits of
``workloads/<cell>.json``). The last line of standard output is one JSON
object; the numbers compared, each beside its limit, end both it and
standard error.

``--control`` puts the configuration's control in the program's place (the
tests and the setting of limits use it; the benchmark's own runs do not).
Without a CUDA card, or with fewer cards than the cell asks for, the run
exits with code 3 and prints no result; so it does if, once the window has
closed, JAX, jaxlib, flax or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Build and kernel caches at fixed places inside the checkout, so that only
# a checkout's first run builds (the port's own library goes to
# build/mini_nbody_tpu_torch/ beside the package).
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)

if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "mini_nbody_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden (the port's
    ``mini_nbody_tpu_torch`` only begins with one)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, section: str):
    """The metrics of ``section`` that the cell reports."""
    return [m for m in bench[section]
            if name in m.get("workloads", [name])]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nvidia_smi() -> str:
    """The card's name, clocks, power and power limit, or why not."""
    query = ("name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable: {exc}"
    return out.stdout.strip() or f"unavailable: {out.stderr.strip()}"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             workload_overrides=None, driver_hook=None) -> dict:
    """One run of cell ``name``; returns the result (without printing).
    The tests run it on the CPU at small sizes (``workload_overrides``)
    and break the program underneath with ``driver_hook(driver)``."""
    import torch
    from torch.profiler import record_function

    from portbench import profiling, work

    marks = {"import_torch": time.perf_counter() - T_START}

    bench = load_json(ROOT / "BENCHMARK.json")
    entry = cell_entry(bench, name)
    wl = load_json(HERE / "workloads" / f"{name}.json")
    wl.update(workload_overrides or {})
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
    marks["device"] = time.perf_counter() - T_START

    def sync():
        if on_card:
            torch.cuda.synchronize()

    traffic = load_module(HERE / "traffic" / f"{wl['kind']}.py",
                          f"portbench.traffic.{wl['kind']}")
    driver = traffic.Driver(config, wl, seed, device, control=control)
    sync()
    marks["inputs"] = time.perf_counter() - T_START
    if driver_hook is not None:
        driver_hook(driver)
    span = f"portbench.{wl['kind']}.call"

    def call(i):
        with record_function(span):
            driver.call(i)

    driver.warm_up()
    sync()
    setup_s = time.perf_counter() - T_START

    spec = wl["trace"] if trace else None
    calls, captured = 0, None
    t0 = time.perf_counter()
    while True:
        if spec is not None and captured is None and calls == spec["after"]:
            first = calls

            def traced():
                for k in range(spec["calls"]):
                    call(first + k)

            captured = profiling.profile_calls(traced)
            calls += spec["calls"]
        else:
            call(calls)
            calls += 1
        sync()
        window_s = time.perf_counter() - t0
        if (window_s >= seconds and calls >= driver.min_calls
                and (spec is None or captured is not None)):
            break
    smi = nvidia_smi() if on_card else "cpu run"
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    problem = work.problem(config, wl)
    metrics, extra = {}, {}
    if spec is None:
        e2e = wl["e2e"]
        units = {"interactions": problem["interactions"],
                 "systems": wl.get("systems", 1), "calls": 1}[e2e["per_call"]]
        done = calls * units
        values = {"setup_s": setup_s,
                  e2e["name"]: (done * e2e["scale"] / window_s
                                if e2e["form"] == "rate"
                                else window_s / done)}
        for m in cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        reading = profiling.Reading(captured, spec["calls"], problem)
        for m in cell_metrics(bench, name, "per_layer"):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"portbench.metrics.{m['name']}")
            value = reader.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": captured.busy_s, "window_s": captured.window_s}

    driver.release()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    values = driver.check()
    checks = {k: {"value": values.pop(k), "limit": lim}
              for k, lim in wl["limits"].items()}
    failed = [k for k, c in checks.items()
              if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]
    result = {
        "correct": not failed,
        "attempted": calls,
        "failed": len(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": entry["chips"], "memory_peak_bytes": peak,
                   **extra},
    }
    if spec is not None:
        result["breakdown"] = captured.breakdown()
    result["window"] = {"seconds": window_s, "calls": calls, "seed": seed,
                        "setup_s": setup_s, "nvidia_smi": smi,
                        "control": control, "setup_marks": marks,
                        "not_compared": values}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's control in the program's "
                         "place (for setting limits; never a benchmark run)")
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = cell_entry(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), control=args.control)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
