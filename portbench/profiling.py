"""The traced stretch of a window: torch.profiler over a few timed calls,
and what the per-layer metrics read from its Chrome trace.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. The traced window is the benchmark's own span
``portbench.window`` around the calls; the device is busy where the union
of its operations covers the window, idle elsewhere. An idle gap is named
by the innermost host event (the benchmark's spans, PyTorch operators,
CUDA runtime calls) that covers its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
LAYERS_DIR = Path(__file__).resolve().parent / "layers"


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and its namespace."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0][:160]


class Trace:
    """The device operations and host events of one traced stretch."""

    def __init__(self, events):
        span = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW_SPAN]
        if not span:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
        self.t0 = float(span[0]["ts"])
        self.t1 = self.t0 + float(span[0]["dur"])
        self.ops = []  # (name, start us, end us), clipped to the window
        self.host = []  # (start us, end us, name)
        for e in events:
            if e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if e.get("cat") in DEVICE_CATS:
                a, b = max(ts, self.t0), min(ts + dur, self.t1)
                if b > a:
                    self.ops.append((e["name"], a, b))
            elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN:
                self.host.append((ts, ts + dur, e["name"]))
        self.ops.sort(key=lambda o: o[1])
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self):
        merged = []
        for _, a, b in self.ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def gaps(self):
        """Idle intervals (start us, end us) inside the window."""
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_at(self, t: float) -> str:
        """The host event covering t with the latest start: the innermost
        of nested events."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(-1, i - 4096), -1):
            if self.host[j][1] >= t:
                return self.host[j][2]
        return "host (no traced event)"

    def ops_seconds(self, patterns=None) -> float:
        """Device seconds of the operations whose name matches one of the
        regular expressions ``patterns`` (all operations when None)."""
        rx = None if patterns is None else re.compile("|".join(patterns))
        return sum(b - a for name, a, b in self.ops
                   if rx is None or rx.search(name)) / 1e6

    def ops_count(self) -> int:
        return len(self.ops)

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(float)
        for name, a, b in self.ops:
            by_op[short_name(name)] += (b - a) / 1e6
        by_host = defaultdict(float)
        for a, b in self.gaps():
            by_host[self.host_at(0.5 * (a + b))] += (b - a) / 1e6
        pick = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(by_op), "idle_gaps": pick(by_host)}


def layer_patterns(layer_file: str):
    """The kernel-name patterns of ``layers/<layer_file>.json``."""
    with open(LAYERS_DIR / f"{layer_file}.json") as f:
        return json.load(f)["patterns"]


def profile_calls(run_calls) -> Trace:
    """Run ``run_calls()`` under torch.profiler inside the window span and
    return the trace; the Chrome trace goes to a temporary file under
    TMPDIR, removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            run_calls()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)


class Reading:
    """What a per-layer metric's reader gets: the trace of ``calls`` timed
    calls and the problem's work of one call (``work.problem``)."""

    def __init__(self, trace: Trace, calls: int, problem: dict):
        self.trace, self.calls, self.problem = trace, calls, problem

    def layer_seconds(self, layer_file: str) -> float:
        return self.trace.ops_seconds(layer_patterns(layer_file))

    def roofline(self, layer_file: str, work_key: str):
        """Percent: the bound time of the problem's ``work_key`` work over
        the layer's device seconds; None where the layer ran nothing."""
        seconds = self.layer_seconds(layer_file)
        if seconds <= 0.0:
            return None
        bound = self.problem[work_key].bound_s() * self.calls
        return 100.0 * bound / seconds

    def idle(self):
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def step_mfu(self):
        """Percent: the bound time of the calls' whole problem over the
        traced window's seconds."""
        bound = self.problem["step"].bound_s() * self.calls
        return 100.0 * bound / self.trace.window_s
