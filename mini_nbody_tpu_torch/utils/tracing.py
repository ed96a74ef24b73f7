"""Profiling and tracing.

Counterpart of ``mini_nbody_tpu/utils/tracing.py:27-74``:

* ``profile_trace``: a ``torch.profiler`` trace (CPU activity, and the
  card's kernels when ``device`` is CUDA) around a block, written into
  ``logdir`` as a Chrome trace (chrome://tracing or Perfetto).
* ``annotate``: a named span. While a profiler records (``profile_trace``,
  any ``torch.profiler.profile``, or ``torch.autograd.profiler.emit_nvtx()``
  under Nsight, which turns the same ranges into NVTX ranges) it is a
  ``record_function`` range, in the same trace as the card's kernels and on
  the same clock; otherwise it costs one check of the profiler's state.
* ``count`` / ``counters``: the program's one counter registry (kernel
  launches ``launch.<kernel>[.<mode>]``, route decisions ``route.*``,
  duplicate scans ``coincident.scan``), read as a snapshot.
* ``StepMetrics``: per-interval throughput rows for a long run, JAX's
  fields and rows.

PERF.md lists every span and counter with what reads it.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mini_nbody_tpu_torch.utils.harness import NotOnCard

#: The file profile_trace writes into its logdir.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(logdir: str, device="cuda"):
    """Trace the block into ``logdir``/TRACE_FILE; yields the profiler
    (``key_averages()`` for sums by kernel). device "cuda" (the default)
    also traces the card's kernels and raises without one; "cpu" traces the
    host only."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise NotOnCard("profile_trace traces a CUDA card; none found "
                            "(pass device='cpu')")
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_FILE))


class annotate:
    """``with annotate(name):`` a named span in the profiler's trace while
    a profiler records; with none recording, nothing but that check (no
    ``record_function``, whose bare enter and exit cost microseconds)."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


_profiler_enabled = torch._C._autograd._profiler_enabled

#: The counter registry: name -> count since the process started. The
#: autograd engine's device threads count too, hence the lock.
_COUNTS: Counter = Counter()
_LOCK = threading.Lock()


def count(name: str, k: int = 1):
    """Add k to counter ``name``."""
    with _LOCK:
        _COUNTS[name] += k


def counters() -> Counter:
    """A snapshot copy of every counter; the difference of two snapshots
    (``after - before``) is what ran between them."""
    with _LOCK:
        return Counter(_COUNTS)


@dataclass
class StepMetrics:
    """Accumulates per-interval throughput rows for a long run. Kernels
    run asynchronously: the caller synchronizes the card (e.g.
    ``torch.cuda.synchronize()``) before each ``tick``, or the interval
    measures the enqueue."""

    n: int
    n_devices: int = 1
    rows: List[dict] = field(default_factory=list)
    _t0: Optional[float] = None
    _steps_done: int = 0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def tick(self, steps: int, **extra):
        """Record an interval of `steps` integration steps just completed.
        Call after a device sync. Extra kwargs (energy, drift...) are stored."""
        now = time.perf_counter()
        dt = now - (self._t0 if self._t0 is not None else now)
        self._t0 = now
        self._steps_done += steps
        row = {
            "step": self._steps_done,
            "wall_s": round(dt, 6),
            "ginteractions_per_s": round(
                float(self.n) ** 2 * steps / max(dt, 1e-12) / 1e9, 3
            ),
            **extra,
        }
        self.rows.append(row)
        return row

    def jsonl(self) -> str:
        return "\n".join(json.dumps(r) for r in self.rows)
