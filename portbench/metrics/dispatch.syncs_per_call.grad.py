"""Host waits for the device (the CUDA runtime's cuda*Synchronize calls)
that start inside one of the program's nbody.* spans, per timed call
(spans.py)."""

from portbench import spans


def read(r):
    return spans.syncs_per_call(r)
