"""Milliseconds of rank 0's device time in the kernels of the program's
collectives (layers/collectives.json: NCCL's all-gather, reduce-scatter and
send-receive kernels, not the benchmark's own broadcast of each call's
phase) per timed call; None where none ran."""


def read(r):
    seconds = r.layer_seconds("collectives")
    if seconds <= 0.0:
        return None
    return 1e3 * seconds / r.calls
