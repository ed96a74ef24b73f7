"""Milliseconds of the slot-order sums (layers/reduction.json) per
force pass the problem needs."""


def read(r):
    seconds = r.layer_seconds("reduction")
    if seconds <= 0.0:
        return None
    return 1e3 * seconds / (r.problem["passes"] * r.calls)
