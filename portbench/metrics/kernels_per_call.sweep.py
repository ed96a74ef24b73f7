"""Device operations per timed call (every kernel, copy and set)."""


def read(r):
    return r.trace.ops_count() / r.calls
