"""Force passes a gradient runs beyond those the problem needs: the
program's nbody.force spans (one a pass, recomputed passes included) per
timed call less the problem's passes (spans.py, work.problem)."""

from portbench import spans


def read(r):
    per_call = spans.force_spans_per_call(r)
    if per_call is None:
        return None
    return per_call - r.problem["passes"]
