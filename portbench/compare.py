"""The numbers a check compares, each a float64 ratio."""

from __future__ import annotations

import torch


def worst_row(got, want, base) -> float:
    """The largest row distance |got - want| over the median row length of
    base (the change the reference made over the call): the worst body,
    measured against a typical one's change. Non-finite reads inf."""
    got, want, base = got.double(), want.double(), base.double()
    gap = (got - want).norm(dim=-1).max()
    scale = base.norm(dim=-1).median()
    value = (gap / scale).item()
    return value if value == value else float("inf")


def quantile_row(got, want, base, q: float) -> float:
    """The q-quantile of the row distances |got - want| over the median row
    length of base: q = 0.99 reads the 1%-worst body, so a fault on more
    than 1% of the rows shows however few bodies sit in a chaotic tail."""
    got, want, base = got.double(), want.double(), base.double()
    gap = torch.quantile((got - want).norm(dim=-1), q)
    value = (gap / base.norm(dim=-1).median()).item()
    return value if value == value else float("inf")


def relative_gap(got: float, want: float) -> float:
    """|got - want| / |want| (0 where both are 0)."""
    got, want = float(got), float(want)
    if got == want:
        return 0.0
    value = abs(got - want) / abs(want) if want else float("inf")
    return value if value == value else float("inf")


def mismatches(a, b) -> int:
    """Elements that differ bit for bit (NaNs count as differing)."""
    return int((a != b).sum().item())
