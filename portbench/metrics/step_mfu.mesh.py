"""Percent: this card's share of the traced calls' whole problem (the
problem's work over the ranks, mesh.py) at the card's bound over the
traced window's seconds on rank 0."""

from portbench import mesh


def read(r):
    return 100.0 * mesh.card_share(r, "step") / r.trace.window_s
