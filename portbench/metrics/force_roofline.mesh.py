"""Percent: this card's share of the problem's force passes (the problem's
work over the ranks, mesh.py) at the card's bound over rank 0's device
time of the force kernels (layers/force_kernels.json; K1 on a rank's
rectangle under sharding)."""

from portbench import mesh


def read(r):
    seconds = r.layer_seconds("force_kernels")
    if seconds <= 0.0:
        return None
    return 100.0 * mesh.card_share(r, "force") / seconds
