"""Percent: the sweep's force passes at the card's bound over the
device time of the kernels that evaluate them on any route: the ensemble
slot kernels with their slot-order sums, or the resident kernel
(layers/ensemble_kernels.json)."""


def read(r):
    return r.roofline("ensemble_kernels", "force")
