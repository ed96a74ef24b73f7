"""Percent: the problem's force passes at the card's bound over the
device time of the force kernels (layers/force_kernels.json)."""


def read(r):
    return r.roofline("force_kernels", "force")
