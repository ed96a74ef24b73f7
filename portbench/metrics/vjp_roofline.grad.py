"""Percent: the force VJPs the gradient needs at the card's bound over
the device time of the VJP kernels (layers/vjp_kernels.json)."""


def read(r):
    return r.roofline("vjp_kernels", "vjp")
