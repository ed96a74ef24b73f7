"""Percent: the rollout's force passes the problem needs (the opening
pass and one a step, none recomputed) at the card's bound over the device
time of the force kernels, recomputed passes included."""


def read(r):
    return r.roofline("force_kernels", "force")
