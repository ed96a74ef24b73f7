"""Percent: the whole problem of the traced calls (force passes and
VJPs) at the card's bound over the traced window's seconds."""


def read(r):
    return r.step_mfu()
