"""Percent of the traced window in which no device operation ran while
the host was inside one of the program's nbody.force, nbody.vjp or
nbody.resident spans (spans.py): the idle time the force dispatch
leaves."""

from portbench import spans


def read(r):
    return spans.dispatch_idle(r)
