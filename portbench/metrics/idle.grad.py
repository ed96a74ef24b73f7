"""Percent of the traced window in which no device operation ran."""


def read(r):
    return r.idle()
