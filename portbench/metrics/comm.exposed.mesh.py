"""Percent of the traced window that the exchange does not hide on rank 0:
a collective's kernel runs and no other device operation does, or the
device idles while the host is inside a nbody.comm span (mesh.py); None
where the program opens no nbody.comm span."""

from portbench import mesh


def read(r):
    return mesh.exposed_comm(r)
