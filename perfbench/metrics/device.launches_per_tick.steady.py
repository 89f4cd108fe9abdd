"""Kernels the card ran per traced tick."""


def read(r):
    return r.launches_per_unit()
