"""Kernels the card ran per traced training step."""


def read(r):
    return r.launches_per_unit()
