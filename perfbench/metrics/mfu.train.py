"""Percent of the bf16 peak: 6 x matmul weights x tokens plus attention per step, over the window's seconds per step."""


def read(r):
    return r.mfu()
