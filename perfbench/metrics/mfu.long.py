"""Percent of the bf16 peak: the model FLOPs of the tokens the window's ticks processed over the window's seconds."""


def read(r):
    return r.mfu()
