"""Percent of the traced ticks' wall time with no operation on the card (CUPTI, union of device intervals)."""


def read(r):
    return r.idle_share()
