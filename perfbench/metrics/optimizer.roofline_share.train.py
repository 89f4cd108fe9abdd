"""Percent: each parameter, gradient and moment read once and each parameter and moment written once, over 3.35 TB/s, divided by the AdamW update's device time."""


def read(r):
    return r.roofline_share("optimizer")
