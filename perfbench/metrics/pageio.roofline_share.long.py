"""Percent: the least time of the crossings' required work (ciphertext and page MACs of the window read and the pages written, the AES and NH operations) over their device time."""


def read(r):
    return r.roofline_share("pageio")
