"""Percent: the least time of the weights crossing's required work (plaintext and ciphertext once each way, the AES and NH operations) over its device time."""


def read(r):
    return r.roofline_share("crossing")
