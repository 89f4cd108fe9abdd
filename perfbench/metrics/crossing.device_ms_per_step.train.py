"""Device ms per step of protect and unprotect of the weights."""


def read(r):
    return r.layer_ms_per_unit("crossing")
