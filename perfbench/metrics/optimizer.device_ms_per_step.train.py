"""Device ms per step of the AdamW update."""


def read(r):
    return r.layer_ms_per_unit("optimizer")
