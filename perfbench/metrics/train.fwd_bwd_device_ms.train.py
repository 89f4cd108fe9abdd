"""Device ms per step of the forward and backward pass (value_and_grad)."""


def read(r):
    return r.layer_ms_per_unit("train")
