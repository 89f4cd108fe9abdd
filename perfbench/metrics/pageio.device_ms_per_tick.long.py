"""Device ms per tick of the kernels launched inside the PageIO ranges."""


def read(r):
    return r.layer_ms_per_unit("pageio")
