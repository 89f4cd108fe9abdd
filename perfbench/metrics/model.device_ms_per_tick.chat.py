"""Device ms per tick of the kernels launched inside lm_prefill and lm_decode."""


def read(r):
    return r.layer_ms_per_unit("model")
