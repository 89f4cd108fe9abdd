"""Host ms per tick in the engine's own tick_begin span (admission, prefill, rotation)."""


def read(r):
    return r.span_ms_per_unit("tick_begin")
