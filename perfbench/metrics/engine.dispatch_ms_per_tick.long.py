"""Host ms per tick in the engine's own decode_dispatch span (the launches of the eager decode)."""


def read(r):
    return r.span_ms_per_unit("decode_dispatch")
