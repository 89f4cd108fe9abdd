"""What a traced run read, in the form the per-layer metrics take it.

A metric file (``perfbench/metrics/<name>.py``) calls one of these
methods; each returns None where the run has nothing to read (a layer
whose wrapped names went missing, a segment that was not traced, a
range no kernel ran in), and never 0 for a share of a roofline or a
peak.
"""

from __future__ import annotations

from perfbench import costs


class Readings:
    def __init__(self, *, window_s: float, units: int,
                 spans=None, device=None, layers=None, ranges=None,
                 targets=(), work=None, model_flops=None):
        self.window_s = window_s          # the measured window, host clock
        self.units = units                # ticks or steps in it
        self.spans = spans or {}          # engine span name -> total s
        self.device = device              # tracing.Segment, card only
        self.layers = layers              # tracing.Segment, card + host
        self._ranges = ranges
        self._targets = list(targets)
        self.work = work or {}            # layer -> (bytes, ops) in layers
        self.model_flops = model_flops    # model FLOPs of the window
        self.bounds: dict = {}            # layer -> "bytes" | "operations"

    # -- why a metric is silent ---------------------------------------------

    def missing(self, layer: str) -> list:
        if self._ranges is None:
            return []
        return self._ranges.missing_for(layer, self._targets)

    def why_missing(self, metric: str) -> str:
        layer = metric.split(".")[0]
        gone = self.missing(layer)
        return f"(wrapped names missing: {gone})" if gone else ""

    # -- host spans ------------------------------------------------------------

    def span_ms_per_unit(self, name: str):
        if name not in self.spans or not self.units:
            return None
        return self.spans[name] / self.units * 1e3

    # -- the card ------------------------------------------------------------

    def idle_share(self):
        """Percent of the traced window with no operation on the card."""
        seg = self.device
        if seg is None or not seg.device or seg.wall_s <= 0:
            return None
        return 100.0 * (1.0 - seg.busy_s() / seg.wall_s)

    def launches_per_unit(self):
        seg = self.device
        if seg is None or not seg.units or not seg.launch_count:
            return None
        return seg.launch_count / seg.units

    def layer_ms_per_unit(self, layer: str):
        seg = self.layers
        if seg is None or not seg.units or self.missing(layer):
            return None
        us = seg.layer_us.get(layer, 0.0)
        return us / seg.units / 1e3 if us > 0 else None

    def roofline_share(self, layer: str):
        """Percent: the least time the layer's required work takes on
        the card over its device time in the traced segment."""
        ms = self.layer_ms_per_unit(layer)
        if ms is None or layer not in self.work:
            return None
        nbytes, ops = self.work[layer]
        t, kind = costs.bound_s(nbytes / self.layers.units,
                                ops / self.layers.units)
        self.bounds[layer] = kind
        return 100.0 * t / (ms / 1e3)

    def mfu(self):
        """Percent of the bf16 peak the window's model FLOPs reach."""
        if not self.model_flops or self.window_s <= 0:
            return None
        return 100.0 * self.model_flops / (self.window_s * costs.BF16_FLOPS)
