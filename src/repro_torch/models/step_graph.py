"""CUDA graphs of the model's serving steps.

A :class:`StepGraph` captures one call of a step function (the paged
engine's ``lm_decode`` for one page bucket, or its ``lm_prefill`` for
one padded prompt length) and replays it.  A replay issues the copies
into the static inputs and one graph launch where the eager step issued
~1,500-2,000 launches and their Python.

The capture's example arguments ARE the static inputs.  A replay takes
arguments of the same structure and copies each tensor into the static
input at its place, unless it is that very tensor (the engine's
persistent recurrent state), and returns the outputs of the captured
call: static tensors that the next replay of the same graph
overwrites.  Python values among the arguments are fixed at capture.

The graphs of one engine share one memory pool
(``torch.cuda.graph_pool_handle()``): they replay one at a time on one
stream, and each keeps its outputs alive, so what one capture freed can
back another's intermediates.
"""

from __future__ import annotations

import gc
from typing import Any, Callable

import torch

__all__ = ["StepGraph", "tensors"]


def tensors(tree: Any) -> list:
    """The tensors of a tree of tuples, lists and dicts (keys sorted),
    in order; other leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for child in tree for t in tensors(child)]
    return []


class StepGraph:
    """``StepGraph(fn, *args, pool=, stream=)`` runs ``fn(*args)`` once
    on ``stream`` (the warm-up), then captures it there into a graph
    that draws its memory from ``pool``; :meth:`replay` runs it again on
    new arguments."""

    def __init__(self, fn: Callable, *args, pool=None,
                 stream: torch.cuda.Stream | None = None):
        self.static = tensors(args)
        stream = stream if stream is not None else torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        self.graph = torch.cuda.CUDAGraph()
        # A graph destroyed during a capture (a dead engine's, freed by
        # the collector) invalidates the capture: collect nothing while it
        # runs.  Unlike ``torch.cuda.graph``, this empties no cache before
        # each capture, which would make every warm-up allocate anew.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.no_grad(), torch.cuda.stream(stream):
                fn(*args)
                self.graph.capture_begin(pool=pool)
                try:
                    self.outputs = fn(*args)
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream().wait_stream(stream)

    def replay(self, *args):
        """Copy ``args`` into the static inputs, replay, and return the
        captured call's outputs."""
        srcs = tensors(args)
        if len(srcs) != len(self.static):
            raise ValueError(f"{len(srcs)} tensors for a graph captured on "
                             f"{len(self.static)}")
        for src, dst in zip(srcs, self.static):
            if src is dst:
                continue
            if src.shape != dst.shape:
                raise ValueError(f"a {tuple(src.shape)} tensor for the "
                                 f"static input {tuple(dst.shape)}")
            dst.copy_(src)
        self.graph.replay()
        return self.outputs
