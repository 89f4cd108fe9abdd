"""Device-cost attribution: protection vs. model cost of one decode call.

The port of ``repro.obs.profiler``.  The reference walks the compiled
XLA HLO of a decode variant, whose per-instruction metadata names the
Python line that built each op.  The port has no HLO: it runs one decode
call under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
that sees every aten op, and attributes each op to the innermost stack
frame in ``repro_torch`` (this module skipped).  That splits the call's
cost into

* **protection** — AES-CTR keystream + B-AES key schedule, NH MACs, VN
  freshness, key-bank gathers, page binding and counter construction
  (the crypto files under ``core/`` and ``kernels/``, plus the
  protection helpers inside ``serve/kv_pages.py`` by source-line
  range), and
* **model** — attention/MLP/sampling and the paging glue the model
  would need even with protection ``off``;

ops with no ``repro_torch`` frame are ``other``.

The hand-written CUDA kernels launch through ``ctypes``, where a
dispatch mode sees only their output allocations.  Each wrapper charges
its launch itself (:func:`repro_torch.kernels.charge`): its operand and
output bytes and its integer operations, under the wrapper's file.  CPU
tensors run the kernels' plain versions, whose aten ops the mode counts.

Accounting conventions (the reference's, which track XLA's own
HloCostAnalysis):

* bytes: operand + output bytes of every op.  Views (``view``,
  ``expand``, ``permute``, ``slice``, ...), ``lift_fresh`` and bare
  allocations (``empty*``) are free, as ``parameter`` and ``bitcast``
  are in the reference.  A gather (``index``, ``index_select``,
  ``gather``, ``embedding``) moves twice its output plus its indices,
  and a scatter (``index_put_``, ``index_copy_``, ``scatter_``, ...)
  three times its updates plus its indices, as XLA's cost analysis
  charges them: the table a gather reads from is not read whole.
* flops: matmuls and convolutions by
  :data:`torch.utils.flop_counter.flop_registry` (2·M·N·K); elementwise
  arithmetic, the integer ops and conversions (``_to_copy``) one per
  output element; reductions one per input element.

The roofline takes the H100's peaks where the reference takes the TPU
v5e's.  The engine's lazy gauges read profiles cached by
``Engine.profile()`` / ``ClusterEngine.profile()``; a snapshot never
runs a decode.
"""

from __future__ import annotations

import ast
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels as kernels_mod

__all__ = ["CostProfile", "attribute_call", "classify_source",
           "profile_decode", "HBM_BW", "PEAK_FLOPS"]

# H100 SXM (NVIDIA data sheet): HBM3 bytes/s and the bf16 dense
# tensor-core peak.
HBM_BW = 3.35e12
PEAK_FLOPS = 989e12

# -- source classification ---------------------------------------------------

# Crypto/integrity modules: every op they emit is protection work.
_PROTECTION_BASENAMES = frozenset({
    "aes.py", "baes.py", "ctr.py", "mac.py", "vn.py", "multilevel.py",
    "secure_exec.py", "secure_memory.py", "bytesutil.py",
})

# serve/kv_pages.py mixes paging glue (model-side) with the protection
# path; these functions are the protection side, attributed by the
# source-line ranges ast gives us.  The reference's set, less
# ``_fused_read`` / ``_fused_write`` (the port's ``_crossing`` takes
# their place), plus the port's own factorings of the counter words
# (``_counter_words``) and the bank-key gathers (``_page_keys``).
_KV_PROTECTION_FUNCS = frozenset({
    "_block_pa", "_tenant_words", "_shard_ctr_word", "_block_counters",
    "_block_binding", "_uniform_keys", "_crypt", "_page_block_macs",
    "_fused_crossing", "_crossing", "_counter_words", "_page_keys",
    "deferred_pool_check",
})

_kv_ranges_cache: Optional[list] = None


def _kv_protection_ranges() -> list:
    """[(lo, hi)] source-line ranges of kv_pages' protection helpers."""
    global _kv_ranges_cache
    if _kv_ranges_cache is None:
        from repro_torch.serve import kv_pages
        with open(kv_pages.__file__) as f:
            tree = ast.parse(f.read())
        ranges = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in _KV_PROTECTION_FUNCS:
                ranges.append((node.lineno, node.end_lineno or node.lineno))
        _kv_ranges_cache = sorted(ranges)
    return _kv_ranges_cache


def classify_source(source_file: str, source_line: int) -> str:
    """'protection' | 'model' for one attributed op."""
    path = source_file.replace("\\", "/")
    if "/kernels/" in path:
        return "protection"
    base = path.rsplit("/", 1)[-1]
    if base in _PROTECTION_BASENAMES:
        return "protection"
    if base == "kv_pages.py":
        for lo, hi in _kv_protection_ranges():
            if lo <= source_line <= hi:
                return "protection"
    return "model"


# -- per-op cost --------------------------------------------------------------

_FREE_OPS = frozenset({"lift_fresh", "new_empty", "new_empty_strided"})
_GATHER_OPS = frozenset({"index", "index_select", "gather", "embedding",
                         "take"})
_SCATTER_OPS = frozenset({"index_put", "_index_put_impl", "index_copy",
                          "scatter", "scatter_add", "scatter_reduce",
                          "index_add", "index_reduce"})

# One flop per output element.
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "pow",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "neg", "abs",
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "rsqrt", "sqrt",
    "reciprocal", "sign", "floor", "ceil", "round", "trunc", "sin", "cos",
    "sigmoid", "silu", "gelu", "erf", "softplus", "lerp", "addcmul",
    "addcdiv", "masked_fill", "where", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "__and__", "__or__", "__xor__", "__lshift__",
    "__rshift__", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_xor", "logical_not", "isnan", "isinf",
    "isfinite", "_to_copy",
})

# One flop per input element.
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "any", "all", "cumsum", "cumprod", "logsumexp", "_softmax",
    "_log_softmax", "var", "var_mean", "std", "norm", "linalg_vector_norm",
    "topk", "sort", "argsort",
})


def _op_name(func) -> str:
    """The op's name with an in-place op's trailing ``_`` dropped."""
    name = func._overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _op_cost(func, args, kwargs, out) -> tuple:
    """``(bytes, flops)`` of one aten op under the module's conventions."""
    name = _op_name(func)
    if func.is_view or name.startswith("empty") or name in _FREE_OPS:
        return 0.0, 0.0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if name in _GATHER_OPS and ins:
        nbytes = 2 * _nbytes(outs) + _nbytes(ins[1:])
    elif name in _SCATTER_OPS and len(ins) >= 2:
        nbytes = 3 * _nbytes(ins[-1:]) + _nbytes(ins[1:-1])
    else:
        nbytes = _nbytes(ins) + _nbytes(outs)
    flops = 0.0
    packet = func._overloadpacket
    if packet in flop_registry:
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
    elif name in ("max", "min") and func._overloadname == "other":
        flops = float(outs[0].numel()) if outs else 0.0
    elif name in _ELEMENTWISE:
        flops = float(outs[0].numel()) if outs else 0.0
    elif name in _REDUCTIONS:
        flops = float(ins[0].numel()) if ins else 0.0
    return nbytes, flops


_THIS_FILE = os.path.abspath(__file__)
_PKG = "/repro_torch/"


def _source() -> Optional[tuple]:
    """(file, line) of the innermost ``repro_torch`` frame on the stack,
    this module skipped; None when there is none."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if _PKG in path.replace("\\", "/") and \
                os.path.abspath(path) != _THIS_FILE:
            return path, frame.f_lineno
        frame = frame.f_back
    return None


# -- attribution ---------------------------------------------------------------

def _leaf() -> dict:
    return {"bytes": 0.0, "flops": 0.0, "ops": 0}


def _bump(leaf: dict, nbytes: float, flops: float) -> None:
    leaf["bytes"] += nbytes
    leaf["flops"] += flops
    leaf["ops"] += 1


class _Attribution:
    """The three cost buckets and the per-file split, filled op by op."""

    def __init__(self):
        self.buckets = {k: _leaf() for k in ("protection", "model", "other")}
        self.by_file: dict = {}
        self._kinds: dict = {}

    def add(self, src: Optional[tuple], nbytes: float, flops: float) -> None:
        if nbytes == 0.0 and flops == 0.0:
            return
        if src is None:
            _bump(self.buckets["other"], nbytes, flops)
            return
        kind = self._kinds.get(src)
        if kind is None:
            kind = self._kinds[src] = classify_source(*src)
        key = src[0].replace("\\", "/")
        if _PKG in key:
            key = key.split(_PKG, 1)[1]
        _bump(self.by_file.setdefault(key, _leaf()), nbytes, flops)
        _bump(self.buckets[kind], nbytes, flops)

    def result(self) -> dict:
        b = self.buckets
        total = {k: sum(b[c][k] for c in b) for k in ("bytes", "flops")}
        total["ops"] = sum(b[c]["ops"] for c in b)
        return {**b, "total": total, "by_file": self.by_file}


class _CostMode(TorchDispatchMode):
    def __init__(self, acc: _Attribution):
        super().__init__()
        self.acc = acc

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        nbytes, flops = _op_cost(func, args, kwargs, out)
        if nbytes or flops:
            self.acc.add(_source(), nbytes, flops)
        return out


def attribute_call(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once and split its bytes/flops by
    protection|model|other.

    Returns ``(fn's result, attribution)``, the attribution
    ``{"protection": {...}, "model": {...}, "other": {...}, "total":
    {...}, "by_file": {file: {...}}}`` with each leaf ``{"bytes": float,
    "flops": float, "ops": int}`` (the reference's ``attribute_hlo``
    shape).  Kernel launches on the card count as protection ops under
    their wrapper's file.
    """
    acc = _Attribution()

    def sink(name, source_file, nbytes, ops):
        acc.add((source_file, 0), nbytes, ops)

    kernels_mod.COST_SINKS.append(sink)
    try:
        with _CostMode(acc):
            out = fn(*args, **kwargs)
    finally:
        kernels_mod.COST_SINKS.remove(sink)
    return out, acc.result()


# -- the profile object ------------------------------------------------------

def _ratio(num: float, den: float) -> float:
    return num / den if den else 0.0


@dataclass
class CostProfile:
    """Attributed device cost of one decode variant."""

    scheme: str
    bucket: int
    uniform: bool
    protection: dict
    model: dict
    other: dict
    total: dict
    by_file: dict = field(default_factory=dict)
    xla_cost: dict = field(default_factory=dict)
    tick_seconds_p50: Optional[float] = None

    @property
    def overhead_bytes_ratio(self) -> float:
        """Protection bytes per model byte (the SeDA overhead claim)."""
        return _ratio(self.protection["bytes"], self.model["bytes"])

    @property
    def overhead_flops_ratio(self) -> float:
        return _ratio(self.protection["flops"], self.model["flops"])

    @property
    def coverage(self) -> dict:
        """Fraction of total bytes/flops the protection+model split
        accounts for (the rest carried no source attribution)."""
        acc_b = self.protection["bytes"] + self.model["bytes"]
        acc_f = self.protection["flops"] + self.model["flops"]
        return {"bytes": _ratio(acc_b, self.total["bytes"]),
                "flops": _ratio(acc_f, self.total["flops"])}

    def roofline(self) -> dict:
        """Roofline time of the attributed cost on the H100, and — when
        a measured median tick is available — the achieved fraction."""
        t_compute = self.total["flops"] / PEAK_FLOPS
        t_memory = self.total["bytes"] / HBM_BW
        t_roof = max(t_compute, t_memory)
        out = {"compute_s": t_compute, "memory_s": t_memory,
               "roofline_s": t_roof,
               "bound": "compute" if t_compute >= t_memory else "memory"}
        if self.tick_seconds_p50 and self.tick_seconds_p50 > 0:
            out["measured_tick_s"] = self.tick_seconds_p50
            out["utilization"] = t_roof / self.tick_seconds_p50
        return out

    def to_dict(self) -> dict:
        return {
            "scheme": self.scheme, "bucket": self.bucket,
            "uniform": self.uniform,
            "protection": dict(self.protection), "model": dict(self.model),
            "other": dict(self.other), "total": dict(self.total),
            "overhead_bytes_ratio": self.overhead_bytes_ratio,
            "overhead_flops_ratio": self.overhead_flops_ratio,
            "coverage": self.coverage,
            "roofline": self.roofline(),
            "xla_cost": dict(self.xla_cost),
            "by_file": {k: dict(v) for k, v in sorted(self.by_file.items())},
        }


def profile_decode(engine, bucket: Optional[int] = None,
                   uniform: bool = False) -> CostProfile:
    """Run one decode call of a variant and attribute its cost.

    The reference compiles the variant and never runs it; the port runs
    it once, on the analysis arguments (zeros and ones of the variant's
    shapes), against clones of the engine's pool and on-chip state with
    the pool's write listeners detached (``engine._detached_decode``),
    so the engine, its Merkle level and any cluster root are as they
    were.  The verdict is discarded, and the kernels' launch counts are
    restored.  ``xla_cost`` stays ``{}``, as the reference leaves it on a
    backend without XLA's cost analysis.
    """
    if bucket is None:
        bucket = engine.pages_per_slot
    fn = engine._decode_fn_for(bucket, uniform)
    args = engine._decode_analysis_args(bucket)
    launches = dict(kernels_mod.LAUNCHES)
    try:
        with torch.no_grad(), engine._detached_decode():
            _, attr = attribute_call(fn, *args)
    finally:
        kernels_mod.LAUNCHES.update(launches)
    tick_hist = engine.metrics.histograms.get("tick_seconds")
    p50 = None
    if tick_hist is not None and tick_hist.count:
        p50 = tick_hist.percentile(50)
        if math.isnan(p50):
            p50 = None
    return CostProfile(
        scheme=engine.scheme, bucket=bucket, uniform=uniform,
        protection=attr["protection"], model=attr["model"],
        other=attr["other"], total=attr["total"], by_file=attr["by_file"],
        xla_cost={}, tick_seconds_p50=p50)
