"""Decoder-only LM: specs, prefill and decode (dense attention stacks).

The reference scans one block body over per-segment stacked parameters;
here a Python loop over the layer index does the same work.  The
parameter tree keeps the reference layout::

    {"embed": (vocab, d), "final_norm": (d,),
     "segments": [[{"norm_mixer": (L, d), "attn": {"wq": (L, d, H, D), ...},
                    "norm_ffn": (L, d), "ffn": {"w_up": (L, d, F), ...}}]]}

Caches are ``[[KVCache(k (L, B, max_len, n_kv, D), v, length (L, ...))]]``,
so a flat walk over them gives the reference's leaf order (k, v, length).
:class:`LM` holds such a tree as ``nn.Parameter``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.models import blocks as blk
from repro_torch.models.attention import CacheSpec, KVCache
from repro_torch.models.layers import ParamSpec, rms_norm, spec, tree_map

__all__ = ["LMConfig", "LM", "layout", "segments", "lm_specs", "cache_specs",
           "lm_prefill", "lm_decode"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    dtype: str = "bfloat16"
    mixer: str = "attn"
    ffn: str = "dense"
    gated_ffn: bool = True        # SwiGLU; False = GELU MLP
    tie_embeddings: bool = True
    q_block: int = 512
    kv_block: int = 1024

    def __post_init__(self):
        if not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))


def layout(cfg: LMConfig) -> list:
    return [blk.LayerKind(cfg.mixer, cfg.ffn) for _ in range(cfg.n_layers)]


def segments(cfg: LMConfig) -> list:
    """[(period_kinds: tuple[LayerKind], steps: int), ...] — maximal
    uniform runs (one run for a homogeneous stack)."""
    kinds = layout(cfg)
    segs, i = [], 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        segs.append(((kinds[i],), j - i))
        i = j
    return segs


def _stack(specs: Any, steps: int) -> Any:
    return tree_map(lambda s: ParamSpec((steps,) + s.shape, s.dtype, s.init),
                    specs)


def lm_specs(cfg: LMConfig) -> dict:
    s: dict = {
        "embed": spec((cfg.vocab, cfg.d_model), cfg.dtype, init="embed"),
        "final_norm": spec((cfg.d_model,), "float32", init="ones"),
        "segments": [[_stack(blk.block_specs(cfg, kind), steps)
                      for kind in kinds] for kinds, steps in segments(cfg)],
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = spec((cfg.d_model, cfg.vocab), cfg.dtype)
    return s


def cache_specs(cfg: LMConfig, batch: int, max_len: int) -> list:
    """Per-segment stacked cache specs (CacheSpec leaves)."""
    return [[KVCache(*(CacheSpec((steps,) + c.shape, c.dtype)
                       for c in blk.block_cache_specs(cfg, kind, batch,
                                                      max_len)))
             for kind in kinds] for kinds, steps in segments(cfg)]


def _layer(tree: Any, i: int) -> Any:
    return tree_map(lambda a: a[i], tree)


def _head(cfg: LMConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t())
    return torch.matmul(x, params["lm_head"])


def lm_prefill(cfg: LMConfig, params, batch, max_len: int,
               last_pos: Optional[int] = None):
    """Full-sequence prefill: returns (last_logits (B, 1, V), caches).

    ``last_pos`` selects the position whose logits are returned (the
    engine right-pads prompts to a power-of-two length).
    """
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    b, l = tokens.shape
    positions = torch.arange(l, dtype=torch.int32,
                             device=x.device)[None].expand(b, l)
    caches = []
    for seg_params, (kinds, steps) in zip(params["segments"], segments(cfg)):
        per_kind = [[] for _ in kinds]
        for i in range(steps):
            for j, (kind, p) in enumerate(zip(kinds, seg_params)):
                x, cache = blk.block_prefill(cfg, kind, _layer(p, i), x,
                                             positions, max_len)
                per_kind[j].append(cache)
        caches.append([KVCache(*(torch.stack(leaf) for leaf in zip(*cs)))
                       for cs in per_kind])
    x = rms_norm(x, params["final_norm"])
    last = x[:, -1:] if last_pos is None else x[:, last_pos: last_pos + 1]
    return _head(cfg, params, last), caches


def lm_decode(cfg: LMConfig, params, tokens: torch.Tensor, caches):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new caches)."""
    x = params["embed"][tokens]
    new_caches = []
    for seg_params, seg_cache, (kinds, steps) in zip(
            params["segments"], caches, segments(cfg)):
        per_kind = [[] for _ in kinds]
        for i in range(steps):
            for j, (kind, p, c) in enumerate(zip(kinds, seg_params,
                                                 seg_cache)):
                x, new = blk.block_decode(cfg, kind, _layer(p, i), x,
                                          KVCache(*(leaf[i] for leaf in c)))
                per_kind[j].append(new)
        new_caches.append([KVCache(*(torch.stack(leaf) for leaf in zip(*cs)))
                           for cs in per_kind])
    x = rms_norm(x, params["final_norm"])
    return _head(cfg, params, x), new_caches


def _to_module(tree: Any) -> nn.Module:
    """Nested dicts / lists of tensors -> nested ModuleDict / ModuleList
    whose leaves are registered parameters."""
    if isinstance(tree, dict):
        mod = nn.Module()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                mod.register_parameter(key, nn.Parameter(val,
                                                         requires_grad=False))
            else:
                mod.add_module(key, _to_module(val))
        return mod
    return nn.ModuleList([_to_module(v) for v in tree])


def _from_module(mod: nn.Module, template: Any) -> Any:
    if isinstance(template, dict):
        return {k: (getattr(mod, k) if isinstance(v, torch.Tensor)
                    else _from_module(getattr(mod, k), v))
                for k, v in template.items()}
    return [_from_module(m, t) for m, t in zip(mod, template)]


class LM(nn.Module):
    """The LM as an ``nn.Module`` over a reference-layout parameter tree.

    ``LM(cfg, init_params(lm_specs(cfg), seed, device=...))``;
    :meth:`tree` returns the parameters in the tree form that
    :func:`lm_prefill` / :func:`lm_decode` and the engine take.
    """

    def __init__(self, cfg: LMConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self._template = tree_map(lambda t: t, params)
        self.body = _to_module(params)

    def tree(self) -> dict:
        return _from_module(self.body, self._template)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                last_pos: Optional[int] = None):
        return lm_prefill(self.cfg, self.tree(), {"tokens": tokens}, max_len,
                          last_pos)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, caches):
        return lm_decode(self.cfg, self.tree(), tokens, caches)
