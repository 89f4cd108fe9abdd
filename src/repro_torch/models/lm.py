"""Decoder-only LM: specs, training forward and loss, prefill and decode.

Homogeneous stacks (minitron, granite, smollm, olmoe, mamba2) are one
segment; prefix-irregular ones (deepseek-v3: dense layers, then MoE)
split into maximal uniform segments; periodic hybrids (jamba: attention
every 8th mixer, MoE every 2nd FFN) are one segment whose period holds
several block kinds, stacked per kind.  The reference scans one period
of block bodies over per-segment stacked parameters; here a Python loop
over the period index does the same work.  The parameter tree keeps the
reference layout::

    {"embed": (vocab, d), "final_norm": (d,), ["lm_head": (d, vocab),]
     "segments": [[{"norm_mixer": (L, d), "attn": {"wq": (L, d, H, D), ...},
                    "norm_ffn": (L, d), "ffn": {"w_up": (L, d, F), ...}}]]}

with ``"mla"`` or ``"mamba"`` in place of ``"attn"``, ``"moe"`` in place
of ``"ffn"`` and no ``"norm_ffn"``/``"ffn"`` for ``ffn="none"``, where
the layer kind says so, and ``"img_proj": (d_vision, d)`` for a VLM
(pixtral), whose projected image patches prefix the text.  Training
(:func:`lm_forward`, :func:`lm_loss`) unbinds each stacked leaf once,
so autograd stacks the per-layer gradients in one pass, and with
``remat="full"`` recomputes each period in the backward pass
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` with
nothing saveable).  Caches are
``[[KVCache(k (L, B, max_len, n_kv, D), v, length (L, ...))]]`` (or
``MLACache(c_kv, k_pe, length)``, or ``Mamba2State(ssm (L, B, H, P, N),
conv (L, B, d_conv - 1, conv_dim), length)``), one entry per kind of the
period, so a flat walk over them gives the reference's leaf order.
:class:`LM` holds such a tree as ``nn.Parameter``s.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.models import blocks as blk
from repro_torch.models.attention import CacheSpec
from repro_torch.models.layers import (ParamSpec, masked_nll, maybe_remat,
                                       rms_norm, spec, tree_map, unstack)
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.obs import trace as trace_mod

__all__ = ["LMConfig", "LM", "layout", "segments", "lm_specs", "cache_specs",
           "lm_forward", "lm_loss", "lm_prefill", "lm_decode"]


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
    # Block pattern:
    mixer: str = "attn"           # default mixer: attn | mla | mamba
    attn_every: int = 0           # jamba: one attn per this many layers
    attn_offset: int = 3
    ffn: str = "dense"            # dense | moe | none
    moe_every: int = 1            # moe where idx % moe_every == moe_offset
    moe_offset: int = 0
    moe_start_layer: int = 0      # deepseek: dense layers before this index
    mamba: Optional[Mamba2Config] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    gated_ffn: bool = True        # SwiGLU; False = plain GELU MLP (granite)
    tie_embeddings: bool = True
    q_block: int = 512
    kv_block: int = 1024
    ssd_chunk: int = 256
    remat: str = "full"           # full | none (training only)
    # The VLM frontend is a stub: precomputed patch embeddings.
    n_image_patches: int = 0
    d_vision: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def __post_init__(self):
        if not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))


def layout(cfg: LMConfig) -> list:
    """Per-layer (mixer, ffn) kinds."""
    kinds = []
    for i in range(cfg.n_layers):
        mixer = cfg.mixer
        if cfg.attn_every and i % cfg.attn_every == cfg.attn_offset:
            mixer = "attn"
        ffn = cfg.ffn
        if cfg.ffn == "moe":
            is_moe = (i >= cfg.moe_start_layer
                      and i % cfg.moe_every == cfg.moe_offset)
            ffn = "moe" if is_moe else "dense"
        kinds.append(blk.LayerKind(mixer, ffn))
    return kinds


def segments(cfg: LMConfig) -> list:
    """[(period_kinds: tuple[LayerKind], steps: int), ...].

    Maximal uniform runs while there are at most 4 of them (one for a
    homogeneous stack; deepseek-v3 cut to 4 layers gives 3 x (mla, dense),
    then 1 x (mla, moe)); otherwise, as for jamba, one segment of the
    smallest period p <= 16 that divides the depth and repeats."""
    kinds = layout(cfg)
    n = len(kinds)
    segs, i = [], 0
    while i < n:
        j = i
        while j < n and kinds[j] == kinds[i]:
            j += 1
        segs.append(((kinds[i],), j - i))
        i = j
    if len(segs) <= 4:
        return segs
    for p in range(2, min(16, n) + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return [(tuple(kinds[:p]), n // p)]
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
    if cfg.n_image_patches:
        s["img_proj"] = spec((cfg.d_vision, cfg.d_model), cfg.dtype)
    return s


def cache_specs(cfg: LMConfig, batch: int, max_len: int) -> list:
    """Per-segment stacked cache specs (CacheSpec leaves)."""
    def stacked(c, steps):
        return type(c)(*(CacheSpec((steps,) + leaf.shape, leaf.dtype)
                         for leaf in c))

    return [[stacked(blk.block_cache_specs(cfg, kind, batch, max_len), steps)
             for kind in kinds] for kinds, steps in segments(cfg)]


def _stack_caches(caches: list):
    """Per-layer caches of one kind -> one cache with stacked leaves."""
    return type(caches[0])(*(torch.stack(leaf) for leaf in zip(*caches)))


def _layer(tree: Any, i: int) -> Any:
    return tree_map(lambda a: a[i], tree)


def _head(cfg: LMConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t())
    return torch.matmul(x, params["lm_head"])


def _embed_tokens(cfg: LMConfig, params, batch) -> tuple:
    """``(x, positions)``, the projected image patches (``batch
    ["image_embeds"]``, (B, P, d_vision)) ahead of the text for a VLM."""
    x = params["embed"][batch["tokens"]]
    if cfg.n_image_patches:
        img = torch.matmul(batch["image_embeds"].to(x.dtype),
                           params["img_proj"])
        x = torch.cat([img, x], dim=1)
    b, l = x.shape[:2]
    positions = torch.arange(l, dtype=torch.int32,
                             device=x.device)[None].expand(b, l)
    return x, positions


def _period(cfg: LMConfig, kinds, period, positions, x, aux) -> tuple:
    """One period of blocks (the reference's scan body)."""
    for kind, p in zip(kinds, period):
        x, aux = blk.block_forward(cfg, kind, p, x, positions, aux)
    return x, aux


def lm_forward(cfg: LMConfig, params, batch) -> tuple:
    """Training forward: ``(logits (B, L, V), aux)``, ``aux`` the summed
    MoE load-balance loss (float32 scalar)."""
    x, positions = _embed_tokens(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, (kinds, steps) in zip(params["segments"], segments(cfg)):
        per_kind = [unstack(p, steps) for p in seg_params]
        for i in range(steps):
            body = functools.partial(_period, cfg, kinds,
                                     [layers[i] for layers in per_kind],
                                     positions)
            x, aux = maybe_remat(cfg.remat, body)(x, aux)
    x = rms_norm(x, params["final_norm"])
    return _head(cfg, params, x), aux


def lm_loss(cfg: LMConfig, params, batch) -> tuple:
    """Next-token cross entropy over the text positions (``-1`` labels
    masked) plus 0.01 x the MoE aux loss: ``(loss, metrics)``."""
    logits, aux = lm_forward(cfg, params, batch)
    if cfg.n_image_patches:
        logits = logits[:, cfg.n_image_patches:]
    loss = masked_nll(logits, batch["labels"])
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


def lm_prefill(cfg: LMConfig, params, batch, max_len: int,
               last_pos=None, graph=None):
    """Full-sequence prefill: returns (last_logits (B, 1, V), caches).

    ``last_pos`` selects the position whose logits are returned (the
    engine right-pads prompts to a power-of-two length): an int, or a
    (1,) int64 tensor, as a graph's static input is.  ``graph`` (a
    :class:`~repro_torch.models.step_graph.StepGraph` captured over a
    call of this function at ``batch``'s shape) replays that call on
    ``batch`` and ``last_pos`` instead.
    """
    with trace_mod.span("model.prefill"):
        if graph is not None:
            return graph.replay(batch, last_pos)
        x, positions = _embed_tokens(cfg, params, batch)
        caches = []
        for seg_params, (kinds, steps) in zip(params["segments"],
                                              segments(cfg)):
            per_kind = [[] for _ in kinds]
            for i in range(steps):
                for j, (kind, p) in enumerate(zip(kinds, seg_params)):
                    x, cache = blk.block_prefill(cfg, kind, _layer(p, i), x,
                                                 positions, max_len)
                    per_kind[j].append(cache)
            caches.append([_stack_caches(cs) for cs in per_kind])
        x = rms_norm(x, params["final_norm"])
        if last_pos is None:
            last = x[:, -1:]
        elif isinstance(last_pos, torch.Tensor):
            last = x.index_select(1, last_pos)
        else:
            last = x[:, last_pos: last_pos + 1]
        return _head(cfg, params, last), caches


def lm_decode(cfg: LMConfig, params, tokens: torch.Tensor, caches,
              graph=None):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new caches).

    ``graph`` (a :class:`~repro_torch.models.step_graph.StepGraph`
    captured over a call of this function at the caches' shapes)
    replays that call on ``tokens`` and ``caches`` instead.
    """
    with trace_mod.span("model.decode"):
        if graph is not None:
            return graph.replay(tokens, caches)
        x = params["embed"][tokens]
        new_caches = []
        for seg_params, seg_cache, (kinds, steps) in zip(
                params["segments"], caches, segments(cfg)):
            per_kind = [[] for _ in kinds]
            for i in range(steps):
                for j, (kind, p, c) in enumerate(zip(kinds, seg_params,
                                                     seg_cache)):
                    x, new = blk.block_decode(
                        cfg, kind, _layer(p, i), x,
                        type(c)(*(leaf[i] for leaf in c)))
                    per_kind[j].append(new)
            new_caches.append([_stack_caches(cs) for cs in per_kind])
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
