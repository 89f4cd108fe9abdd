"""AdamW with dtype-configurable moments.

The reference's update (``repro.train.optimizer``) leaf by leaf over the
parameter tree, in its arithmetic: the global-norm clip in float32, the
linear warmup, bias correction from an int32 step count, weight decay on
matrices (``ndim >= 2``) only, and moments stored in ``state_dtype``.
No ``torch.optim``: a fused or foreach optimizer computes the same
update in another order.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.layout import tree_flatten, tree_unflatten
from repro_torch.models.layers import DTYPES, ParamSpec, tree_map
from repro_torch.obs import trace as trace_mod

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "opt_state_specs",
           "adamw_update"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor     # () int32


def opt_state_specs(param_specs: Any, cfg: AdamWConfig) -> OptState:
    """Specs for the optimizer state (mirrors params, state dtype)."""
    as_state = tree_map(lambda s: ParamSpec(s.shape, cfg.state_dtype,
                                            "zeros"), param_specs)
    return OptState(mu=as_state, nu=as_state,
                    count=ParamSpec((), "int32", "zeros"))


def init_opt_state(params: Any, cfg: AdamWConfig) -> OptState:
    dtype = DTYPES[cfg.state_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    count_device = tree_flatten(params)[0][0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=count_device))


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(grads: Any, params: Any, state: OptState,
                 cfg: AdamWConfig) -> tuple:
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds
    the pre-clip ``grad_norm`` and the step's ``lr`` (float32 scalars)."""
    with trace_mod.span("optimizer.adamw"):
        flat_p, treedef = tree_flatten(params)
        flat_g = tree_flatten(grads)[0]
        flat_m = tree_flatten(state.mu)[0]
        flat_v = tree_flatten(state.nu)[0]
        # Global-norm clip in f32.
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in flat_g))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        count = state.count + 1
        lr = _schedule(cfg, count)
        c1 = 1.0 - cfg.b1 ** count.float()
        c2 = 1.0 - cfg.b2 ** count.float()
        sdtype = DTYPES[cfg.state_dtype]

        def upd(p, g, m, v):
            gf = g.float() * scale
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            step = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
            if cfg.weight_decay and p.dim() >= 2:      # decay matrices only
                step = step + cfg.weight_decay * p.float()
            new_p = p.float() - lr * step
            return new_p.to(p.dtype), mf.to(sdtype), vf.to(sdtype)

        out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                      flat_v, strict=True)]
        new_p, new_m, new_v = (tree_unflatten(treedef, [o[i] for o in out])
                               for i in range(3))
        return new_p, OptState(new_m, new_v, count), {"grad_norm": gnorm,
                                                      "lr": lr}
