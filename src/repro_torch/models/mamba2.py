"""Mamba-2 block (SSD, state-space duality; arXiv:2405.21060).

Prefill runs the chunked SSD scan: quadratic attention-like work inside
fixed-size chunks plus a linear inter-chunk state recurrence (a Python
loop over the chunks, where the reference runs ``lax.scan``).  Decode is
the O(1) one-step recurrence on the (B, H, P, N) state.  Plain PyTorch,
as the reference is plain ``jnp``: no kernel of its own.

``ssd_reference`` is the naive sequential recurrence, the test oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.attention import CacheSpec
from repro_torch.models.layers import dense, rms_norm, spec

__all__ = ["Mamba2Config", "mamba2_specs", "mamba2_forward", "mamba2_decode",
           "Mamba2State", "init_mamba2_state_specs", "ssd_chunked",
           "ssd_reference"]


class Mamba2Config(NamedTuple):
    d_model: int
    d_inner: int          # expand * d_model
    head_dim: int = 64    # P
    d_state: int = 128    # N
    n_groups: int = 1     # G
    d_conv: int = 4

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def proj_dim(self) -> int:
        # [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
        return (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.n_heads)


class Mamba2State(NamedTuple):
    ssm: torch.Tensor     # (B, H, P, N) float32
    conv: torch.Tensor    # (B, d_conv - 1, conv_dim) rolling window
    length: torch.Tensor  # () int32


def init_mamba2_state_specs(cfg: Mamba2Config, batch: int,
                            dtype: str) -> Mamba2State:
    return Mamba2State(
        ssm=CacheSpec((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                      "float32"),
        conv=CacheSpec((batch, cfg.d_conv - 1, cfg.conv_dim), dtype),
        length=CacheSpec((), "int32"))


def mamba2_specs(cfg: Mamba2Config, dtype: str) -> dict:
    return {
        "in_proj": spec((cfg.d_model, cfg.proj_dim), dtype),
        "conv_w": spec((cfg.d_conv, cfg.conv_dim), dtype),
        "conv_b": spec((cfg.conv_dim,), dtype, init="zeros"),
        "a_log": spec((cfg.n_heads,), "float32", init="zeros"),
        "d_skip": spec((cfg.n_heads,), "float32", init="ones"),
        "dt_bias": spec((cfg.n_heads,), "float32", init="zeros"),
        "norm": spec((cfg.d_inner,), "float32", init="ones"),
        "out_proj": spec((cfg.d_inner, cfg.d_model), dtype),
    }


def _split_proj(cfg: Mamba2Config, zxbcdt: torch.Tensor) -> tuple:
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == cfg.n_heads
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) with kernel (K, C)."""
    k, l = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + l, :] * conv_w[i][None, None, :]
              for i in range(k))
    return F.silu(out + conv_b[None, None, :])


def _ssm_inputs(cfg: Mamba2Config, params, xbc_conv: torch.Tensor,
                dt_raw: torch.Tensor) -> tuple:
    """Split the conv output; per-step dt and log-decay (float32)."""
    b, l, _ = xbc_conv.shape
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    x = xbc_conv[..., :di].reshape(b, l, cfg.n_heads, cfg.head_dim)
    bb = xbc_conv[..., di: di + gn].reshape(b, l, cfg.n_groups, cfg.d_state)
    cc = xbc_conv[..., di + gn:].reshape(b, l, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"].float())                       # (H,) < 0
    return x, bb, cc, dt, dt * a[None, None, :]


def ssd_chunked(x, bb, cc, dt, log_decay, *, chunk: int = 256) -> tuple:
    """Chunked SSD scan.

    x: (B, L, H, P) f32; bb/cc: (B, L, G, N) f32; dt/log_decay: (B, L, H)
    f32.  Returns y (B, L, H, P) f32 and the final state (B, H, P, N).
    """
    b, l, h, p = x.shape
    g, n = bb.shape[2], bb.shape[3]
    chunk = min(chunk, l)
    nc = -(-l // chunk)
    lp = nc * chunk
    if lp != l:                                   # zero-pad to whole chunks
        x, bb, cc = (F.pad(t, (0, 0, 0, 0, 0, lp - l)) for t in (x, bb, cc))
        dt, log_decay = (F.pad(t, (0, 0, 0, lp - l)) for t in (dt, log_decay))
    # Groups -> heads, dt-weighted inputs, then (nc, B, chunk, ...).
    bbh = torch.repeat_interleave(bb, h // g, dim=2)
    cch = torch.repeat_interleave(cc, h // g, dim=2)

    def to_chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:]).transpose(0, 1)

    xc, bc, ccc = to_chunks(x * dt[..., None]), to_chunks(bbh), to_chunks(cch)
    ldc = to_chunks(log_decay)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for xi, bi, ci, ld in zip(xc, bc, ccc, ldc):
        cum = torch.cumsum(ld, dim=1)                 # (B, Q, H)
        total = cum[:, -1]                            # (B, H)
        # Intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j.
        li = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Q, Q, H)
        lmat = torch.where(causal, torch.exp(li), 0.0)
        scores = torch.einsum("bqhn,bkhn->bqkh", ci, bi) * lmat
        y_intra = torch.einsum("bqkh,bkhp->bqhp", scores, xi)
        # Inter-chunk: the carried state's contribution.
        y_inter = torch.einsum("bqhn,bhpn->bqhp",
                               ci * torch.exp(cum)[..., None], state)
        # State update: S = sum_j exp(total - cum_j) B_j x_j^T.
        decay_out = torch.exp(total[:, None, :] - cum)
        s_new = torch.einsum("bqhn,bqhp->bhpn", bi * decay_out[..., None], xi)
        state = torch.exp(total)[..., None, None] * state + s_new
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, lp, h, p)[:, :l]
    return y, state


def ssd_reference(x, bb, cc, dt, log_decay) -> tuple:
    """Naive sequential recurrence (test oracle): an O(L) Python loop."""
    b, l, h, p = x.shape
    hpg = h // bb.shape[2]
    state = torch.zeros((b, h, p, bb.shape[3]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(l):
        a_t = torch.exp(log_decay[:, t])                       # (B, H)
        bt = torch.repeat_interleave(bb[:, t], hpg, dim=1)     # (B, H, N)
        ct = torch.repeat_interleave(cc[:, t], hpg, dim=1)
        xt = x[:, t] * dt[:, t][..., None]                     # (B, H, P)
        state = (a_t[..., None, None] * state
                 + torch.einsum("bhn,bhp->bhpn", bt, xt))
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ct))
    return torch.stack(ys, dim=1), state


def mamba2_forward(cfg: Mamba2Config, params, x: torch.Tensor, *,
                   chunk: int = 256, return_state: bool = False):
    """Full block: x (B, L, d_model) -> (B, L, d_model) [, final state].

    The fused [z|x|B|C|dt] projection runs as per-stream weight slices,
    as the reference does; the depthwise conv commutes with the channel
    split, so the math is that of one projection.
    """
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    w, cw, cb = params["in_proj"], params["conv_w"], params["conv_b"]
    z = dense(x, w[:, :di])
    xp = _causal_conv(dense(x, w[:, di: 2 * di]), cw[:, :di], cb[:di])
    bp = _causal_conv(dense(x, w[:, 2 * di: 2 * di + gn]),
                      cw[:, di: di + gn], cb[di: di + gn])
    cp = _causal_conv(dense(x, w[:, 2 * di + gn: 2 * di + 2 * gn]),
                      cw[:, di + gn:], cb[di + gn:])
    dt_raw = dense(x, w[:, 2 * di + 2 * gn:])
    b_, l_ = x.shape[:2]
    xi = xp.reshape(b_, l_, cfg.n_heads, cfg.head_dim)
    bb = bp.reshape(b_, l_, cfg.n_groups, cfg.d_state)
    cc = cp.reshape(b_, l_, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    ld = dt * -torch.exp(params["a_log"].float())[None, None, :]
    y, state = ssd_chunked(xi.float(), bb.float(), cc.float(), dt, ld,
                           chunk=chunk)
    y = y + params["d_skip"][None, None, :, None] * xi.float()
    y = y.reshape(b_, l_, cfg.d_inner).to(x.dtype)
    out = _out_proj(params, y, z)
    return (out, state) if return_state else out


def _in_proj(cfg: Mamba2Config, params, x: torch.Tensor) -> tuple:
    """Decode stage 1: the fused projection, split into (z, xbc, dt)."""
    return _split_proj(cfg, dense(x, params["in_proj"]))


def _conv_step(params, conv: torch.Tensor, xbc_new: torch.Tensor) -> tuple:
    """Decode stage 2: the rolling causal conv window -> (conv output
    (B, 1, C), new window)."""
    window = torch.cat([conv, xbc_new.to(conv.dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"])
    return (F.silu(conv_out + params["conv_b"][None, :])[:, None, :],
            window[:, 1:, :])


def _ssm_step(cfg: Mamba2Config, params, xbc: torch.Tensor,
              dt_raw: torch.Tensor, ssm: torch.Tensor) -> tuple:
    """Decode stage 3: one step of the recurrence -> (y (B, H, P) f32
    with the skip term, new state)."""
    xi, bb, cc, dt, ld = _ssm_inputs(cfg, params, xbc, dt_raw)
    hpg = cfg.n_heads // cfg.n_groups
    a_t = torch.exp(ld[:, 0])                                  # (B, H)
    bt = torch.repeat_interleave(bb[:, 0], hpg, dim=1).float()
    ct = torch.repeat_interleave(cc[:, 0], hpg, dim=1).float()
    xt = (xi[:, 0] * dt[:, 0][..., None]).float()
    new_ssm = (a_t[..., None, None] * ssm
               + torch.einsum("bhn,bhp->bhpn", bt, xt))
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, ct)
    return y + params["d_skip"][None, :, None] * xi[:, 0].float(), new_ssm


def _out_proj(params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Decode stage 4: gated norm and the output projection."""
    return dense(rms_norm(y * F.silu(z), params["norm"]), params["out_proj"])


def mamba2_decode(cfg: Mamba2Config, params, x: torch.Tensor,
                  state: Mamba2State) -> tuple:
    """One-token decode: x (B, 1, d_model) -> (out, new state), in four
    stages (projection, conv window, SSM step, output projection)."""
    z, xbc_new, dt_raw = _in_proj(cfg, params, x)
    xbc, new_conv = _conv_step(params, state.conv, xbc_new)
    y, new_ssm = _ssm_step(cfg, params, xbc, dt_raw, state.ssm)
    y = y.reshape(x.shape[0], 1, cfg.d_inner).to(x.dtype)
    out = _out_proj(params, y, z)
    return out, Mamba2State(new_ssm, new_conv, state.length + 1)
