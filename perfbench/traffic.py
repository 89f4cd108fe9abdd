"""The traffic generators: one general generator per kind of load, read
from a cell's data file (``perfbench/workloads/<cell>.json``).

Every seed gets the same work in another order.  Lengths and
inter-arrival gaps are drawn by strata: each block of ``strata``
requests holds every stratum's midpoint once, shuffled by the seed, so
two seeds differ in which request gets which size and when, not in how
much there is.  Token ids, tenants' order and the bursts' phases come
from the seed.

* ``closed_loop``: ``clients`` callers, each sending its next request
  when the last one finished (an offline batch);
* ``open_loop``: arrivals on a schedule, Poisson in shape, at a fixed
  mean rate with bursts (``burst_factor`` x the base rate for
  ``burst_s`` seconds once in every ``burst_period_s``), from tenants in
  fixed shares;
* ``train``: seeded batches of source frames and target tokens.
"""

from __future__ import annotations

import math

import numpy as np


def _stratified(rng, n: int, strata: int, quantile) -> list:
    """``n`` values: blocks of ``strata`` midpoints ``quantile((j +
    0.5) / strata)``, each block in an order drawn from ``rng``."""
    mids = [quantile((j + 0.5) / strata) for j in range(strata)]
    out: list = []
    while len(out) < n:
        out.extend(mids[i] for i in rng.permutation(strata))
    return out[:n]


def lengths(rng, n: int, spec: dict, strata: int) -> list:
    """Token counts: ``spec`` is ``{"min", "max", "dist": "uniform" |
    "log_uniform"}``."""
    lo, hi = spec["min"], spec["max"]
    if spec.get("dist", "uniform") == "log_uniform":
        def q(u):
            return math.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
    else:
        def q(u):
            return lo + (hi - lo) * u
    return [int(min(hi, max(lo, round(x))))
            for x in _stratified(rng, n, strata, q)]


class Requests:
    """The request stream of a serving cell: ``next()`` gives
    ``(prompt, max_new_tokens, tenant)``."""

    def __init__(self, wl: dict, vocab: int, seed: int, n: int):
        rng = np.random.default_rng([int(seed), 1])
        strata = wl["strata"]
        self._prompts = lengths(rng, n, wl["prompt_tokens"], strata)
        self._outputs = lengths(rng, n, wl["output_tokens"], strata)
        shares = wl.get("tenant_shares", [1.0])
        per_block = [round(s * strata) for s in shares]
        if sum(per_block) != strata:
            raise ValueError(f"tenant shares {shares} do not divide a block "
                             f"of {strata}")
        block = [t for t, k in enumerate(per_block) for _ in range(k)]
        self._tenants = _stratified(rng, n, strata, lambda u: block[
            min(int(u * strata), strata - 1)])
        self._tok_rng = np.random.default_rng([int(seed), 2])
        self._vocab = vocab
        self._i = 0

    def __len__(self) -> int:
        return len(self._prompts)

    def next(self) -> tuple:
        i = self._i
        if i >= len(self._prompts):
            raise RuntimeError("the request stream ran out: raise the "
                               "cell's stream length")
        self._i += 1
        prompt = self._tok_rng.integers(1, self._vocab,
                                        self._prompts[i]).tolist()
        return prompt, self._outputs[i], self._tenants[i]


def arrivals(wl: dict, seed: int, horizon_s: float) -> list:
    """Scheduled arrival times in ``[0, horizon_s)`` of the open loop.

    Unit-rate load times (stratified exponential gaps) are mapped
    through the cumulative intensity, which is ``base`` outside bursts
    and ``burst_factor * base`` inside; each period holds one burst at
    a phase drawn from the seed, so every seed has the same total
    intensity over whole periods."""
    rng = np.random.default_rng([int(seed), 3])
    rate = wl["mean_rate"]
    factor, burst, period = (wl["burst_factor"], wl["burst_s"],
                             wl["burst_period_s"])
    base = rate / (1.0 + (factor - 1.0) * burst / period)
    n_periods = int(math.ceil(horizon_s / period))
    starts = [k * period + rng.uniform(0.0, period - burst)
              for k in range(n_periods)]
    # Piecewise-linear cumulative intensity: breakpoints (t, Lambda(t)).
    points, t, lam = [(0.0, 0.0)], 0.0, 0.0
    for s in starts:
        for edge, r in ((s, base), (s + burst, base * factor)):
            lam += (edge - t) * r
            t = edge
            points.append((t, lam))
    end = n_periods * period
    lam += (end - t) * base
    points.append((end, lam))
    gaps = _stratified(rng, int(lam * 1.2) + wl["strata"], wl["strata"],
                       lambda u: -math.log(1.0 - u))
    out, u, j = [], 0.0, 0
    for g in gaps:
        u += g
        while j + 1 < len(points) and points[j + 1][1] < u:
            j += 1
        if j + 1 >= len(points):
            break
        (t0, l0), (t1, l1) = points[j], points[j + 1]
        t = t0 + (u - l0) / (l1 - l0) * (t1 - t0)
        if t >= horizon_s:
            break
        out.append(t)
    return out


def train_batch(spec: dict, c: dict, seed: int, step: int, device):
    """Batch ``step`` of the training cell, made on ``device`` from
    ``(seed, step)``: float32 source frames (B, S, d), target tokens
    (B, T) and their next-token labels, every row distinct."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + step) % (1 << 63))
    b, s, t = spec["batch"], spec["src_frames"], spec["tgt_tokens"]
    toks = torch.randint(1, c["vocab_size"], (b, t + 1), generator=gen,
                         device=device, dtype=torch.int64)
    src = torch.randn((b, s, c["hidden_size"]), generator=gen,
                      device=device, dtype=torch.float32)
    return {"src_embeds": src, "tgt_tokens": toks[:, :-1].to(torch.int32),
            "labels": toks[:, 1:].to(torch.int32)}
