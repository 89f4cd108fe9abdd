"""The generators: deterministic by seed, the requested ranges and mix,
the same work for every seed in another order."""

import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from perfbench import traffic

WL = Path(__file__).resolve().parents[1] / "workloads"


def load(name):
    return json.loads((WL / f"{name}.json").read_text())


def draw(wl, seed, n):
    reqs = traffic.Requests(wl, 256000, seed, n)
    return [reqs.next() for _ in range(n)]


@pytest.mark.parametrize("cell", ["minitron-4b.long-batch",
                                  "minitron-4b.short-batch",
                                  "minitron-4b.tenant-chat",
                                  "minitron-4b.tenant-steady"])
def test_requests_deterministic_and_in_range(cell):
    wl = load(cell)
    n = 4 * wl["strata"]
    a, b = draw(wl, 2_147_483_901, n), draw(wl, 2_147_483_901, n)
    assert a == b
    c = draw(wl, 7, n)
    assert [len(p) for p, _, _ in a] != [len(p) for p, _, _ in c]
    for prompt, n_new, _ in a:
        assert wl["prompt_tokens"]["min"] <= len(prompt) \
            <= wl["prompt_tokens"]["max"]
        assert wl["output_tokens"]["min"] <= n_new \
            <= wl["output_tokens"]["max"]
        assert all(1 <= t < 256000 for t in prompt)
    # Every seed gets the same sizes, in another order.
    assert Counter(len(p) for p, _, _ in a) == Counter(len(p) for p, _, _ in c)
    assert Counter(m for _, m, _ in a) == Counter(m for _, m, _ in c)


def test_uniform_strata_cover_the_range():
    wl = {"prompt_tokens": {"min": 768, "max": 1536, "dist": "uniform"},
          "output_tokens": {"min": 96, "max": 160, "dist": "uniform"},
          "strata": 16}
    sizes = sorted(len(p) for p, _, _ in draw(wl, 3, wl["strata"]))
    assert sizes[0] == 792 and sizes[-1] == 1512      # stratum midpoints
    assert len(set(sizes)) == wl["strata"]


def test_long_batch_keeps_its_sources_medians():
    """Log-uniform strata: the two middle midpoints' geometric mean is
    the source's median (1020 prompt tokens, 129 answer tokens), and no
    context passes the slot's pages (4096 tokens)."""
    wl = load("minitron-4b.long-batch")
    reqs = draw(wl, 2_147_483_923, wl["strata"])
    for sizes, median in ((sorted(len(p) for p, _, _ in reqs), 1020),
                          (sorted(m for _, m, _ in reqs), 129)):
        mid = len(sizes) // 2
        assert abs((sizes[mid - 1] * sizes[mid]) ** 0.5 - median) < 3
    assert wl["prompt_tokens"]["max"] + wl["output_tokens"]["max"] \
        <= wl["pages_per_slot"] * 8


def test_spread_order_keeps_every_stretch_alike():
    """``"order": "spread"``: any ``strata`` requests in a row hold each
    midpoint once, and the long prompts (past 2048 tokens) come every
    ``strata / 2`` requests, whatever the seed."""
    wl = load("minitron-4b.long-batch")
    s = wl["strata"]
    for seed in (2_147_483_929, 11, 12):
        sizes = [len(p) for p, _, _ in draw(wl, seed, 4 * s)]
        assert all(sorted(sizes[i:i + s]) == sorted(sizes[:s])
                   for i in range(3 * s))
        long = [i for i, x in enumerate(sizes) if x > 2048]
        assert {b - a for a, b in zip(long, long[1:])} == {s // 2}


def test_log_uniform_prompts_and_tenant_shares():
    wl = load("minitron-4b.tenant-chat")
    reqs = draw(wl, 11, 5 * wl["strata"])
    sizes = sorted(len(p) for p, _, _ in reqs)
    # log-uniform over 16-192: the median stratum sits near sqrt(16 * 192).
    assert 45 <= sizes[len(sizes) // 2] <= 65
    shares = Counter(t for _, _, t in reqs)
    assert shares == {0: 55, 1: 15, 2: 15, 3: 15}


def test_arrivals_rate_bursts_and_seed():
    wl = load("minitron-4b.tenant-chat")
    horizon = 200.0
    a = traffic.arrivals(wl, 5, horizon)
    assert a == traffic.arrivals(wl, 5, horizon)
    b = traffic.arrivals(wl, 6, horizon)
    assert a != b
    assert a == sorted(a) and 0 <= a[0] and a[-1] < horizon
    for times in (a, b):
        rate = len(times) / horizon
        assert abs(rate - wl["mean_rate"]) / wl["mean_rate"] < 0.05
    # The same work for every seed: arrival counts within a few percent.
    assert abs(len(a) - len(b)) <= 0.03 * len(a)
    # Bursts: the busiest 2 s of each 10 s period hold about 3/7 of it.
    busiest = []
    for k in range(int(horizon // 10)):
        in_period = [t - 10 * k for t in a if 10 * k <= t < 10 * (k + 1)]
        best = max(sum(1 for t in in_period if s <= t < s + 2)
                   for s in [x / 10 for x in range(81)])
        busiest.append(best / max(1, len(in_period)))
    assert 0.3 < sum(busiest) / len(busiest) < 0.6


def test_steady_arrivals_have_no_bursts():
    wl = load("minitron-4b.tenant-steady")
    horizon = 200.0
    a = traffic.arrivals(wl, 5, horizon)
    b = traffic.arrivals(wl, 6, horizon)
    assert a != b and a == sorted(a)
    assert abs(len(a) / horizon - wl["mean_rate"]) / wl["mean_rate"] < 0.05
    assert abs(len(a) - len(b)) <= 0.03 * len(a)
    # Every 10 s holds about a tenth of the load: no period is a burst.
    per = [sum(1 for t in a if 10 * k <= t < 10 * (k + 1))
           for k in range(int(horizon // 10))]
    assert max(per) < 2.0 * wl["mean_rate"] * 10


def test_train_batches_by_seed_and_step():
    c = {"vocab_size": 1000, "hidden_size": 8}
    spec = {"batch": 4, "src_frames": 6, "tgt_tokens": 5}
    cpu = torch.device("cpu")
    a = traffic.train_batch(spec, c, 9, 0, cpu)
    b = traffic.train_batch(spec, c, 9, 0, cpu)
    for k in a:
        assert torch.equal(a[k], b[k])
    nxt = traffic.train_batch(spec, c, 9, 1, cpu)
    assert not torch.equal(a["tgt_tokens"], nxt["tgt_tokens"])
    assert a["src_embeds"].shape == (4, 6, 8)
    assert torch.equal(a["tgt_tokens"][:, 1:], a["labels"][:, :-1])
    rows = {tuple(r.tolist()) for r in a["tgt_tokens"]}
    assert len(rows) == 4
