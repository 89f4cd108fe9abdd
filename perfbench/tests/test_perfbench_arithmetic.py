"""The arithmetic: window rates, tails over every request, idle share
as a union of device intervals, the FLOP and byte counts at hand-worked
smoke shapes, and the reduction of a trace to per-layer readings."""

import gc
import json
import math
from pathlib import Path

import numpy as np
import pytest

from perfbench import costs, harness, stats, tracing
from perfbench.readings import Readings

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_matches_numpy_linear(q):
    xs = list(np.random.default_rng(q).exponential(size=137))
    assert stats.percentile(xs, q) == pytest.approx(
        float(np.percentile(xs, q, method="linear")), rel=1e-12)


def test_failed_requests_are_misses():
    assert stats.percentile([1.0, 2.0, math.inf, math.inf], 90) == math.inf
    assert stats.percentile([1.0, 2.0, 3.0, math.inf], 50) == 2.5


def test_ttft_counts_unfinished_and_failed():
    reqs = [{"due": 0.0, "first": 0.5, "failed": False},
            {"due": 1.0, "first": None, "failed": False},     # still waiting
            {"due": 2.0, "first": 9.0, "failed": False},      # after close
            {"due": 3.0, "first": None, "failed": True}]
    assert stats.ttft_values(reqs, window_end=5.0) == [0.5, 4.0, 3.0,
                                                       math.inf]


def test_token_gaps_inside_the_window_only():
    times = [0.5, 1.0, 1.5, 2.5, 4.0]
    assert stats.token_gaps(times, 1.0, 3.0) == [0.5, 1.0]


def test_chunk_rates_cover_the_window():
    times = [0.5, 1.0, 4.9, 5.1, 9.0, 10.5, 12.0]
    # (0, 12] in slices of 5 s, the last taking the remainder: 3 in the
    # first 5 s, 4 in the last 7 s.
    assert harness.chunk_rates(times, 0.0, 12.0) == [0.6, 4 / 7]
    assert harness.chunk_rates([], 0.0, 3.0) == [0.0]


def test_collections_count_each_generation():
    with harness.Collections() as seen:
        gc.collect(0)
        gc.collect(2)
    assert seen.count == [1, 0, 1]
    assert all(s >= 0 for s in seen.seconds)
    gc.collect(2)
    assert seen.reading()["count"] == [1, 0, 1]


def test_idle_share_is_a_union_not_a_sum():
    # Two overlapping kernels and one apart: busy 3 us of a 10 us window.
    assert stats.union_length([(0, 2), (1, 2), (5, 6)]) == 3
    assert stats.merged([(5, 6), (0, 2), (1, 2)]) == [(0, 2), (5, 6)]


def _trace():
    """Host ranges: pageio [0, 10], model [10, 20] inside engine [0, 30];
    launches at host 1, 11, 25 queue kernels that run on the device at
    40-44, 44-50 (overlapping 46-50 with the third) and 46-52."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "engine", "ts": 0,
         "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "pageio", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "model", "ts": 10,
         "dur": 10},
    ]
    for corr, (host, start, end) in enumerate([(1, 40, 44), (11, 44, 50),
                                               (25, 46, 52)]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": host, "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                   "ts": start, "dur": end - start,
                   "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "ts": 60, "dur": 2, "args": {"correlation": 99}})
    return {"traceEvents": ev}


def test_segment_attribution_and_idle():
    seg = tracing.Segment(_trace(), wall_s=100e-6, units=2,
                          layers={"engine", "pageio", "model"})
    assert seg.launch_count == 3                   # the copy is no kernel
    assert seg.layer_us == {"pageio": 4.0, "model": 6.0, "engine": 6.0}
    assert seg.unattributed == 1                   # the copy's launch
    assert seg.busy_s() == pytest.approx(14e-6)    # 40-52 and 60-62
    assert seg.range_at(5) == "pageio"             # innermost
    assert seg.range_at(25) == "engine"
    assert seg.range_at(35) is None
    assert seg.idle_gaps() == [["outside the named layers",
                                pytest.approx(8e-6)]]
    r = Readings(window_s=1.0, units=5, device=seg,
                 layers=seg, work={"pageio": (2 * 3.35e12 * 1e-6, 0.0)})
    assert r.idle_share() == pytest.approx(86.0)
    assert r.launches_per_unit() == 1.5
    assert r.layer_ms_per_unit("model") == pytest.approx(3e-3)
    # Per tick 3.35e6 bytes = 1 us of HBM time over 2 us of device time.
    assert r.roofline_share("pageio") == pytest.approx(50.0)
    assert r.bounds["pageio"] == "bytes"
    assert r.layer_ms_per_unit("absent") is None    # never 0
    assert r.mfu() is None


def test_minitron_counts_by_hand():
    c = json.loads((CONFIGS / "minitron-4b.json").read_text())
    d, kv, hd, f, v = 3072, 8, 128, 9216, 256000
    per_layer = d * d + 2 * d * kv * hd + d * d + 3 * d * f
    assert costs.lm_matmul_params(c) == 32 * per_layer + d * v
    assert costs.lm_matmul_params(c) == 4_309_647_360
    assert costs.lm_decode_flops(c, 1000) == 2 * 4_309_647_360 \
        + 4 * 24 * 128 * 1000 * 32
    # A page: 8 tokens x 8 heads x 128 x 2 bytes, k and v, 32 layers.
    assert costs.kv_page_bytes(c, 8, 64) == 1 << 20
    nbytes, ops = costs.page_crossing_work(c, c["deployment"], 8 * 212, 8)
    assert nbytes == (8 * 212 + 8) * ((1 << 20) + 8)
    assert ops == (8 * 212 + 8) * (1 << 20) / 64 * (2 * 1056 + 4 * 16 + 16)
    t, kind = costs.bound_s(nbytes, ops)
    assert kind == "operations" and t == pytest.approx(ops / 67e12)


def test_smoke_counts_by_hand():
    c = {"hidden_size": 96, "num_attention_heads": 6,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 192,
         "num_hidden_layers": 2, "vocab_size": 256}
    per_layer = 96 * 96 + 2 * 96 * 32 + 96 * 96 + 3 * 96 * 192
    assert costs.lm_matmul_params(c) == 2 * per_layer + 96 * 256
    # Prefill of 3 tokens: contexts 1, 2, 3.
    assert costs.lm_prefill_flops(c, 3) == pytest.approx(
        3 * 2 * costs.lm_matmul_params(c) + 4 * 96 * 2 * (1 + 2 + 3))
    assert costs.kv_page_bytes(c, 4, 64) == 2 * 2 * 256   # 4 x 2 x 16 x 2


def test_seamless_counts_by_hand():
    c = json.loads((CONFIGS / "seamless-m4t-large-v2.json").read_text())
    enc, dec = costs.encdec_layer_params(c)
    assert enc == 4 * 1024 * 1024 + 3 * 1024 * 8192
    assert dec == 8 * 1024 * 1024 + 3 * 1024 * 8192
    b, s, t = 16, 512, 256
    flops = costs.encdec_train_flops(c, b, s, t)
    matmul = b * (s * 24 * enc + t * (24 * dec + 1024 * 256102))
    attn = b * (24 * 4 * 1024 * s * s + 24 * 4 * 1024 * t * (t + 1) / 2
                + 24 * 4 * 1024 * t * s)
    assert flops == 6 * matmul + 3 * attn
    assert 6.0e13 < flops < 6.6e13
    # AdamW: bf16 parameter and gradient, float32 moments: 22 bytes each.
    assert costs.adamw_bytes(10, 2, 2, 4) == 220
    nbytes, ops = costs.weights_crossing_work(6400, 64)
    assert nbytes == 4 * 6400 and ops == 2 * 100 * (2 * 1056 + 80)


def test_mfu_over_the_window():
    r = Readings(window_s=2.0, units=10,
                 model_flops=2 * 989e12 * 0.25)
    assert r.mfu() == pytest.approx(25.0)
