"""The arithmetic of the end-to-end metrics: rates over the whole window,
tails over every request, unions of device intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation
    between closest ranks (numpy's default method); ``inf`` entries
    (requests that failed) sort last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merged(intervals) -> list:
    """``(start, end)`` intervals merged where they overlap, in order."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    return sum(e - s for s, e in merged(intervals))


def ttft_values(requests, window_end: float) -> list:
    """Seconds from each request's scheduled arrival to its first token;
    a request still without one at ``window_end`` counts with the time
    it has waited, a failed or refused one as ``inf``."""
    out = []
    for r in requests:
        if r["failed"]:
            out.append(math.inf)
        elif r["first"] is not None and r["first"] <= window_end:
            out.append(r["first"] - r["due"])
        else:
            out.append(window_end - r["due"])
    return out


def token_gaps(token_times, start: float, end: float) -> list:
    """Gaps between consecutive output tokens of one request whose both
    tokens fall in ``[start, end]``."""
    return [b - a for a, b in zip(token_times, token_times[1:])
            if a >= start and b <= end]
