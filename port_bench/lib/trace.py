"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer readers and the result line take: device busy time (the union of
the intervals in which any operation ran on the device), device time by
kernel category and by kernel, and the idle gaps by the host operation that
was running when each began. (Spans are timed by CUDA events, ``run.py``.)

The trace is read in memory and never written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_SPAN = "bench.window"


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def categorize(name: str, categories: list) -> str:
    low = name.lower()
    for cat, patterns in categories:
        if any(p in low for p in patterns):
            return cat
    return "other"


def summarize(prof, categories: list, top: int = 10) -> dict:
    """``prof``: a finished ``torch.profiler.profile`` whose traced window
    ran inside ``record_function(WINDOW_SPAN)``; ``categories``: [(name,
    patterns)] in matching order."""
    from torch.autograd import DeviceType  # noqa: PLC0415

    events = prof.events()
    window = [e for e in events if e.name == WINDOW_SPAN
              and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name != WINDOW_SPAN:
                dev.append(e)
        elif e.name != WINDOW_SPAN:
            host.append(e)
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev]
    intervals = [(s, t) for s, t in intervals if t > s]
    busy = merged(intervals)
    busy_us = sum(t - s for s, t in busy)

    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in dev:
        d = e.time_range.end - e.time_range.start
        by_cat[categorize(e.name, categories)] += d
        by_name[e.name] += d

    gaps = []
    edge = w0
    for s, t in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    host.sort(key=lambda e: e.time_range.start)
    hstarts = [e.time_range.start for e in host]
    by_gap = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        i = bisect.bisect_right(hstarts, g0) - 1
        name, seen = "no host operation", 0
        while i >= 0 and seen < 20000:
            e = host[i]
            if e.time_range.end > g0:
                name = e.name
                break
            i -= 1
            seen += 1
        by_gap[name] += g1 - g0

    def top_s(table):
        rows = sorted(table.items(), key=lambda kv: -kv[1])[:top]
        return [[k[:160], v / 1e6] for k, v in rows]

    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "categories_s": {k: v / 1e6 for k, v in by_cat.items()},
            "breakdown": {"device_ops": top_s(by_name), "idle_gaps": top_s(by_gap)}}
