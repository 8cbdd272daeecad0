"""The traced run's reading of a `torch.profiler` trace.

The traced window runs from the start of the first of the benchmark's
own spans (`record_function` around each timed call) to the end of the
last. On the device timeline every kernel, copy and set is an interval;
the device is busy where any interval covers the time, and idle
elsewhere (the union of the intervals, never a sum of kernel times set
against a host time). The breakdown lists the device operations that took
most time, and the idle time by what the host was doing: each gap on the
device timeline is named by the innermost host operation or span around
its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

COPY_PREFIXES = ("Memcpy", "Memset")
NAMED_GAPS = 400
TOP = 10


def _events(prof, spans: Sequence[str]):
    """(device events, host events), each a list of (start_ns, end_ns,
    name). The device's copies of the host's spans (a `record_function`
    shows on the device timeline too) are annotations, not operations,
    and are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() in spans:
                continue
            device.append((start, end, e.name()))
        elif kind == DeviceType.CPU:
            host.append((start, end, e.name()))
    return device, host


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int):
    """(busy ns, gaps [(start, end)]) of the intervals clipped to [lo, hi]."""
    busy, gaps = 0, []
    cursor = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps


def _name_gaps(gaps, host, spans: Sequence[str]):
    """Idle seconds by the innermost host event around each gap's middle
    (the NAMED_GAPS longest gaps; the rest summed as 'other gaps')."""
    host = sorted(host)
    starts = [h[0] for h in host]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])
    named: Dict[str, float] = defaultdict(float)
    for s, e in longest[:NAMED_GAPS]:
        mid = (s + e) // 2
        best = None
        for h in host[:bisect.bisect_right(starts, mid)]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        name = best[2] if best is not None else "outside the benchmark's spans"
        named[name[:120]] += (e - s) / 1e9
    rest = sum(e - s for s, e in longest[NAMED_GAPS:]) / 1e9
    if rest:
        named["other gaps"] += rest
    return named


def summarize(prof, spans: Sequence[str]) -> dict:
    """What the per-layer metrics read off the trace: the traced window,
    the device's busy time in it, its kernels and copies by name, and the
    breakdown."""
    device, host = _events(prof, spans)
    marks = [h for h in host if h[2] in spans]
    if not marks:
        raise RuntimeError(f"the trace holds none of the spans {list(spans)}")
    lo, hi = min(m[0] for m in marks), max(m[1] for m in marks)
    inside = [d for d in device if d[1] > lo and d[0] < hi]
    busy, gaps = _union([(s, e) for s, e, _ in inside], lo, hi)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in inside:
        by_name[name] += (e - s) / 1e9
    kernels = [d for d in inside if not is_copy(d[2])]
    idle = _name_gaps(gaps, host, spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": len(kernels),
        "copies": len(inside) - len(kernels),
        "time_by_name": dict(by_name),
        "breakdown": {"device_ops": [[n[:120], v] for n, v in top],
                      "idle_gaps": [[n, v] for n, v in gaps_top]},
    }
