"""The program's own spans in a profiled slice, read against its device ops.

The program names its stages with ``utils/profiling.annotate``: a
``torch.profiler.record_function`` span, so a ``user_annotation`` event of
the chrome trace on the clock of the CUPTI kernel events.  A span is the
program's when its name starts with one of :data:`PROGRAM_PREFIXES`; the
drivers' own ``bench/*`` spans enclose them and are not read here.  At
each moment the innermost open program span is the open one that started
last.

- Idle time: the slice's host extent (the first host event's start to the
  last one's end, as ``harness.breakdown`` takes it) less the union of the
  device ops' intervals, each idle stretch put down to the innermost
  program span open over it, piece by piece.
- Device time: each device op (kernel, copy, fill) put down to the
  innermost program span open where the host launched it: the
  ``cuda_runtime`` or ``cuda_driver`` event with the op's ``correlation``.

A trace without the spans a metric reads (the program before its spans)
reads None.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Callable, Dict, List, Optional, Tuple

from harness import HOST_CATEGORIES

PROGRAM_PREFIXES = ("sweep/", "classify/", "smoothing/", "train/")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

Segment = Tuple[float, float, str]


def _interval(e: dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def program_spans(trace) -> List[Segment]:
    """(start, end, name) of the program's spans, in start order (us)."""
    return sorted((*_interval(e), e["name"]) for e in trace.events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(PROGRAM_PREFIXES))


def innermost(spans: List[Segment]) -> List[Segment]:
    """The time the spans cover cut into (start, end, name) pieces, each
    with the innermost program span open over it; in time order."""
    points = sorted({p for a, b, _ in spans for p in (a, b)})
    out: List[Segment] = []
    open_: list = []  # a heap of (-start, end, name): the latest start on top
    i = 0
    for a, b in zip(points, points[1:]):
        while i < len(spans) and spans[i][0] <= a:
            heapq.heappush(open_, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        if open_:
            name = open_[0][2]
            if out and out[-1][2] == name and out[-1][1] == a:
                out[-1] = (out[-1][0], b, name)
            else:
                out.append((a, b, name))
    return out


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The stretches of the slice's host extent in which no device op runs
    (us), in time order."""
    host = [_interval(e) for e in trace.events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES]
    if not host:
        return []
    start, stop = min(a for a, _ in host), max(b for _, b in host)
    gaps, end = [], start
    for a, b in sorted(_interval(e) for e in trace.device):
        if a > end:
            gaps.append((end, min(a, stop)))
        end = max(end, b)
        if end >= stop:
            break
    if end < stop:
        gaps.append((end, stop))
    return [(a, b) for a, b in gaps if b > a]


def idle_us_by_span(trace, spans: List[Segment]) -> Dict[str, float]:
    """Idle microseconds under each innermost program span."""
    pieces = innermost(spans)
    out: Dict[str, float] = {}
    j = 0
    for a, b in idle_intervals(trace):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + hi - lo
            k += 1
    return out


def stall_pct(trace, reads: Callable[[str], bool]) -> Optional[float]:
    """The share of the slice's wall (%) in which no device op runs and the
    innermost open program span is one that ``reads`` names; None without
    device ops or without such a span."""
    spans = program_spans(trace)
    if not trace.device or not any(reads(name) for *_, name in spans):
        return None
    idle = idle_us_by_span(trace, spans)
    return 100.0 * sum(us for name, us in idle.items() if reads(name)) / 1e6 / trace.wall_s


def device_ms_by_span(trace, spans: List[Segment]) -> Dict[str, float]:
    """Device milliseconds of the ops launched under each innermost program
    span (ops whose launch lies under none are left out)."""
    launches = {}
    for e in trace.events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
    pieces = innermost(spans)
    starts = [a for a, _, _ in pieces]
    out: Dict[str, float] = {}
    for e in trace.device:
        at = launches.get((e.get("args") or {}).get("correlation"))
        if at is None:
            continue
        k = bisect.bisect_right(starts, at) - 1
        if k >= 0 and at < pieces[k][1]:
            name = pieces[k][2]
            out[name] = out.get(name, 0.0) + float(e["dur"]) / 1e3
    return out


def device_ms_per_audio_min(trace, name: str) -> Optional[float]:
    """Device milliseconds of the ops launched under the program span
    ``name``, per audio minute of the slice; None without device ops,
    without the slice's audio or without the span."""
    spans = program_spans(trace)
    audio_s = trace.work.get("audio_s")
    if not trace.device or not audio_s or not any(n == name for *_, n in spans):
        return None
    return device_ms_by_span(trace, spans).get(name, 0.0) / (audio_s / 60.0)
