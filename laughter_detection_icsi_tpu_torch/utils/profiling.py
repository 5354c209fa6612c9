"""Profiling and observability: torch.profiler traces, spans and a throughput meter.

The port of the JAX package's ``utils/profiling.py``.  ``trace(dir)``
captures a ``torch.profiler`` trace of the host and, where there is one,
the CUDA device, and writes it into ``dir`` as a Chrome trace (open it in
Perfetto or chrome://tracing); any CLI enables it with ``--trace_dir``.
``annotate`` names a span in that timeline, on the clock of the device's
kernels; outside a profiler it records nothing and costs well under a
microsecond, so spans sit on the per-row path.  The throughput meter
counts in the unit the sweep is measured in, audio-seconds per
wall-second.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# torch.profiler.profile, emit_nvtx and emit_itt set this flag while they
# record; a torch without it gets every span recorded.
_HAS_FLAG = hasattr(_autograd_profiler, "_is_profiler_enabled")


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """``with trace('traces'):`` writes ``traces/trace_<pid>.json`` when
    the block ends (a no-op when ``trace_dir`` is falsy)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


class annotate:
    """``with annotate('sweep/upload'):`` names a span of the timeline.
    While a profiler records, the span is a ``torch.profiler.record_function``
    (in the Chrome trace beside the kernels it launched, on one clock);
    otherwise entering and leaving it do nothing, so a traced graph
    (``torch.export``) holds no profiler op."""

    __slots__ = ("name", "_region")

    def __init__(self, name: str):
        self.name = name
        self._region = None

    def __enter__(self) -> "annotate":
        if not _HAS_FLAG or _autograd_profiler._is_profiler_enabled:
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        region, self._region = self._region, None
        if region is not None:
            region.__exit__(*exc)


@dataclasses.dataclass
class ThroughputMeter:
    """Accumulates (audio seconds processed, wall seconds) and reports the
    realtime factor per chip."""

    n_chips: int = 1
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float) -> float:
        """Stop the current span, credit ``audio_seconds``; returns the
        span's realtime factor."""
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.audio_seconds += audio_seconds
        self.wall_seconds += dt
        return audio_seconds / dt if dt > 0 else float("inf")

    @contextlib.contextmanager
    def span(self, audio_seconds: float) -> Iterator[None]:
        self.start()
        try:
            yield
            self.stop(audio_seconds)
        except BaseException:
            # Body failed: reset without crediting the span, so a later
            # start()/stop() pair doesn't absorb this span's elapsed time.
            self._t0 = None
            raise

    @property
    def x_realtime_per_chip(self) -> float:
        if self.wall_seconds == 0:
            return 0.0
        return self.audio_seconds / self.wall_seconds / self.n_chips
