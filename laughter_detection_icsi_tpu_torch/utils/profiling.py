"""Profiling and observability: torch.profiler traces and throughput counters.

The port of the JAX package's ``utils/profiling.py``.  ``trace(dir)``
captures a ``torch.profiler`` trace of the host and, where there is one,
the CUDA device, and writes it into ``dir`` as a Chrome trace (open it in
Perfetto or chrome://tracing); any CLI enables it with ``--trace_dir``.
``annotate`` names a region in that timeline.  The throughput meter counts
in the unit the sweep is measured in, audio-seconds per wall-second.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional, Tuple


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """``with trace('traces'):`` writes ``traces/trace_<pid>.json`` when
    the block ends (a no-op when ``trace_dir`` is falsy)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active trace (shows up in the timeline)."""
    import torch

    with torch.profiler.record_function(name):
        yield


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

    @property
    def audio_hours_per_sec_per_chip(self) -> float:
        return self.x_realtime_per_chip / 3600.0

    def report(self) -> str:
        return (
            f"{self.audio_seconds / 3600:.2f} audio-h in {self.wall_seconds:.1f}s"
            f" = {self.x_realtime_per_chip:.1f}x realtime/chip"
            f" ({self.audio_hours_per_sec_per_chip:.4f} audio-h/s/chip)"
        )


def epoch_time(start: float, end: float) -> Tuple[int, int]:
    """(minutes, seconds) of an interval (reference utils/torch_utils.py:98-102)."""
    elapsed = end - start
    mins = int(elapsed / 60)
    return mins, int(elapsed - mins * 60)
