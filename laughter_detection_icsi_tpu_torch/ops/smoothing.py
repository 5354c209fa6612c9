"""Threshold + min-length run-length smoothing of frame probabilities.

Mirrors the JAX package's ``ops/smoothing.py``, which replaces the
reference's Python scan (reference laugh_segmenter.py:74-111):

- ``fix_over_underflow`` (reference laugh_segmenter.py:57-71): p > 1 -> 1,
  p <= 0 -> 1e-7 (so threshold 0 still fires on zero-prob frames);
- a run of consecutive frames with prob > threshold (compared in float32)
  becomes the span (first_frame / fps, LAST_frame / fps);
- instances are kept only if ``end - start > min_length`` strictly.

``instances_from_device_probs`` computes the run tables on the probs'
device and brings only [K, max_events] integer tables to the host, where
the min-length filter applies in float64, so its result is exactly
``get_laughter_instances``'.  A threshold whose runs overflow
``max_events`` falls back to the unbounded host scan.
``StreamingEventDetector`` is the incremental twin for live streams.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

OVERFLOW_EPS = 1e-7

Instances = Dict[Tuple[float, float], List[Tuple[float, float]]]


def _fix_over_underflow_np(probs: np.ndarray) -> np.ndarray:
    """Host twin of :func:`fix_over_underflow`."""
    probs = np.where(probs > 1.0, 1.0, probs)
    return np.where(probs <= 0.0, OVERFLOW_EPS, probs)


class StreamingEventDetector:
    """Incremental run-length smoothing for one (threshold, min_length).

    The online companion of :func:`get_laughter_instances`: feed frame
    probabilities chunk by chunk (e.g. from ``inference.StreamingSession``)
    and each laughter event comes back when its run closes (the next frame
    drops below the threshold); ``finish()`` closes a run still open at end
    of stream.  Over any chunking the events equal the offline function's:
    the same fix_over_underflow, float32 ``>``, (first, LAST)/fps spans and
    strict ``>`` min-length.
    """

    def __init__(self, threshold: float, min_length: float = 0.2, fps: float = 100.0):
        self.threshold = float(threshold)
        self.min_length = float(min_length)
        self.fps = float(fps)
        self._f = 0  # global frame index of the next fed frame
        self._open: Optional[int] = None  # start frame of the open run
        self._done = False

    def _emit(self, start_f: int, last_f: int) -> Optional[Tuple[float, float]]:
        s, e = start_f / self.fps, last_f / self.fps
        return (s, e) if e - s > self.min_length else None

    def feed(self, probs: np.ndarray) -> List[Tuple[float, float]]:
        """Add frame probabilities; returns the events that closed."""
        if self._done:
            raise RuntimeError("detector already finished")
        probs = _fix_over_underflow_np(np.asarray(probs, dtype=np.float32))
        mask = probs > np.float32(self.threshold)
        prev = np.int8(0 if self._open is None else 1)
        d = np.diff(np.concatenate([[prev], mask.astype(np.int8)]))
        starts = list(self._f + np.nonzero(d == 1)[0])
        lasts = list(self._f + np.nonzero(d == -1)[0] - 1)
        events: List[Tuple[float, float]] = []
        for last_f in lasts:  # transitions alternate: each close pairs in order
            start_f = self._open if self._open is not None else starts.pop(0)
            self._open = None
            ev = self._emit(int(start_f), int(last_f))
            if ev is not None:
                events.append(ev)
        if starts:  # a run is still open at the chunk's end
            self._open = int(starts[0])
        self._f += len(mask)
        return events

    def finish(self) -> List[Tuple[float, float]]:
        """End of stream: close and (maybe) emit the open run."""
        if self._done:
            raise RuntimeError("detector already finished")
        self._done = True
        if self._open is None:
            return []
        ev = self._emit(self._open, self._f - 1)
        self._open = None
        return [ev] if ev is not None else []


def fix_over_underflow(probs: torch.Tensor) -> torch.Tensor:
    """Vectorized reference laugh_segmenter.py:57-71."""
    probs = torch.clamp(probs, max=1.0)
    return torch.where(probs <= 0.0, OVERFLOW_EPS, probs)


def _first_positions(mask: torch.Tensor, max_events: int) -> torch.Tensor:
    """Column indices of the first ``max_events`` True entries of each row
    of ``mask`` [K, T], as int32 [K, max_events] padded with -1."""
    k, t = mask.shape
    rank = torch.cumsum(mask, dim=1) - 1
    # Entries past the table (and every False entry) land in a spill
    # column that is dropped.
    col = torch.where(mask & (rank < max_events), rank, max_events)
    table = torch.full(
        (k, max_events + 1), -1, dtype=torch.int32, device=mask.device
    )
    src = torch.arange(t, dtype=torch.int32, device=mask.device).expand(k, t)
    table.scatter_(1, col, src)
    return table[:, :max_events]


def laughter_runs(
    probs: torch.Tensor, thresholds: torch.Tensor, max_events: int = 2048
):
    """All runs above each threshold: probs [T] float32, thresholds [K]
    float32 -> (starts [K, max_events], lasts [K, max_events], counts [K]).
    Tables are padded with -1; ``counts`` is the TRUE (unclipped) run count,
    so callers can detect table overflow."""
    fixed = fix_over_underflow(probs)
    mask = fixed[None, :] > thresholds[:, None]
    nothing = torch.zeros_like(mask[:, :1])
    prev = torch.cat([nothing, mask[:, :-1]], dim=1)
    nxt = torch.cat([mask[:, 1:], nothing], dim=1)
    start_mask = mask & ~prev
    end_mask = mask & ~nxt
    counts = start_mask.sum(dim=1)
    return (
        _first_positions(start_mask, max_events),
        _first_positions(end_mask, max_events),
        counts,
    )


def instances_from_device_probs(
    probs_dev: torch.Tensor,
    thresholds: Sequence[float] = (0.5,),
    min_lengths: Sequence[float] = (0.2,),
    fps: float = 100.0,
    max_events: int = 2048,
) -> Instances:
    """Smoothing for a device-resident probability vector: the threshold
    scan and run extraction run on its device, and only the small run
    tables cross to the host (see the module docstring)."""
    out: Instances = {}
    if probs_dev.shape[0] == 0:
        for thr in thresholds:
            for min_l in min_lengths:
                out[(float(thr), float(min_l))] = []
        return out
    thr_t = torch.from_numpy(np.asarray(thresholds, dtype=np.float32)).to(
        probs_dev.device
    )
    starts, lasts, counts = laughter_runs(probs_dev, thr_t, max_events)
    starts, lasts, counts = (x.cpu().numpy() for x in (starts, lasts, counts))

    # Overflowing thresholds (typical at low thresholds on a near-random
    # checkpoint, often many at once) fall back to ONE batched host pass.
    overflowed = [thr for k, thr in enumerate(thresholds) if counts[k] > max_events]
    if overflowed:
        out.update(
            get_laughter_instances(
                probs_dev.cpu().numpy(), thresholds=overflowed,
                min_lengths=min_lengths, fps=fps,
            )
        )
    for k, thr in enumerate(thresholds):
        if counts[k] > max_events:
            continue  # already handled by the batched host fallback
        n = int(counts[k])
        spans = [
            (int(s) / fps, int(e) / fps)
            for s, e in zip(starts[k, :n], lasts[k, :n])
        ]
        for min_l in min_lengths:
            out[(float(thr), float(min_l))] = [
                (float(s), float(e)) for s, e in spans if e - s > min_l
            ]
    return out


def get_laughter_instances(
    probs: np.ndarray,
    thresholds: Sequence[float] = (0.5,),
    min_lengths: Sequence[float] = (0.2,),
    fps: float = 100.0,
) -> Instances:
    """Drop-in equivalent of reference laugh_segmenter.py:74-111, on host."""
    probs = _fix_over_underflow_np(np.asarray(probs, dtype=np.float32))

    out: Instances = {}
    for thr in thresholds:
        # Compare in float32 like the device path: a float64 threshold would
        # classify a prob bit-equal to float32(thr) differently.
        mask = probs > np.float32(thr)
        d = np.diff(mask.astype(np.int8))
        starts = np.nonzero(d == 1)[0] + 1
        lasts = np.nonzero(d == -1)[0]
        if mask.size and mask[0]:
            starts = np.concatenate([[0], starts])
        if mask.size and mask[-1]:
            lasts = np.concatenate([lasts, [mask.size - 1]])
        spans = [(s / fps, e / fps) for s, e in zip(starts, lasts)]
        for min_l in min_lengths:
            out[(float(thr), float(min_l))] = [
                (float(s), float(e)) for s, e in spans if e - s > min_l
            ]
    return out
