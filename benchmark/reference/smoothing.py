"""Threshold x minimum-length smoothing of frame probabilities: the plain
reference of a sweep's event tables.

The published recipe's ``laugh_segmenter.get_laughter_instances``: a
probability above 1 counts as 1 and one at or below 0 as 1e-7; for each
threshold (compared in float32), every run of consecutive frames above it
is an event from its first frame / fps to its last frame / fps (seconds),
kept for a minimum length when end - start exceeds it strictly.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Events = Dict[Tuple[float, float], List[Tuple[float, float]]]


def runs(above: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(first, last) frame of each run of True in a 1-D mask."""
    edges = np.diff(np.concatenate([[False], above, [False]]).astype(np.int8))
    return np.flatnonzero(edges == 1), np.flatnonzero(edges == -1) - 1


def events(probs: np.ndarray, thresholds: Sequence[float], min_lengths: Sequence[float],
           fps: float) -> Events:
    p = np.asarray(probs, dtype=np.float32)
    p = np.where(p > 1.0, np.float32(1.0), p)
    p = np.where(p <= 0.0, np.float32(1e-7), p)
    out: Events = {}
    for thr in thresholds:
        first, last = runs(p > np.float32(thr))
        spans = [(int(s) / fps, int(e) / fps) for s, e in zip(first, last)]
        for m in min_lengths:
            out[(float(thr), float(m))] = [(s, e) for s, e in spans if e - s > m]
    return out
