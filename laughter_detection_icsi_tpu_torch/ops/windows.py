"""Sliding-window extraction over a feature map, as one gather.

The reference materializes one 100-frame window per output frame
(reference datasets.py:72-93: ``feats[i:i+100]`` with a right zero-pad at
the tail); the pipeline gathers them chunk by chunk on the device instead.
"""

from __future__ import annotations

import torch


def extract_windows(
    feats: torch.Tensor, start: int, count: int, window: int = 100
) -> torch.Tensor:
    """Gather ``count`` consecutive sliding windows from ``feats`` [T, F]
    starting at frame ``start``: returns [count, window, F].

    Every gathered index must be in range (the last is ``start + count +
    window - 2``), so the caller supplies a ``window - 1`` zero-padded tail
    (the pipeline sizes its feature buffer with exactly that slack)."""
    dev = feats.device
    idx = (
        start
        + torch.arange(count, device=dev)[:, None]
        + torch.arange(window, device=dev)[None, :]
    )
    return feats[idx]
