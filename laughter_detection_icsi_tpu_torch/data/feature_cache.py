"""Whole-track feature cache: log-mel per track on the device -> ``.npy`` files.

The port of the JAX package's ``data/feature_cache.py`` (reference
compute_features.py:66-195 without Lhotse): every (meeting, channel) track
is featurized in fixed-size buckets, on the card by the fbank kernel
(``ops/fbank_cuda.fbank_cuda``, one launch a bucket) and on the CPU by its
plain version, and stored as one ``<meeting>/<chan>.npy`` per track plus a
``manifest.json`` (``num_frames`` / ``num_filters`` / ``dtype`` per track):
the JAX package's layout, so a cache written by either package loads in
the other.  The training dataset reads its cuts from memory maps of these
files (data/dataset.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch import host_prep
from laughter_detection_icsi_tpu_torch.config import FEAT, FeatConfig
from laughter_detection_icsi_tpu_torch.ops.fbank_cuda import fbank_cuda

MANIFEST_NAME = "manifest.json"


def _writer_tag() -> str:
    """A tmp-name suffix unique to one write: the pid alone repeats across
    hosts sharing a cache directory, so a uuid is added."""
    return f"{os.getpid()}.{uuid.uuid4().hex[:8]}"


def compute_track_features(
    wave: np.ndarray,
    cfg: FeatConfig = FEAT,
    bucket_frames: int = 30000,
    dtype=np.float32,
    device: Union[None, str, torch.device] = None,
) -> np.ndarray:
    """[n] waveform -> [T, num_filters] features, ``bucket_frames`` frames
    at a time: the host pads the track into the snip-edges layout
    (``host_prep``), each bucket is a fixed-size buffer (the last one
    zero-padded) featurized on ``device`` (default ``cuda``: one fbank
    kernel launch a bucket; ``cpu``: the plain featurizer)."""
    # inference imports the data package: imported here, not at the top.
    from laughter_detection_icsi_tpu_torch.inference import resolve_device

    device = resolve_device(device)
    t = host_prep.num_frames(len(wave), cfg)
    if t == 0:
        return np.zeros((0, cfg.num_filters), dtype=dtype)
    snip = host_prep.snip_cfg(cfg)
    if cfg.snip_edges:
        padded = np.asarray(wave, dtype=np.float32)
    else:
        padded, _ = host_prep.host_pad_waveform(np.asarray(wave), cfg)
        padded = padded.astype(np.float32)
    shift = snip.frame_shift_samples
    bucket_wave = (bucket_frames - 1) * shift + snip.frame_length_samples
    out = np.empty((t, cfg.num_filters), dtype=dtype)
    done = 0
    with torch.no_grad():
        while done < t:
            todo = min(bucket_frames, t - done)
            buf = np.zeros(bucket_wave, dtype=np.float32)
            lo = done * shift
            hi = min(lo + bucket_wave, len(padded))
            buf[: hi - lo] = padded[lo:hi]
            feats = fbank_cuda(torch.from_numpy(buf).to(device), snip)
            out[done : done + todo] = feats[:todo].cpu().numpy().astype(dtype)
            done += todo
    return out


@dataclasses.dataclass
class FeatureCache:
    """Directory of per-track feature arrays keyed ``<meeting>/<chan>``."""

    cache_dir: str
    cfg: FeatConfig = FEAT

    def __post_init__(self):
        self._manifest_path = Path(self.cache_dir) / MANIFEST_NAME
        self._manifest: Dict[str, Dict] = {}
        self._mmaps: Dict[str, np.ndarray] = {}
        #: bumped by every add_track, so views derived from the cache (the
        #: dataset's gather plan) see a retrack and rebuild
        self.generation = 0
        if self._manifest_path.is_file():
            self._manifest = json.loads(self._manifest_path.read_text())

    def _key(self, meeting_id: str, chan_id: str) -> str:
        return f"{meeting_id}/{chan_id}"

    def _track_path(self, meeting_id: str, chan_id: str) -> Path:
        return Path(self.cache_dir) / meeting_id / f"{chan_id}.npy"

    def has(self, meeting_id: str, chan_id: str, dtype=None) -> bool:
        """The track is cached at this cache's feature width and (when
        ``dtype`` is given) in that storage dtype: a cache built under
        another FeatConfig or dtype must not satisfy a rerun."""
        entry = self._manifest.get(self._key(meeting_id, chan_id))
        if entry is None:
            return False
        if entry.get("num_filters") != int(self.cfg.num_filters):
            return False
        if dtype is not None and entry.get("dtype") != str(np.dtype(dtype)):
            return False
        return True

    def add_track(
        self,
        meeting_id: str,
        chan_id: str,
        wave: np.ndarray,
        dtype=np.float32,
        bucket_frames: int = 30000,
        device: Union[None, str, torch.device] = None,
    ) -> np.ndarray:
        feats = compute_track_features(
            wave, self.cfg, bucket_frames=bucket_frames, dtype=dtype, device=device)
        path = self._track_path(meeting_id, chan_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        # Atomic publish: an interrupted overwrite must not leave a
        # truncated .npy behind a manifest entry that calls it present.
        # (np.save appends .npy to any other suffix.)
        tmp = path.with_name(f"{path.stem}.tmp.{_writer_tag()}.npy")
        np.save(tmp, feats)
        os.replace(tmp, path)
        # A memory map of the old file keeps the old shape.
        self._mmaps.pop(self._key(meeting_id, chan_id), None)
        self.generation += 1
        self._manifest[self._key(meeting_id, chan_id)] = {
            "num_frames": int(feats.shape[0]),
            "num_filters": int(feats.shape[1]),
            "dtype": str(feats.dtype),
        }
        self._flush_manifest()
        return feats

    def add_audio_file(
        self, meeting_id: str, chan_id: str, audio_path: str, channel: int = 0, **kw
    ) -> np.ndarray:
        from laughter_detection_icsi_tpu_torch.runtime import native

        wave, sr = native.read(audio_path, channel=channel)
        if sr != self.cfg.sampling_rate:
            raise ValueError(
                f"{audio_path}: sample rate {sr} != featurizer rate "
                f"{self.cfg.sampling_rate}"
            )
        return self.add_track(meeting_id, chan_id, wave, **kw)

    def _flush_manifest(self) -> None:
        self._manifest_path.parent.mkdir(parents=True, exist_ok=True)
        # A tmp name unique to the writer: two processes sharing the cache
        # would otherwise interleave their writes in one tmp file.
        tmp = f"{self._manifest_path}.tmp.{_writer_tag()}"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, self._manifest_path)

    def track(self, meeting_id: str, chan_id: str) -> np.ndarray:
        """Memory-mapped [T, F] features of one track."""
        key = self._key(meeting_id, chan_id)
        if key not in self._mmaps:
            if key not in self._manifest:
                raise KeyError(f"track {key} not in feature cache {self.cache_dir}")
            self._mmaps[key] = np.load(self._track_path(meeting_id, chan_id), mmap_mode="r")
        return self._mmaps[key]

    def cut(
        self,
        meeting_id: str,
        chan_id: str,
        start_s: float,
        duration_s: float,
        pad_to_frames: Optional[int] = None,
    ) -> np.ndarray:
        """Features of a (start, duration) cut, zero-padded on the right to
        ``pad_to_frames`` (the reference's truncate + pad to 1.0 s,
        compute_features.py:164-167)."""
        fps = self.cfg.num_samples
        track = self.track(meeting_id, chan_id)
        first = int(round(start_s * fps))
        n = int(round(duration_s * fps))
        first = max(0, min(first, track.shape[0]))
        cut = np.asarray(track[first : first + n], dtype=np.float32)
        if pad_to_frames is not None:
            if cut.shape[0] > pad_to_frames:
                cut = cut[:pad_to_frames]
            elif cut.shape[0] < pad_to_frames:
                pad = np.zeros((pad_to_frames - cut.shape[0], track.shape[1]), dtype=np.float32)
                cut = np.concatenate([cut, pad])
        return cut

    def keys(self) -> List[str]:
        return sorted(self._manifest)
