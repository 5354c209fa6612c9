"""Per-meeting / per-participant interval indices over the ground truth.

The port of the JAX package's ``eval/indices.py`` (reference
analysis/preprocess.py:13-167) on the transcript store's record lists, with
no pandas: turn the segment lists into laugh / invalid / speech / noise /
silence interval indices at 1 ms frame resolution, using the exact
:class:`~laughter_detection_icsi_tpu_torch.eval.intervals.IntervalSet`
algebra.

Validity rule (reference preprocess.py:13-24): a transcribed laugh shorter
than ``min_length`` (0.2 s) or typed 'breath-laugh' is INVALID: it is moved
into the invalid index and excluded from evaluation.

Index structure: ``index.sets[meeting_id][part_id] -> IntervalSet`` plus
per-meeting ``tot_len`` (seconds) and ``tot_events`` counters (reference
preprocess.py:27-46).  The segments are visited in the JAX package's order
(meetings sorted; within a meeting, rows ordered by start as pandas'
``sort_values`` orders them, then grouped by sorted participant), so every
``tot_len`` is the same sum in the same order, to the last bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from laughter_detection_icsi_tpu_torch.config import ANALYSIS, AnalysisConfig
from laughter_detection_icsi_tpu_torch.eval.intervals import IntervalSet, to_frames, to_sec
from laughter_detection_icsi_tpu_torch.eval.transcript import Segment, TranscriptStore


@dataclasses.dataclass
class Index:
    """Interval index per (meeting, participant) with per-meeting totals."""

    sets: Dict[str, Dict[str, IntervalSet]] = dataclasses.field(default_factory=dict)
    tot_len: Dict[str, float] = dataclasses.field(default_factory=dict)  # seconds
    tot_events: Dict[str, int] = dataclasses.field(default_factory=dict)

    def get(self, meeting_id: str, part_id: str) -> IntervalSet:
        """Empty set if the (meeting, participant) has no entries (reference
        preprocess.py:123-130)."""
        return self.sets.get(meeting_id, {}).get(part_id, IntervalSet.empty())

    def has_part(self, meeting_id: str, part_id: str) -> bool:
        return part_id in self.sets.get(meeting_id, {})

    def ensure_meeting(self, meeting_id: str) -> None:
        self.sets.setdefault(meeting_id, {})
        self.tot_len.setdefault(meeting_id, 0.0)
        self.tot_events.setdefault(meeting_id, 0)

    def add_many(self, meeting_id: str, part_id: str, segments: Sequence[Segment]) -> None:
        """Append a participant's segments, one union for all of them.  The
        reference accumulates tot_len per segment before union-merging, so
        overlapping transcriptions are counted twice there too: tot_len is
        the sum of segment lengths, not the union's length, and each segment
        is one event."""
        self.ensure_meeting(meeting_id)
        pairs = []
        for seg in segments:
            a, b = to_frames(seg.start), to_frames(seg.end)
            if b > a:
                pairs.append((a, b))
                self.tot_len[meeting_id] += to_sec(b - a)
            self.tot_events[meeting_id] += 1
        new = IntervalSet.from_pairs(pairs)
        cur = self.sets[meeting_id].get(part_id)
        self.sets[meeting_id][part_id] = (
            new if cur is None or cur.is_empty else cur | new
        )


@dataclasses.dataclass
class IndexStore:
    laugh: Index
    invalid: Index
    speech: Index
    noise: Index
    silence: Index


def seg_is_invalid(seg: Segment, cfg: AnalysisConfig = ANALYSIS) -> bool:
    """THE laugh-validity rule (reference preprocess.py:13-24): a laugh is
    invalid when too short or a breath-laugh."""
    return seg.length < cfg.min_length or seg.laugh_type == "breath-laugh"


def _groups(segments: Sequence[Segment]) -> Iterator[Tuple[str, List[Tuple[str, List[Segment]]]]]:
    """(meeting_id, [(part_id, segments)]) in the JAX package's order:
    ``df.groupby('meeting_id')`` (sorted keys, rows in list order), then
    ``sort_values('start')`` (numpy's default, unstable quicksort over the
    meeting's starts, as pandas calls it) and ``groupby('part_id')``
    (sorted keys, the sorted rows' order kept)."""
    by_meeting: Dict[str, List[Segment]] = {}
    for seg in segments:
        by_meeting.setdefault(seg.meeting_id, []).append(seg)
    for meeting_id in sorted(by_meeting):
        rows = by_meeting[meeting_id]
        order = np.argsort(np.array([s.start for s in rows], dtype=np.float64), kind="quicksort")
        by_part: Dict[str, List[Segment]] = {}
        for i in order:
            by_part.setdefault(rows[i].part_id, []).append(rows[i])
        yield meeting_id, [(p, by_part[p]) for p in sorted(by_part)]


def index_from_segments(segments: Sequence[Segment]) -> Index:
    """Reference preprocess.py:91-120."""
    index = Index()
    for meeting_id, parts in _groups(segments):
        index.ensure_meeting(meeting_id)
        for part_id, segs in parts:
            index.add_many(meeting_id, part_id, segs)
    return index


def laugh_index_from_segments(
    segments: Sequence[Segment], invalid_index: Index, cfg: AnalysisConfig = ANALYSIS
) -> Index:
    """Reference preprocess.py:49-88: invalid laughs (too short /
    breath-laugh) go to the invalid index instead."""
    index = Index()
    for meeting_id, parts in _groups(segments):
        index.ensure_meeting(meeting_id)
        for part_id, segs in parts:
            # The reference pre-creates an (empty) entry per participant
            # (preprocess.py:76); it matters for `has_part` checks.
            index.sets[meeting_id].setdefault(part_id, IntervalSet.empty())
            bad = [seg_is_invalid(s, cfg) for s in segs]
            if any(bad):
                invalid_index.add_many(
                    meeting_id, part_id, [s for s, b in zip(segs, bad) if b]
                )
            good = [s for s, b in zip(segs, bad) if not b]
            if good:
                index.add_many(meeting_id, part_id, good)
    return index


def silence_index_from(
    store: TranscriptStore,
    laugh: Index,
    invalid: Index,
    noise: Index,
    speech: Index,
) -> Index:
    """Whole channel minus every transcribed segment (reference
    preprocess.py:133-167)."""
    index = Index()
    for row in store.info:
        meeting_id, part_id = row.meeting_id, row.part_id
        index.ensure_meeting(meeting_id)
        full = IntervalSet.openclosed(0, to_frames(row.length))
        silence = (
            full
            - laugh.get(meeting_id, part_id)
            - invalid.get(meeting_id, part_id)
            - speech.get(meeting_id, part_id)
            - noise.get(meeting_id, part_id)
        )
        index.sets[meeting_id][part_id] = silence
        index.tot_len[meeting_id] += to_sec(silence.length())
    return index


def build_indices(store: TranscriptStore, cfg: AnalysisConfig = ANALYSIS) -> IndexStore:
    if cfg.frame_duration_ms != 1:
        # to_frames is fixed at 1 ms; building anyway would present 1 ms
        # indices as another resolution.
        raise NotImplementedError(
            "index construction is fixed at 1 ms interval resolution; "
            f"got frame_duration_ms={cfg.frame_duration_ms}"
        )
    invalid = index_from_segments(store.invalid)
    laugh = laugh_index_from_segments(store.laugh_only, invalid_index=invalid, cfg=cfg)
    speech = index_from_segments(store.speech)
    noise = index_from_segments(store.noise)
    # Evaluation walks every meeting dir and reads laugh totals
    # (reference analyse.py:159-161); make sure every known meeting exists.
    for meeting_id in store.meeting_ids:
        for idx in (laugh, invalid, speech, noise):
            idx.ensure_meeting(meeting_id)
    silence = silence_index_from(store, laugh, invalid, noise, speech)
    return IndexStore(
        laugh=laugh, invalid=invalid, speech=speech, noise=noise, silence=silence
    )


# --------------------------------------------------------------------------- #
# Disk cache (reference preprocess.py:170-213 caches to
# .cache/preprocessed_indices.pkl; this one is keyed by the transcript dir's
# content and the analysis config, so a changed corpus or min_length never
# reads a stale cache).
# --------------------------------------------------------------------------- #


def _cache_key(transcript_dir: str, cfg: AnalysisConfig = None) -> str:
    cfg = cfg if cfg is not None else ANALYSIS
    h = hashlib.sha1()
    # min_length moves laughs between the laugh and invalid indices, so it
    # is part of the key (frame_duration_ms too, though only 1 ms builds).
    h.update(f"cfg:{cfg.min_length}:{cfg.frame_duration_ms}".encode())
    for p in sorted(Path(transcript_dir).glob("*.mrt")):
        st = p.stat()
        h.update(f"{p.name}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


_INDEX_CACHE: Dict[str, IndexStore] = {}


def load(
    store: TranscriptStore,
    cache_dir: Optional[str] = None,
    force_recompute: bool = False,
    cfg: AnalysisConfig = ANALYSIS,
) -> IndexStore:
    """Memoized :func:`build_indices`, optionally pickled under
    ``cache_dir/indices_<key>.pkl``.  Entries of the same transcript dir
    whose content key was superseded are evicted from memory."""
    key = _cache_key(store.transcript_dir, cfg)
    mem_prefix = f"{Path(store.transcript_dir).resolve()}#"
    mem_key = mem_prefix + key
    if not force_recompute and mem_key in _INDEX_CACHE:
        return _INDEX_CACHE[mem_key]

    def _publish(indices: IndexStore) -> None:
        for old in [k for k in _INDEX_CACHE if k.startswith(mem_prefix)]:
            del _INDEX_CACHE[old]
        _INDEX_CACHE[mem_key] = indices

    cache_file = None
    if cache_dir is not None:
        cache_file = Path(cache_dir) / f"indices_{key}.pkl"
        if not force_recompute and cache_file.is_file():
            # Only this module writes these files (below).
            with open(cache_file, "rb") as f:
                indices = pickle.load(f)
            _publish(indices)
            return indices
    indices = build_indices(store, cfg=cfg)
    _publish(indices)
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        # Atomic publish: a crash mid-dump must not leave a truncated pickle.
        tmp = cache_file.with_name(cache_file.name + f".tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            pickle.dump(indices, f)
        os.replace(tmp, cache_file)
    return indices
