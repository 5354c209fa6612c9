"""Training-sample tables: laugh and matched non-laugh segments per split.

The port of the JAX package's ``data/sampler.py`` (reference
create_data_df.py:32-206) on the transcript store's record lists, with no
pandas: from a :class:`~laughter_detection_icsi_tpu_torch.eval.transcript.
TranscriptStore` and its :class:`~laughter_detection_icsi_tpu_torch.eval.
indices.IndexStore`, build the train/dev/test tables, each a list of rows
(dicts keyed by :data:`COLS`: start, duration, sub_start, sub_duration,
audio_path, meeting_id, chan_id, label), and write them as the reference's
``<split>_df.csv``.

Sampling semantics (the JAX package's):
- per transcribed laugh, ``num_laugh`` subsamples of 1 s inside it and
  ``num_non_laugh`` non-laugh segments of the same meeting;
- structured mode: ``floor(0.7 n)`` silence (rejection-sampled against the
  silence index), ``floor(0.1 n)`` noise, the rest speech (PARITY.md #20);
  noise comes from the noise segments, or from speech with
  ``noise_from_speech_bug`` as the reference draws it (PARITY.md #3);
- random mode: any segment that overlaps no laugh and no invalid segment;
- laughs come from the raw laugh table, short and breath-laughs included
  (PARITY.md #15); speech and noise negatives keep their own span
  (PARITY.md #21); non-laugh durations are floored at the 1 s subsample;
- floats rounded to 2 decimals as numpy rounds; the sanity asserts kept.

The random stream is the JAX package's: it reseeds numpy's global
generator with ``cfg.random_seed`` at every ``create_data_dfs`` and draws
only through ``randint`` and ``uniform``; a ``RandomState`` seeded alike
draws the same numbers, and the segments are visited in the same order
(meetings sorted, rows in table order), so the tables are equal to the
JAX package's row for row.
"""

from __future__ import annotations

import csv
import math
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from laughter_detection_icsi_tpu_torch.config import (
    ANALYSIS, PARTITIONS, AnalysisConfig, split_of_meeting)
from laughter_detection_icsi_tpu_torch.eval.indices import IndexStore
from laughter_detection_icsi_tpu_torch.eval.intervals import IntervalSet, to_frames
from laughter_detection_icsi_tpu_torch.eval.transcript import TranscriptStore

COLS = [
    "start",
    "duration",
    "sub_start",
    "sub_duration",
    "audio_path",
    "meeting_id",
    "chan_id",
    "label",
]
FLOAT_COLS = ("start", "duration", "sub_start", "sub_duration")

Row = Dict[str, Any]


def _audio_path(meeting_id: str, chan_id: str) -> str:
    """The audio_path column: always '/'-separated."""
    return f"{meeting_id}/{chan_id}.sph"


def get_subsample(start: float, duration: float, subsample_duration: float, rng) -> tuple:
    """A uniform subsample of ``subsample_duration`` inside [start,
    start + duration] (reference create_data_df.py:84-95)."""
    sub_dur = min(duration, subsample_duration)
    sub_start = rng.uniform(start, start + duration - sub_dur)
    return sub_start, sub_dur


class DataFrameSampler:
    """Sampler bound to one corpus (store and indices).  The name is the
    JAX package's; the tables are record lists."""

    def __init__(
        self,
        store: TranscriptStore,
        idx: IndexStore,
        cfg: AnalysisConfig = ANALYSIS,
        noise_from_speech_bug: bool = False,
    ):
        self.store = store
        self.idx = idx
        self.cfg = cfg
        self.noise_from_speech_bug = noise_from_speech_bug
        self.rng = np.random.RandomState(cfg.random_seed)
        # Per-meeting rows of each source list, grouped once (list order
        # kept).  The entry holds the list itself, so its id cannot be
        # reused by another list while the entry lives.
        self._group_cache: Dict[int, Tuple[Sequence, Dict[str, List]]] = {}

    def _meeting_rows(self, rows: Sequence, meeting_id: str) -> List:
        hit = self._group_cache.get(id(rows))
        if hit is None or hit[0] is not rows:
            groups: Dict[str, List] = {}
            for r in rows:
                groups.setdefault(r.meeting_id, []).append(r)
            self._group_cache[id(rows)] = (rows, groups)
        else:
            groups = hit[1]
        return groups.get(meeting_id, [])

    def random_non_laugh(self, duration: float, meeting_id: str, silence: bool = False) -> List:
        """A random segment of any channel of the meeting that overlaps no
        laugh or invalid segment (with ``silence``, that lies inside the
        silence index): rejection sampling, at most 1,001 attempts
        (reference create_data_df.py:32-63)."""
        duration = max(duration, self.cfg.subsample_duration)
        info = self._meeting_rows(self.store.info, meeting_id)
        if not info:
            raise RuntimeError(
                f"no channel info for meeting {meeting_id} "
                "(meeting absent from the transcript info table)"
            )
        for _attempt in range(1001):
            row = info[self.rng.randint(0, len(info))]
            if row.length <= duration:
                continue
            start = self.rng.uniform(0, row.length - duration)
            seg = IntervalSet.closed(to_frames(start), to_frames(start + duration))
            part_id = row.part_id
            if silence:
                if not self.idx.silence.get(meeting_id, part_id).contains(seg):
                    continue
            elif self.idx.laugh.get(meeting_id, part_id).overlaps(seg) or (
                self.idx.invalid.get(meeting_id, part_id).overlaps(seg)
            ):
                continue
            sub_start, sub_dur = get_subsample(
                start, duration, self.cfg.subsample_duration, self.rng)
            return [start, duration, sub_start, sub_dur, _audio_path(meeting_id, row.chan_id),
                    meeting_id, row.chan_id, 0]
        raise RuntimeError(
            f"rejection sampling failed for meeting {meeting_id} (duration {duration}s)")

    def random_from_df(self, duration: float, meeting_id: str, segments: Sequence) -> List:
        """A random transcribed segment of the meeting from ``segments``
        (reference create_data_df.py:65-81).  The clamped ``duration`` is
        not used: the row's own span is (PARITY.md #21).  A meeting with no
        such segment falls back to a random non-laugh segment."""
        duration = max(duration, self.cfg.subsample_duration)
        rows = self._meeting_rows(segments, meeting_id)
        if not rows:
            return self.random_non_laugh(duration, meeting_id)
        row = rows[self.rng.randint(0, len(rows))]
        sub_start, sub_dur = get_subsample(
            row.start, row.length, self.cfg.subsample_duration, self.rng)
        return [row.start, row.length, sub_start, sub_dur,
                _audio_path(row.meeting_id, row.chan_id), meeting_id, row.chan_id, 0]

    def create_data_dfs(
        self,
        num_laugh_samples: int = 1,
        num_non_laugh_samples: int = 1,
        meeting_id: Optional[str] = None,
        chan_id: Optional[str] = None,
        random: bool = False,
    ) -> Dict[str, List[Row]]:
        """The three split tables (reference create_data_df.py:98-206):
        non-laugh rows first, then laugh rows, each split's in meeting
        order."""
        self.rng = np.random.RandomState(self.cfg.random_seed)
        if chan_id and not meeting_id:
            raise ValueError("chan_id filter requires meeting_id")
        laughs = [s for s in self.store.laugh_only
                  if (not meeting_id or s.meeting_id == meeting_id)
                  and (not chan_id or s.chan_id == chan_id)]
        non_laugh: Dict[str, List] = {s: [] for s in PARTITIONS}
        laugh_rows: Dict[str, List] = {s: [] for s in PARTITIONS}
        if not random:
            silence_n = math.floor(num_non_laugh_samples * 0.7)
            noise_n = math.floor(num_non_laugh_samples * 0.1)
            speech_n = num_non_laugh_samples - silence_n - noise_n
            noise = self.store.speech if self.noise_from_speech_bug else self.store.noise

        by_meeting: Dict[str, List] = {}
        for seg in laughs:
            by_meeting.setdefault(seg.meeting_id, []).append(seg)
        for mid in sorted(by_meeting):
            split = split_of_meeting(mid)
            for seg in by_meeting[mid]:
                if random:
                    for _ in range(num_non_laugh_samples):
                        non_laugh[split].append(self.random_non_laugh(seg.length, mid))
                else:
                    for _ in range(speech_n):
                        non_laugh[split].append(
                            self.random_from_df(seg.length, mid, self.store.speech))
                    for _ in range(noise_n):
                        non_laugh[split].append(self.random_from_df(seg.length, mid, noise))
                    for _ in range(silence_n):
                        non_laugh[split].append(
                            self.random_non_laugh(seg.length, mid, silence=True))
                audio_path = _audio_path(mid, seg.chan_id)
                for _ in range(num_laugh_samples):
                    sub_start, sub_dur = get_subsample(
                        seg.start, seg.length, self.cfg.subsample_duration, self.rng)
                    laugh_rows[split].append(
                        [seg.start, seg.length, sub_start, sub_dur, audio_path, mid,
                         seg.chan_id, 1])

        out: Dict[str, List[Row]] = {}
        for split in PARTITIONS:
            rows = _rounded(non_laugh[split] + laugh_rows[split], self.cfg.float_decimals)
            _sanity_check(rows, split)
            out[split] = rows
        return out


def _rounded(lists: List[List], decimals: int) -> List[Row]:
    """Rows as dicts with the float columns rounded as ``DataFrame.round``
    rounds them (numpy's: scale, round half to even, unscale)."""
    rows = [dict(zip(COLS, r)) for r in lists]
    for col in FLOAT_COLS:
        vals = np.round(np.array([r[col] for r in rows], dtype=np.float64), decimals)
        for r, v in zip(rows, vals.tolist()):
            r[col] = v
    return rows


def _sanity_check(rows: List[Row], split: str) -> None:
    """reference create_data_df.py:185-203."""
    if not rows:
        return
    for col, what in zip(FLOAT_COLS, ("start-time", "duration", "sub_start", "sub_duration")):
        assert not any(r[col] < 0 for r in rows), f"negative {what}"
    assert all(r["label"] in (0, 1) for r in rows), "labels must be 0/1"
    meeting_ids = {r["audio_path"].split("/")[0] for r in rows}
    mismatched = meeting_ids - set(PARTITIONS[split])
    assert not mismatched, f"meetings {mismatched} not in split {split}"


def _csv_cell(v) -> str:
    """A cell as ``DataFrame.to_csv`` writes it: floats by repr, ints and
    strings as they are."""
    return repr(v) if isinstance(v, float) else str(v)


def write_data_dfs(dfs: Dict[str, List[Row]], data_dir: str) -> None:
    """``<data_dir>/<split>_df.csv`` for each table: the header ``COLS``,
    then the rows; the bytes ``DataFrame.to_csv(index=False)`` writes."""
    Path(data_dir).mkdir(parents=True, exist_ok=True)
    for split, rows in dfs.items():
        with open(os.path.join(data_dir, f"{split}_df.csv"), "w", newline="") as f:
            w = csv.writer(f, lineterminator=os.linesep)
            w.writerow(COLS)
            w.writerows([_csv_cell(r[c]) for c in COLS] for r in rows)
