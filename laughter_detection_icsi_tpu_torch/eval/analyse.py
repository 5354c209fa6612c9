"""Prediction evaluation: TextGrids -> time-weighted precision / recall.

The port of the JAX package's ``eval/analyse.py`` (reference
analysis/analyse.py:49-298,420-539) with no pandas: records in (named
tuples whose fields are the JAX package's DataFrame columns, in the same
order), CSV files out through the standard library's ``csv``.  The rows
come in the DataFrames' row order, and the CSVs read back with
``pandas.read_csv`` as the JAX package's DataFrames: a float is written
with ``repr`` (the shortest text that reads back as the same number) and a
NaN as an empty cell, as pandas writes them.

Semantics (the JAX package's):
- Prediction dir layout ``<preds_dir>/<meeting>/t_<thr>/l_<minlen>/chanN.TextGrid``
  (reference analyse.py:64-96); channels with no participant mapping and
  empty files are skipped (reference analyse.py:23-35).
- ``laugh_match`` (reference analyse.py:120-149): predicted time inside
  invalid regions is removed before matching; correct = overlap with the
  laugh index; false-positive time is attributed to speech / silence /
  noise, and the accounting must close to < 1 ms.
- Per-meeting precision := 1 when nothing was predicted; recall := NaN when
  the meeting has no transcribed laughter (reference analyse.py:203-216).
- Corpus stats: sum times over meetings per (min_len, threshold), then
  divide (reference analyse.py:269-298).
- A prediction counts as "valid" unless it lies fully inside an invalid
  region (reference analyse.py:183-187).
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
import re
import typing
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from laughter_detection_icsi_tpu_torch.config import ANALYSIS, AnalysisConfig
from laughter_detection_icsi_tpu_torch.eval import indices as indices_lib
from laughter_detection_icsi_tpu_torch.eval import textgrid as tg
from laughter_detection_icsi_tpu_torch.eval import transcript as transcript_lib
from laughter_detection_icsi_tpu_torch.eval.indices import Index, IndexStore
from laughter_detection_icsi_tpu_torch.eval.intervals import IntervalSet, to_frames, to_sec
from laughter_detection_icsi_tpu_torch.eval.transcript import (
    SEGMENT_COLUMNS, Segment, TranscriptStore)


class Prediction(NamedTuple):
    """One predicted laugh: a row of the JAX package's ``pred_df``."""

    meeting_id: str
    part_id: str
    chan: str
    start: float
    end: float
    length: float
    threshold: float
    min_len: float
    laugh_type: str


class EvalRow(NamedTuple):
    """One (meeting, threshold, min_len) evaluation: a row of the JAX
    package's ``eval_df``."""

    meeting: str
    threshold: float
    min_len: float
    precision: float
    recall: float
    corr_pred_time: float
    tot_pred_time: float
    tot_transc_laugh_time: float
    num_of_pred_laughs: int
    valid_pred_laughs: int
    num_of_transc_laughs: int
    tot_fp_speech_time: float
    tot_fp_noise_time: float
    tot_fp_silence_time: float


class SumStats(NamedTuple):
    """Corpus-weighted stats of one (min_len, threshold): a row of the JAX
    package's ``calc_sum_stats`` frame."""

    threshold: float
    min_len: float
    precision: float
    recall: float
    f1: float


class MinLengthStats(NamedTuple):
    """A :class:`SumStats` row re-evaluated at one laugh-validity
    ``min_length``, with that grid point's corpus totals."""

    threshold: float
    min_len: float
    precision: float
    recall: float
    f1: float
    min_length: float
    laugh_tot_len: float
    laugh_events: int
    invalid_tot_len: float
    invalid_events: int


PRED_COLS = list(Prediction._fields)
EVAL_COLS = list(EvalRow._fields)


# --------------------------------------------------------------------------- #
# CSV, as pandas writes and reads it
# --------------------------------------------------------------------------- #


def _cell(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def write_csv(path, columns: Sequence[str], rows: Sequence[Sequence]) -> None:
    """``DataFrame(rows, columns).to_csv(path, index=False)``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([_cell(v) for v in row] for row in rows)


def read_csv(path, row_type) -> list:
    """Rows of a CSV written by :func:`write_csv` back as ``row_type``
    records, each cell typed by the record's field annotation (an empty
    float cell is NaN)."""
    types = typing.get_type_hints(row_type)

    def parse(name: str, text: str):
        kind = types[name]
        if kind is float:
            return float(text) if text else math.nan
        return kind(text)

    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        if header != list(row_type._fields):
            raise ValueError(f"{path}: columns {header} != {list(row_type._fields)}")
        return [row_type(*(parse(n, t) for n, t in zip(header, line))) for line in reader]


def format_rows(rows: Sequence[NamedTuple], columns: Sequence[str]) -> str:
    """A right-aligned text table of ``rows`` (the console view the JAX
    CLIs print with ``DataFrame.to_string(index=False)``)."""
    text = [list(columns)] + [
        ["NaN" if isinstance(v, float) and math.isnan(v) else f"{v:.6g}"
         if isinstance(v, float) else str(v) for v in row] for row in rows
    ]
    widths = [max(len(r[i]) for r in text) for i in range(len(columns))]
    return "\n".join(" ".join(c.rjust(w) for c, w in zip(r, widths)) for r in text)


# --------------------------------------------------------------------------- #
# Prediction loading
# --------------------------------------------------------------------------- #


def get_params_from_path(path: str) -> Dict[str, object]:
    """Parse (meeting_id, threshold, min_len, chan_id) from a prediction path
    ``<meeting>/t_<thr>/l_<minlen>/chanN[...].TextGrid``
    (reference analyse.py:64-96)."""
    parts = os.path.normpath(path).replace(".TextGrid", "").split(os.sep)
    chan_id = parts[-1].split("_")[0]
    if not chan_id.startswith("chan"):
        raise NameError(
            "channel .TextGrid files must be named 'chanN.TextGrid'"
        )
    meeting_id = parts[-4]
    if len(meeting_id) != 6:
        raise NameError(
            "chanN.TextGrid files must live under a 6-char meeting-ID dir "
            "(<meeting>/t_<thr>/l_<minlen>/)"
        )
    return {
        "chan_id": chan_id,
        "min_len": float(parts[-2].replace("l_", "")),
        "threshold": float(parts[-3].replace("t_", "")),
        "meeting_id": meeting_id,
    }


def textgrid_rows(textgrid_dir: str, store: TranscriptStore) -> List[Prediction]:
    """All laughter predictions in one ``l_<minlen>`` dir (reference
    analyse.py:49-61; the JAX package's ``textgrid_to_df``)."""
    rows: List[Prediction] = []
    for filename in sorted(os.listdir(textgrid_dir)):
        if not filename.endswith(".TextGrid"):
            continue
        # Only exact chanN.TextGrid names are predictions: 'notes.TextGrid'
        # is skipped, and 'chan0_backup.TextGrid' must not count twice
        # beside chan0.TextGrid.  Letter channels (chanA..chanF) are real
        # ICSI channels; unmapped names skip at the chan_to_part check.
        stem = filename[: -len(".TextGrid")]
        if not re.fullmatch(r"chan[0-9A-Za-z]+", stem):
            print(f"WARNING: skipping non-prediction file {filename}")
            continue
        full_path = os.path.join(textgrid_dir, filename)
        params = get_params_from_path(full_path)
        chan_map = store.chan_to_part.get(params["meeting_id"], {})
        if params["chan_id"] not in chan_map:
            continue  # unmapped channel (reference analyse.py:23-28)
        if os.stat(full_path).st_size == 0:
            print(
                f"WARNING: empty .TextGrid for "
                f"{params['meeting_id']}:{params['chan_id']}"
            )
            continue
        part_id = chan_map[params["chan_id"]]
        for start, end in tg.read_laughter_intervals(full_path):
            rows.append(Prediction(
                params["meeting_id"], part_id, params["chan_id"], start, end,
                end - start, params["threshold"], params["min_len"], "laugh",
            ))
    return rows


# --------------------------------------------------------------------------- #
# Matching
# --------------------------------------------------------------------------- #


def _overlap_sec(index: Index, pred: IntervalSet, meeting_id: str, part_id: str) -> float:
    if not index.has_part(meeting_id, part_id):
        return 0.0
    return to_sec(index.get(meeting_id, part_id).overlap_length(pred))


def laugh_match(
    pred_laugh: IntervalSet,
    meeting_id: str,
    part_id: str,
    idx: IndexStore,
) -> Tuple[float, float, float, float, float]:
    """(correct, incorrect, fp_speech, fp_noise, fp_silence) in seconds
    (reference analyse.py:120-149)."""
    pred_laugh = pred_laugh - idx.invalid.get(meeting_id, part_id)
    pred_length = to_sec(pred_laugh.length())
    correct = _overlap_sec(idx.laugh, pred_laugh, meeting_id, part_id)
    incorrect = pred_length - correct
    speech = _overlap_sec(idx.speech, pred_laugh, meeting_id, part_id)
    silence = _overlap_sec(idx.silence, pred_laugh, meeting_id, part_id)
    noise = _overlap_sec(idx.noise, pred_laugh, meeting_id, part_id)
    remain = incorrect - speech - silence - noise
    # One-sided on purpose: ICSI transcribes overlapping segments for one
    # participant, so a predicted frame can count against several fp_*
    # categories at once (as in the reference's per-index sums) and the
    # remainder go negative.  Only a POSITIVE remainder (predicted frames no
    # ground-truth index covers) means broken accounting.
    if remain >= 0.001:
        raise AssertionError(
            f"false-positive accounting does not close for {meeting_id}/{part_id}: "
            f"remainder {remain}"
        )
    return correct, incorrect, speech, noise, silence


def eval_preds(
    preds: Sequence[Prediction],
    meeting_id: str,
    threshold: float,
    min_len: float,
    store: TranscriptStore,
    idx: IndexStore,
) -> EvalRow:
    """Evaluation row for one (meeting, threshold, min_len)
    (reference analyse.py:152-225)."""
    tot_corr, tot_incorr = 0.0, 0.0
    fp_speech = fp_noise = fp_silence = 0.0
    tot_transc = idx.laugh.tot_len.get(meeting_id, 0.0)
    # Every transcribed laugh of the meeting, short and breath-laughs
    # included (reference analyse.py:163-165), while tot_transc (the recall
    # denominator) covers only valid laugh time.
    num_transc = sum(s.meeting_id == meeting_id for s in store.laugh_only)
    num_valid_pred = 0
    by_part: Dict[str, List[Prediction]] = {}
    for p in preds:
        by_part.setdefault(p.part_id, []).append(p)
    for part_id in sorted(by_part):
        invalid = idx.invalid.get(meeting_id, part_id)
        has_invalid = idx.invalid.has_part(meeting_id, part_id)
        # Frames past the transcript's EndTime (audio runs slightly longer)
        # or before 0 (Praat permits a negative xmin) belong to no
        # ground-truth index and would break the closure in laugh_match:
        # the time accounting is clamped to the transcribed extent.
        lens = [c.length for c in store.info
                if c.meeting_id == meeting_id and c.part_id == part_id]
        limit = to_frames(lens[0]) if lens else None
        pairs = []
        for p in by_part[part_id]:
            a, b = to_frames(p.start), to_frames(p.end)
            if not has_invalid or not invalid.contains(IntervalSet.openclosed(a, b)):
                num_valid_pred += 1
            if limit is not None:
                a, b = min(a, limit), min(b, limit)
            pairs.append((max(a, 0), max(b, 0)))
        corr, incorr, speech, noise, silence = laugh_match(
            IntervalSet.from_pairs(pairs), meeting_id, part_id, idx
        )
        tot_corr += corr
        tot_incorr += incorr
        fp_speech += speech
        fp_noise += noise
        fp_silence += silence

    tot_pred = tot_corr + tot_incorr
    prec = 1.0 if tot_pred == 0 else tot_corr / tot_pred
    recall = float("nan") if tot_transc == 0 else tot_corr / tot_transc
    return EvalRow(
        meeting_id, threshold, min_len, prec, recall, tot_corr, tot_pred,
        tot_transc, len(preds), num_valid_pred, num_transc, fp_speech,
        fp_noise, fp_silence,
    )


# --------------------------------------------------------------------------- #
# Corpus-level evaluation
# --------------------------------------------------------------------------- #


def _prefixed_float(name: str, prefix: str) -> Optional[float]:
    """FINITE float from ``<prefix><value>`` dir names; None otherwise (a
    ``l_nan`` dir would be evaluated, then dropped from the sum stats)."""
    if not name.startswith(prefix):
        return None
    try:
        v = float(name[len(prefix):])
    except ValueError:
        return None
    return v if math.isfinite(v) else None


def create_evaluation_df(
    preds_dir: str,
    store: TranscriptStore,
    idx: IndexStore,
    out_path: Optional[str] = None,
    use_cache: bool = False,
    verbose: bool = True,
) -> List[EvalRow]:
    """Walk ``<preds_dir>/<meeting>/t_<thr>/l_<minlen>/`` and evaluate every
    parameter set (reference analyse.py:227-266).  Writes the rows to
    ``out_path`` when given; with ``use_cache`` an existing ``out_path`` is
    read back instead."""
    if use_cache and out_path and os.path.isfile(out_path):
        return read_csv(out_path, EvalRow)
    rows: List[EvalRow] = []
    known_meetings = set(store.meeting_ids)
    for meeting in sorted(os.listdir(preds_dir)):
        meeting_path = os.path.join(preds_dir, meeting)
        if not os.path.isdir(meeting_path):
            continue
        if len(meeting) != 6:
            # A foreign directory (archive/, backup/) with copied t_*/l_*
            # trees is skipped, as get_params_from_path's rule says.
            if verbose:
                print(f"skipping non-meeting entry {meeting_path}", flush=True)
            continue
        if meeting not in known_meetings:
            # Known to the preambles, but no .mrt transcript (a subset
            # corpus): no index covers it.
            if verbose:
                print(f"skipping {meeting}: no transcript in the store", flush=True)
            continue
        for thr_name in sorted(os.listdir(meeting_path)):
            thr_dir = os.path.join(meeting_path, thr_name)
            if not (os.path.isdir(thr_dir) and _prefixed_float(thr_name, "t_") is not None):
                if verbose:
                    print(f"skipping non-threshold entry {thr_dir}", flush=True)
                continue
            for min_len_name in sorted(os.listdir(thr_dir)):
                tg_dir = os.path.join(thr_dir, min_len_name)
                if not (os.path.isdir(tg_dir)
                        and _prefixed_float(min_len_name, "l_") is not None):
                    if verbose:
                        print(f"skipping non-min-length entry {tg_dir}", flush=True)
                    continue
                if verbose:
                    print(f"meeting={meeting} thr={thr_name} min_len={min_len_name}",
                          flush=True)
                rows.append(eval_preds(
                    textgrid_rows(tg_dir, store), meeting,
                    float(thr_name.replace("t_", "")),
                    float(min_len_name.replace("l_", "")), store, idx,
                ))
    if out_path:
        write_csv(out_path, EVAL_COLS, rows)
    return rows


def calc_sum_stats(eval_rows: Sequence[EvalRow]) -> List[SumStats]:
    """Corpus-weighted precision / recall / F1 per (min_len, threshold),
    sorted by that key as pandas' ``groupby`` sorts it: sum the times
    across meetings, then divide (reference analyse.py:269-298).  Precision
    is 1 where nothing was predicted; F1 is 0 where precision + recall is 0
    and NaN where recall is NaN (no transcribed laugh time)."""
    sums: Dict[Tuple[float, float], List[float]] = {}
    for r in eval_rows:
        s = sums.setdefault((r.min_len, r.threshold), [0.0, 0.0, 0.0])
        s[0] += r.corr_pred_time
        s[1] += r.tot_pred_time
        s[2] += r.tot_transc_laugh_time
    out = []
    for (min_len, threshold), (corr, pred, transc) in sorted(sums.items()):
        precision = 1.0 if pred == 0 else corr / pred
        # pandas' float division: 0/0 is NaN, x/0 is inf.
        recall = corr / transc if transc != 0 else (math.nan if corr == 0 else math.inf)
        pr = precision + recall
        f1 = 2.0 * precision * recall / pr if pr != 0 else 0.0
        out.append(SumStats(threshold, min_len, precision, recall, f1))
    return out


def average_precision(sum_stats: Sequence[SumStats], min_len: float) -> float:
    """Step-integrated average precision over the threshold sweep at one
    ``min_len``: AP = sum_i (R_i - R_{i-1}) * P_i with thresholds ordered
    descending (recall ascending from the R_0 = 0 anchor), the
    interpolation-free definition of sklearn's average_precision_score.
    NaN when the split has no transcribed laugh time; a one-row sweep
    degenerates to R * P."""
    rows = [r for r in sum_stats if r.min_len == min_len]
    if not rows:
        raise ValueError(
            f"no sum-stats rows at min_len={min_len!r} "
            f"(have {sorted({r.min_len for r in sum_stats})})"
        )
    rows.sort(key=lambda r: r.threshold, reverse=True)
    if any(math.isnan(r.recall) for r in rows):
        return float("nan")
    ap = 0.0
    r_prev = 0.0
    for r in rows:
        ap += (r.recall - r_prev) * r.precision
        r_prev = r.recall
    return ap


# --------------------------------------------------------------------------- #
# Auxiliary analysis surface (reference analyse.py:420-506)
# --------------------------------------------------------------------------- #


def _segment_rows(segments: Sequence[Segment]) -> List[list]:
    return [[s.as_row()[c] for c in SEGMENT_COLUMNS] for s in segments]


def laugh_df_to_csv(
    segments: Sequence[Segment], out_path: str, laugh_type: str = "breath-laugh"
) -> int:
    """Export the transcribed laughs of one ``laugh_type`` to CSV (reference
    analyse.py:420-428, which hard-codes 'breath-laugh' and the output
    name).  Typical input: a TranscriptStore's ``laugh_only``.  Returns the
    number of rows written.  The CSV feeds laughs_to_wav for listening
    audits."""
    if any(not isinstance(s, Segment) for s in segments):
        raise ValueError("laugh_df_to_csv needs transcript Segment records")
    subset = [s for s in segments if s.laugh_type == laugh_type]
    write_csv(out_path, SEGMENT_COLUMNS, _segment_rows(subset))
    return len(subset)


def create_csvs_for_meeting(
    meeting_id: str,
    preds_dir: str,
    store: TranscriptStore,
    out_dir: str = ".",
    thresholds: Tuple[float, ...] = (0.2, 0.4, 0.6, 0.8),
    min_len: float = 0.2,
) -> Tuple[str, str]:
    """Write ``<meeting>_transc.csv`` (transcribed laughs) and
    ``<meeting>_preds.csv`` (predictions at several thresholds; duplicates
    across thresholds possible by design) for external analysis (reference
    analyse.py:481-506).  Missing sweep dirs are skipped with a warning.
    Returns ``(transc_path, preds_path)``."""
    known = set(store.meeting_ids)
    if meeting_id not in known:
        raise ValueError(
            f"unknown meeting {meeting_id!r} (transcript store has "
            f"{sorted(known)})"
        )
    os.makedirs(out_dir, exist_ok=True)
    transc_path = os.path.join(out_dir, f"{meeting_id}_transc.csv")
    write_csv(transc_path, SEGMENT_COLUMNS,
              _segment_rows([s for s in store.laugh_only if s.meeting_id == meeting_id]))
    preds: List[Prediction] = []
    for thr in thresholds:
        tg_dir = os.path.join(preds_dir, meeting_id, f"t_{thr}", f"l_{min_len}")
        if not os.path.isdir(tg_dir):
            print(f"WARNING: no prediction dir {tg_dir}; skipping", flush=True)
            continue
        preds.extend(textgrid_rows(tg_dir, store))
    preds_path = os.path.join(out_dir, f"{meeting_id}_preds.csv")
    write_csv(preds_path, PRED_COLS, preds)
    return transc_path, preds_path


def stats_for_different_min_lengths(
    preds_dir: str,
    store: TranscriptStore,
    min_lengths: Optional[List[float]] = None,
    cfg: AnalysisConfig = ANALYSIS,
    out_path: Optional[str] = None,
    verbose: bool = False,
) -> List[MinLengthStats]:
    """Sensitivity of the corpus sweep stats to the laugh-VALIDITY
    ``min_length`` (the transcript-side rule that routes short laughs into
    the invalid index), not the prediction-side ``min_len``.  The working
    redesign of reference analyse.py:431-479: each ``min_length`` rebuilds
    the interval indices with a replaced config and re-evaluates the
    predictions, caching off.  Default grid: 0.1..1.0 s in 0.1 steps."""
    if min_lengths is None:
        min_lengths = [round(0.1 * k, 1) for k in range(1, 11)]
    out: List[MinLengthStats] = []
    for ml in min_lengths:
        idx = indices_lib.build_indices(
            store, cfg=dataclasses.replace(cfg, min_length=float(ml))
        )
        rows = calc_sum_stats(create_evaluation_df(
            preds_dir, store, idx, out_path=None, use_cache=False, verbose=verbose
        ))
        totals = (
            sum(idx.laugh.tot_len.values()), int(sum(idx.laugh.tot_events.values())),
            sum(idx.invalid.tot_len.values()), int(sum(idx.invalid.tot_events.values())),
        )
        out.extend(MinLengthStats(*r, float(ml), *totals) for r in rows)
        if verbose:
            print(
                f"min_length={ml}: laugh={totals[0]:.2f}s/{totals[1]} events, "
                f"invalid={totals[2]:.2f}s/{totals[3]} events",
                flush=True,
            )
    if out_path:
        write_csv(out_path, MinLengthStats._fields, out)
    return out


def analyse(
    preds_dir: str,
    transcript_dir: Optional[str] = None,
    cfg: AnalysisConfig = ANALYSIS,
    force: bool = False,
) -> List[SumStats]:
    """Evaluate a prediction dir; writes ``<split>_sum_stats.csv`` and
    ``<split>_eval_df_per_meeting.csv`` next to it (reference
    analyse.py:508-539).  Returns the summary stats; without ``force`` an
    existing ``<split>_sum_stats.csv`` is read back instead."""
    if cfg.frame_duration_ms != 1:
        # Every to_frames / to_sec here runs at the reference's fixed 1 ms;
        # checked before the cache, which would otherwise answer for it.
        raise NotImplementedError(
            f"analyse() evaluates at 1 ms frames (reference semantics); got "
            f"cfg.frame_duration_ms={cfg.frame_duration_ms}"
        )
    preds_path = Path(preds_dir)
    split = preds_path.name
    sum_stats_path = preds_path.parent / f"{split}_{cfg.sum_stats_cache_file}"
    eval_df_path = preds_path.parent / f"{split}_{cfg.eval_df_cache_file}"
    if not force and sum_stats_path.is_file():
        return read_csv(sum_stats_path, SumStats)
    store = transcript_lib.load(transcript_dir)
    idx = indices_lib.load(store, force_recompute=cfg.force_index_recompute, cfg=cfg)
    eval_rows = create_evaluation_df(
        str(preds_path), store, idx, out_path=str(eval_df_path), use_cache=not force
    )
    sum_stats = calc_sum_stats(eval_rows)
    write_csv(sum_stats_path, SumStats._fields, sum_stats)
    return sum_stats
