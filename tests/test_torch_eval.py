"""The port's evaluator (eval/intervals.py, eval/indices.py, eval/analyse.py:
no pandas, no lxml) against the JAX package's.

Tolerances: the interval algebra and the indices exactly (sets, lengths and
event counts, tolerance 0); every CSV the port writes, read back with
``pandas.read_csv``, equals the JAX package's DataFrame within rtol 1e-12
with NaN in the same cells.  The predictions are the hand-built dir of
tests/test_analyse.py plus a letter channel, an unparseable ``t_x`` dir,
an ``l_nan`` dir, a prediction past the transcript's end and a meeting with
no transcribed laughter (NaN recall).
"""

import dataclasses
import math
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from laughter_detection_icsi_tpu.config import ANALYSIS as JANALYSIS
from laughter_detection_icsi_tpu.eval import analyse as jan
from laughter_detection_icsi_tpu.eval import indices as jix
from laughter_detection_icsi_tpu.eval import intervals as jiv
from laughter_detection_icsi_tpu.eval import transcript as jtr
from laughter_detection_icsi_tpu_torch.config import ANALYSIS
from laughter_detection_icsi_tpu_torch.eval import analyse as an
from laughter_detection_icsi_tpu_torch.eval import indices as tix
from laughter_detection_icsi_tpu_torch.eval import intervals as tiv
from laughter_detection_icsi_tpu_torch.eval import textgrid as tg
from laughter_detection_icsi_tpu_torch.eval import transcript as ttr
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401

RTOL = 1e-12


# --------------------------------------------------------------------------- #
# Interval algebra
# --------------------------------------------------------------------------- #


def _random_pairs(rng, n):
    starts = rng.integers(0, 500, n)
    return list(zip(starts.tolist(), (starts + rng.integers(0, 40, n)).tolist()))


@pytest.mark.parametrize("seed", range(4))
def test_interval_algebra_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        pa, pb = _random_pairs(rng, rng.integers(0, 12)), _random_pairs(rng, rng.integers(0, 12))
        ta, tb = tiv.IntervalSet.from_pairs(pa), tiv.IntervalSet.from_pairs(pb)
        ja, jb = jiv.IntervalSet.from_pairs(pa), jiv.IntervalSet.from_pairs(pb)
        for op in ("union", "intersection", "difference"):
            got, want = getattr(ta, op)(tb), getattr(ja, op)(jb)
            assert list(got.pairs()) == list(want.pairs()), op
        assert ta.overlap_length(tb) == ja.overlap_length(jb)
        assert ta.overlaps(tb) == ja.overlaps(jb)
        assert ta.contains(tb) == ja.contains(jb)
        assert ta.length() == ja.length()
    for t in (0.0, 0.0005, 0.0015, 1.2345, 59.9995):
        assert tiv.to_frames(t) == jiv.to_frames(t) and tiv.to_sec(7) == jiv.to_sec(7)


# --------------------------------------------------------------------------- #
# A corpus with a letter channel and a meeting without laughter
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def corpus(synthetic_corpus, tmp_path_factory):
    tdir = tmp_path_factory.mktemp("eval_corpus") / "transcripts"
    shutil.copytree(synthetic_corpus.transcript_dir, tdir)
    pre = (tdir / "preambles.mrt").read_text()
    pre = pre.replace(
        '<Participant Name="me004" Channel="chan1"/>',
        '<Participant Name="me004" Channel="chan1"/>\n'
        '        <Participant Name="me005" Channel="chanA"/>',
    ).replace(
        "</Preambles>",
        '  <Meeting Session="Bns001"><Preamble><Participants>\n'
        '    <Participant Name="me006" Channel="chan0"/>\n'
        "  </Participants></Preamble></Meeting>\n</Preambles>",
    )
    (tdir / "preambles.mrt").write_text(pre)
    mrt = (tdir / "Bmr021.mrt").read_text().replace(
        "  </Transcript>",
        '    <Segment StartTime="60.0" EndTime="62.0" Participant="me005">'
        '<VocalSound Description="laugh"/></Segment>\n'
        '    <Segment StartTime="62.0" EndTime="62.1" Participant="me005">'
        '<VocalSound Description="laugh"/></Segment>\n'
        '    <Segment StartTime="64.0" EndTime="66.0" Participant="me005">'
        'words</Segment>\n  </Transcript>',
    )
    (tdir / "Bmr021.mrt").write_text(mrt)
    (tdir / "Bns001.mrt").write_text(
        '<?xml version="1.0" encoding="UTF-8"?>\n<Meeting Session="Bns001">\n'
        '  <Transcript StartTime="0.0" EndTime="30.0">\n'
        '    <Segment StartTime="1.0" EndTime="3.0" Participant="me006">hi</Segment>\n'
        "  </Transcript>\n</Meeting>\n"
    )
    return tdir


@pytest.fixture(scope="module")
def stores(corpus):
    return ttr.TranscriptStore(str(corpus)), jtr.TranscriptStore(str(corpus))


def _grid(d, name, spans, xmax):
    d.mkdir(parents=True, exist_ok=True)
    tg.write_textgrid(str(d / name), spans, xmax=xmax)


@pytest.fixture(scope="module")
def preds_dir(tmp_path_factory):
    """tests/test_analyse.py's predictions plus the edge cases."""
    root = tmp_path_factory.mktemp("preds") / "dev"
    d = root / "Bmr021" / "t_0.5" / "l_0.2"
    _grid(d, "chan0.TextGrid", [(10.0, 12.0), (15.0, 16.0)], 100.0)
    _grid(d, "chan1.TextGrid", [(50.0, 50.5), (25.0, 25.5)], 100.0)
    _grid(d, "chan7.TextGrid", [(1.0, 2.0)], 100.0)  # unmapped channel
    (d / "chan3.TextGrid").write_text("")  # empty file
    _grid(d, "chanA.TextGrid", [(60.5, 61.5), (64.5, 70.0), (62.0, 62.1)], 100.0)  # letter
    _grid(d, "notes.TextGrid", [(1.0, 2.0)], 100.0)  # not a prediction
    _grid(root / "Bmr021" / "t_0.8" / "l_0.2", "chan0.TextGrid", [], 100.0)
    d2 = root / "Btr001" / "t_0.5" / "l_0.2"
    _grid(d2, "chan0.TextGrid", [(20.0, 21.0), (10.0, 11.0), (58.0, 65.0)], 66.0)
    _grid(root / "Btr001" / "t_0.5" / "l_0.0", "chan1.TextGrid", [(35.0, 36.5), (5.0, 6.5)], 60.0)
    _grid(root / "Btr001" / "t_x" / "l_0.2", "chan0.TextGrid", [(1.0, 2.0)], 60.0)
    _grid(root / "Btr001" / "t_0.5" / "l_nan", "chan0.TextGrid", [(1.0, 2.0)], 60.0)
    (root / "Btr001" / "stray.txt").write_text("x")
    _grid(root / "Bns001" / "t_0.7" / "l_0.2", "chan0.TextGrid", [(1.5, 2.5), (9.0, 9.5)], 30.0)
    _grid(root / "backup" / "t_0.5" / "l_0.2", "chan0.TextGrid", [(1.0, 2.0)], 60.0)
    return root


def _index_equal(got, want):
    assert list(got.sets) == list(want.sets)
    for m in want.sets:
        assert list(got.sets[m]) == list(want.sets[m]), m
        for p in want.sets[m]:
            assert list(got.sets[m][p].pairs()) == list(want.sets[m][p].pairs()), (m, p)
    assert got.tot_len == want.tot_len  # same sums in the same order: exact
    assert got.tot_events == want.tot_events


@pytest.mark.parametrize("min_length", [None, 0.05, 1.0, 2.5])
def test_build_indices_equal_jax(stores, min_length):
    cfg, jcfg = ANALYSIS, JANALYSIS
    if min_length is not None:
        cfg = dataclasses.replace(ANALYSIS, min_length=min_length)
        jcfg = dataclasses.replace(JANALYSIS, min_length=min_length)
    got, want = tix.build_indices(stores[0], cfg), jix.build_indices(stores[1], jcfg)
    for name in ("laugh", "invalid", "speech", "noise", "silence"):
        _index_equal(getattr(got, name), getattr(want, name))
    assert tix._cache_key(stores[0].transcript_dir, cfg) == jix._cache_key(
        stores[1].transcript_dir, jcfg)


def test_index_disk_cache_round_trip(stores, tmp_path):
    built = tix.load(stores[0], cache_dir=str(tmp_path), force_recompute=True)
    (pkl,) = tmp_path.glob("indices_*.pkl")
    tix._INDEX_CACHE.clear()
    again = tix.load(stores[0], cache_dir=str(tmp_path))
    assert again is not built
    _index_equal(again.laugh, built.laugh)
    _index_equal(again.silence, built.silence)
    assert pkl.name == f"indices_{tix._cache_key(stores[0].transcript_dir)}.pkl"


# --------------------------------------------------------------------------- #
# The evaluator's CSVs
# --------------------------------------------------------------------------- #


def _assert_rows_equal(got, want):
    """Records equal field for field, NaN where NaN, types included."""
    nan = lambda v: isinstance(v, float) and math.isnan(v)
    assert len(got) == len(want) and all(type(a) is type(b) for a, b in zip(got, want))
    for a, b in zip(got, want):
        assert all((nan(x) and nan(y)) or (x == y and type(x) is type(y)) for x, y in zip(a, b)), (a, b)


def _assert_csv_equal(path, want: pd.DataFrame):
    got = pd.read_csv(path)
    pd.testing.assert_frame_equal(got, want.reset_index(drop=True), rtol=RTOL)


@pytest.fixture(scope="module")
def evaluated(stores, preds_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("eval_out")
    idx = tix.build_indices(stores[0])
    jidx = jix.build_indices(stores[1])
    rows = an.create_evaluation_df(str(preds_dir), stores[0], idx,
                                   out_path=str(out / "eval.csv"), verbose=False)
    jdf = jan.create_evaluation_df(str(preds_dir), stores[1], jidx, verbose=False)
    return rows, jdf, out, idx, jidx


def test_textgrid_rows_equal_jax(stores, preds_dir):
    d = preds_dir / "Bmr021" / "t_0.5" / "l_0.2"
    got = an.textgrid_rows(str(d), stores[0])
    want = jan.textgrid_to_df(str(d), stores[1])
    assert [list(r) for r in got] == want.values.tolist()
    assert an.PRED_COLS == jan.PRED_COLS and an.EVAL_COLS == jan.EVAL_COLS
    assert {r.chan for r in got} == {"chan0", "chan1", "chanA"}


def test_eval_df_csv_equals_jax(evaluated):
    rows, jdf, out, _, _ = evaluated
    assert len(rows) == len(jdf) == 5
    _assert_csv_equal(out / "eval.csv", jdf)
    bns = jdf[jdf["meeting"] == "Bns001"]
    assert bns["recall"].isna().all()  # no transcribed laughter: NaN recall
    # Read back through the port's cache path, as the same rows.
    again = an.create_evaluation_df("unused", None, None, out_path=str(out / "eval.csv"),
                                    use_cache=True)
    _assert_rows_equal(again, rows)


def test_sum_stats_and_average_precision_equal_jax(evaluated):
    rows, jdf, out, _, _ = evaluated
    got = an.calc_sum_stats(rows)
    want = jan.calc_sum_stats(jdf)
    an.write_csv(out / "sum.csv", an.SumStats._fields, got)
    _assert_csv_equal(out / "sum.csv", want)
    assert any(math.isnan(r.recall) and math.isnan(r.f1) for r in got)
    for ml in sorted({r.min_len for r in got}):
        a, b = an.average_precision(got, ml), jan.average_precision(want, ml)
        assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b, rel=RTOL)
    with pytest.raises(ValueError, match="no sum-stats rows"):
        an.average_precision(got, 0.3)


def test_analyse_end_to_end_equals_jax(corpus, preds_dir, tmp_path):
    mine, theirs = tmp_path / "mine" / "dev", tmp_path / "theirs" / "dev"
    shutil.copytree(preds_dir, mine)
    shutil.copytree(preds_dir, theirs)
    got = an.analyse(str(mine), transcript_dir=str(corpus), force=True)
    want = jan.analyse(str(theirs), transcript_dir=str(corpus), force=True)
    _assert_csv_equal(mine.parent / "dev_sum_stats.csv", want)
    _assert_csv_equal(mine.parent / "dev_eval_df_per_meeting.csv",
                      pd.read_csv(theirs.parent / "dev_eval_df_per_meeting.csv"))
    # force=False reads the cached sum stats back as the same rows.
    _assert_rows_equal(an.analyse(str(mine), transcript_dir=str(corpus)), got)
    with pytest.raises(NotImplementedError, match="1 ms"):
        an.analyse(str(mine), cfg=dataclasses.replace(ANALYSIS, frame_duration_ms=10))


def test_min_length_sweep_equals_jax(stores, preds_dir, tmp_path):
    an.stats_for_different_min_lengths(str(preds_dir), stores[0], min_lengths=[0.05, 0.2, 1.5],
                                       out_path=str(tmp_path / "ml.csv"))
    want = jan.stats_for_different_min_lengths(str(preds_dir), stores[1],
                                               min_lengths=[0.05, 0.2, 1.5])
    _assert_csv_equal(tmp_path / "ml.csv", want)


def test_meeting_csvs_equal_jax(stores, preds_dir, tmp_path):
    for meeting in ("Bmr021", "Bns001"):
        got = an.create_csvs_for_meeting(meeting, str(preds_dir), stores[0],
                                         out_dir=str(tmp_path / "mine"), thresholds=(0.5, 0.8, 0.9))
        want = jan.create_csvs_for_meeting(meeting, str(preds_dir), stores[1],
                                           out_dir=str(tmp_path / "jax"), thresholds=(0.5, 0.8, 0.9))
        for g, w in zip(got, want):
            pd.testing.assert_frame_equal(pd.read_csv(g), pd.read_csv(w), rtol=RTOL)
    with pytest.raises(ValueError, match="unknown meeting"):
        an.create_csvs_for_meeting("Bxx999", str(preds_dir), stores[0], out_dir=str(tmp_path))


@pytest.mark.parametrize("laugh_type", ["breath-laugh", "laugh", "giggle"])
def test_laugh_df_to_csv_equals_jax(stores, tmp_path, laugh_type):
    n = an.laugh_df_to_csv(stores[0].laugh_only, str(tmp_path / "mine.csv"), laugh_type)
    m = jan.laugh_df_to_csv(stores[1].laugh_only_df, str(tmp_path / "jax.csv"), laugh_type)
    assert n == m
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "mine.csv"),
                                  pd.read_csv(tmp_path / "jax.csv"), rtol=RTOL)


@pytest.mark.parametrize("flags", [
    ["--laugh_counts"],
    ["--breath_laugh_csv", "{out}/breath.csv"],
    ["{preds}", "--meeting_csvs", "Bmr021", "--out_dir", "{out}"],
    ["{preds}", "--min_length_sweep", "0.1,0.5"],
    ["{preds}", "--force"],
], ids=["laugh_counts", "breath_laugh_csv", "meeting_csvs", "min_length_sweep", "evaluate"])
def test_analyse_cli_outputs_equal_jax(corpus, preds_dir, tmp_path, capsys, flags):
    """The port's cli/analyse.py against the JAX CLI on the same flags: the
    same files (CSV for CSV) and the same summary lines."""
    from cli import analyse as jax_cli
    from laughter_detection_icsi_tpu_torch.cli import analyse as port_cli

    printed, files = {}, {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        preds, out = tmp_path / name / "dev", tmp_path / name / "out"
        shutil.copytree(preds_dir, preds)
        out.mkdir()
        argv = [f.format(preds=preds, out=out) for f in flags] + ["--transcript_dir", str(corpus)]
        assert cli.main(argv) == 0
        printed[name] = [line for line in capsys.readouterr().out.splitlines()
                         if line.startswith(("Bmr", "Btr", "Bns", "total:", "best F1", "AP(", "wrote"))]
        files[name] = sorted(p.relative_to(tmp_path / name) for p in (tmp_path / name).rglob("*.csv"))
    assert files["port"] == files["jax"] and printed["port"]
    for rel in files["port"]:
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / rel),
                                      pd.read_csv(tmp_path / "jax" / rel), rtol=RTOL)
    local = lambda name: [line.replace(str(tmp_path / name), "") for line in printed[name]]
    assert local("port") == local("jax")


def test_load_env_reads_no_file_above_the_cwd(tmp_path, monkeypatch):
    """The default ``.env`` is looked for in the CWD only: one in a parent
    directory (another tree's) must not set TRANSCRIPT_DIR.  A ``.env`` in
    the CWD is read, and a missing named file raises."""
    from laughter_detection_icsi_tpu_torch.config import load_env

    # setenv first, so that teardown removes what load_env sets.
    monkeypatch.setenv("TRANSCRIPT_DIR", "")
    monkeypatch.delenv("TRANSCRIPT_DIR")
    (tmp_path / ".env").write_text("TRANSCRIPT_DIR=/elsewhere/transcripts\n")
    checkout = tmp_path / "checkout"
    checkout.mkdir()
    monkeypatch.chdir(checkout)
    assert load_env() == {} and "TRANSCRIPT_DIR" not in os.environ
    (checkout / ".env").write_text("export TRANSCRIPT_DIR='here' # local\n")
    assert load_env() == {"TRANSCRIPT_DIR": "here"}
    with pytest.raises(FileNotFoundError, match="missing.env"):
        load_env("missing.env")
