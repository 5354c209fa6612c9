"""The port's transcript parser (eval/transcript.py, on ElementTree) against
the JAX package's (on lxml and pandas).

Tolerance 0: every segment list and the channel info equal the JAX
DataFrames row for row, and the xmllint-equivalent laugh counts are equal,
on the synthetic corpus and on hand-written edge cases (comments and
processing instructions inside laugh segments, segments with no text
nodes or whitespace-only text, a stray ``<meeting>.orig.mrt``).
"""

import dataclasses
import math
import shutil

import pytest

from laughter_detection_icsi_tpu.eval import transcript as jtr
from laughter_detection_icsi_tpu_torch.eval import transcript as ttr
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401


def _records(df):
    """DataFrame rows as dicts, a missing string (None or NaN) as None."""
    miss = lambda v: v is None or (isinstance(v, float) and math.isnan(v))
    return [{k: None if miss(v) else v for k, v in r.items()} for r in df.to_dict("records")]


def _assert_stores_equal(got: ttr.TranscriptStore, want: jtr.TranscriptStore):
    assert got.chan_to_part == want.chan_to_part
    assert got.part_to_chan == want.part_to_chan
    assert got.meeting_ids == want.meeting_ids
    for mine, theirs in (("laugh_only", "laugh_only_df"), ("speech", "speech_df"),
                         ("invalid", "invalid_df"), ("noise", "noise_df")):
        assert [s.as_row() for s in getattr(got, mine)] == _records(getattr(want, theirs)), mine
    assert [dataclasses.asdict(c) for c in got.info] == _records(want.info_df)
    assert ttr.SEGMENT_COLUMNS == jtr.SEGMENT_COLUMNS
    assert ttr.INFO_COLUMNS == jtr.INFO_COLUMNS


def test_store_equals_jax_on_synthetic_corpus(synthetic_corpus):
    tdir = str(synthetic_corpus.transcript_dir)
    got = ttr.TranscriptStore(tdir)
    _assert_stores_equal(got, jtr.TranscriptStore(tdir))
    assert len(got.laugh_only) == 6 and len(got.info) == 4
    assert ttr.count_laugh_segments(tdir) == jtr.count_laugh_segments(tdir)


# Segments of an edge-case meeting, each serialized as the real corpus or an
# annotator might have it.  Expected: (classification, counted "all",
# counted "laugh only").
EDGE_SEGMENTS = [
    # whitespace-rich pure laugh (the real corpus's serialization)
    ("\n      <VocalSound Description=\"laugh\"/>\n    ", "laugh", 1, 1),
    # no text nodes at all: xmllint's laugh-only predicate never matches
    ("<VocalSound Description=\"laugh\"/>", "laugh", 1, 0),
    # single-space text on both sides
    (" <VocalSound Description=\"laugh\"/> ", "laugh", 1, 1),
    # whitespace before only
    ("\n<VocalSound Description=\"laugh\"/>", "laugh", 1, 0),
    # an annotator comment inside the laugh segment
    ("\n  <!-- annotator note --> <VocalSound Description=\"laugh\"/>\n", "laugh", 1, 1),
    # a comment with no whitespace around it
    ("<!--c--><VocalSound Description=\"laugh\"/><!--d-->", "laugh", 1, 0),
    # a comment splitting text: one blank text node before the laugh exists
    ("\n<!-- c -->x<VocalSound Description=\"laugh\"/>\n", "invalid", 1, 1),
    # a processing instruction after the laugh
    ("\n<VocalSound Description=\"laugh\"/><?note x?>\n", "laugh", 1, 1),
    # a laugh next to speech
    ("\n<VocalSound Description=\"laugh\"/> yeah\n", "invalid", 1, 0),
    # a laugh beside another element
    ("\n<VocalSound Description=\"laugh\"/>\n<NonVocalSound Description=\"clap\"/>\n",
     "invalid", 1, 0),
    # a breath-laugh (a laugh type; its validity is the index's business)
    ("\n<VocalSound Description=\"breath-laugh\"/>\n", "laugh", 1, 1),
    # a comment only: no element child
    ("<!-- silence -->", "speech", 0, 0),
    # a cough, and a cough with a comment
    ("<VocalSound Description=\"cough\"/>", "other_vocal", 0, 0),
    ("<!--x--> <NonVocalSound Description=\"door\"/> <Comment Description=\"c\"/>", "mixed", 0, 0),
    # non-breaking space is text to XPath's normalize-space
    ("\u00a0<VocalSound Description=\"laugh\"/>\n", "laugh", 1, 0),
]

PREAMBLES = """<?xml version="1.0" encoding="UTF-8"?>
<Preambles>
  <Meeting Session="Bmr001">
    <Preamble><Participants>
      <Participant Name="me001" Channel="chan0"/>
      <Participant Name="me002" Channel="chanB"/>
      <!-- a comment among the participants -->
      <Participant Name="mn003"/>
    </Participants></Preamble>
  </Meeting>
</Preambles>
"""


@pytest.fixture(scope="module")
def edge_dir(tmp_path_factory):
    tdir = tmp_path_factory.mktemp("edge_transcripts")
    (tdir / "preambles.mrt").write_text(PREAMBLES)
    segs = "\n".join(
        f'    <Segment StartTime="{2 * i}.0" EndTime="{2 * i + 1}.5" '
        f'Participant="{"me001" if i % 2 else "me002"}">{body}</Segment>'
        for i, (body, *_rest) in enumerate(EDGE_SEGMENTS)
    )
    (tdir / "Bmr001.mrt").write_text(
        '<?xml version="1.0" encoding="UTF-8"?>\n<Meeting Session="Bmr001">\n'
        f'  <Transcript StartTime="0.0" EndTime="40.0">\n{segs}\n  </Transcript>\n</Meeting>\n'
    )
    return tdir


def test_edge_cases_classify_and_count_as_jax(edge_dir):
    got = ttr.TranscriptStore(str(edge_dir))
    _assert_stores_equal(got, jtr.TranscriptStore(str(edge_dir)))
    kinds = {}
    for seg in got.laugh_only + got.speech + got.invalid + got.noise:
        kinds[int(seg.start) // 2] = seg.type.value
    assert [kinds[i] for i in range(len(EDGE_SEGMENTS))] == [k for _, k, _, _ in EDGE_SEGMENTS]
    counts = ttr.count_laugh_segments(str(edge_dir))
    assert counts == jtr.count_laugh_segments(str(edge_dir))
    assert counts["Bmr001"] == (sum(e[2] for e in EDGE_SEGMENTS), sum(e[3] for e in EDGE_SEGMENTS))


def test_stray_dotted_mrt_is_not_a_meeting(edge_dir, tmp_path):
    tdir = tmp_path / "t"
    shutil.copytree(edge_dir, tdir)
    shutil.copyfile(tdir / "Bmr001.mrt", tdir / "Bmr001.orig.mrt")
    got = ttr.TranscriptStore(str(tdir))
    _assert_stores_equal(got, jtr.TranscriptStore(str(tdir)))
    assert len(got.laugh_only) == len(ttr.TranscriptStore(str(edge_dir)).laugh_only)
    assert ttr.count_laugh_segments(str(tdir)) == jtr.count_laugh_segments(str(tdir))
    assert ttr.count_laugh_segments(str(tdir)) == ttr.count_laugh_segments(str(edge_dir))


def test_two_channel_participant_warns_as_jax(tmp_path, capsys):
    (tmp_path / "preambles.mrt").write_text(
        '<?xml version="1.0"?>\n<Meetings>\n'
        '<Meeting Session="Bxx001">\n<Preamble>\n<Participants>\n'
        '<Participant Name="me013" Channel="chan0"/>\n'
        '<Participant Name="me013" Channel="chan1"/>\n'
        "</Participants>\n</Preamble>\n</Meeting>\n</Meetings>\n"
    )
    path = str(tmp_path / "preambles.mrt")
    got = ttr.parse_preambles(path)
    out_port = capsys.readouterr().out
    want = jtr.parse_preambles(path)
    out_jax = capsys.readouterr().out
    assert got == want and out_port == out_jax
    assert "WARNING" in out_port and got[1]["Bxx001"]["me013"] == "chan0"


def test_load_is_content_keyed(synthetic_corpus, tmp_path):
    tdir = tmp_path / "t"
    shutil.copytree(synthetic_corpus.transcript_dir, tdir)
    first = ttr.load(str(tdir))
    assert ttr.load(str(tdir)) is first
    mrt = tdir / "Bmr021.mrt"
    # A longer file: the size changes even where the clock is coarse.
    mrt.write_text(mrt.read_text().replace('EndTime="100.0"', 'EndTime="1000.0"'))
    second = ttr.load(str(tdir))
    assert second is not first and second.info[0].length == 1000.0
    assert sum(k.startswith(f"{tdir.resolve()}#") for k in ttr._STORE_CACHE) == 1
