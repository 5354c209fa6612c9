"""ICSI ``.mrt`` transcript parsing into typed segment records.

The port of the JAX package's ``eval/transcript.py`` (reference
analysis/transcript_parsing/parse.py:28-307) on the standard library's
``xml.etree.ElementTree`` and plain records, with neither ``lxml`` nor
``pandas``: parse the preambles for channel <-> participant maps, classify
every ``<Segment>`` of every meeting transcript, and keep the segment lists
the evaluation consumes.

The tree is built as lxml builds it: comments and processing instructions
stay in it as children whose tag is not a ``str`` (ElementTree's default
parser would drop them and merge the text around them), so the text-node
rules of :func:`count_laugh_segments` and :func:`classify_segment` see the
nodes lxml's XPath sees.  ElementTree's XPath has no ``and``, no
``contains()``, no ``count()`` and no text-node axes: those predicates are
written out in Python below.

Classification semantics (mirrors reference parse.py:117-165):
- 0 children                      -> SPEECH
- 1 child VocalSound 'laugh...'   -> LAUGH if the segment has no text at all,
                                     else INVALID (laughter next to speech)
- 1 child VocalSound other        -> OTHER_VOCAL
- 1 child NonVocalSound           -> NON_VOCAL
- 1 child other tag (Comment, ...) -> SPEECH
- >1 children, any laugh          -> INVALID
- >1 children, any (Non)VocalSound-> MIXED
- >1 children, otherwise          -> SPEECH

Segment lists (reference parse.py:168-203): laugh_only = LAUGH,
speech = SPEECH, invalid = INVALID, noise = MIXED | NON_VOCAL | OTHER_VOCAL.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from laughter_detection_icsi_tpu_torch import config as _config


class SegmentType(str, enum.Enum):
    INVALID = "invalid"
    SPEECH = "speech"
    LAUGH = "laugh"
    OTHER_VOCAL = "other_vocal"
    NON_VOCAL = "non_vocal"
    MIXED = "mixed"


@dataclasses.dataclass
class Segment:
    """One transcription segment (reference parse.py:41-51)."""

    meeting_id: str
    part_id: str
    chan_id: str
    start: float
    end: float
    length: float
    type: SegmentType
    laugh_type: Optional[str]

    def as_row(self) -> Dict:
        d = dataclasses.asdict(self)
        d["type"] = self.type.value
        return d


@dataclasses.dataclass
class ChannelInfo:
    """One (meeting, channel) of the corpus: a row of the JAX package's
    ``info_df``."""

    meeting_id: str
    part_id: str
    chan_id: str
    length: float  # the meeting's transcript EndTime, seconds
    path: str  # <meeting>/<chan>.sph


SEGMENT_COLUMNS = [f.name for f in dataclasses.fields(Segment)]
INFO_COLUMNS = [f.name for f in dataclasses.fields(ChannelInfo)]

# XPath's normalize-space() strips these four, not Python's str.strip() set.
_XML_SPACE = " \t\r\n"


def parse_xml(path) -> ET.ElementTree:
    """Parse keeping comments and processing instructions in the tree, as
    lxml does (see the module docstring)."""
    parser = ET.XMLParser(target=ET.TreeBuilder(insert_comments=True, insert_pis=True))
    return ET.parse(str(path), parser=parser)


def _elements(el) -> List:
    """Element children only: comments and PIs have a non-str tag."""
    return [c for c in el if isinstance(c.tag, str)]


def _itertext(el) -> Iterator[str]:
    """lxml's ``itertext``: the text of the element and its element
    descendants, with every child's tail; a comment's or PI's own text is
    skipped (ElementTree's ``itertext`` would yield it)."""
    if el.text:
        yield el.text
    for c in el:
        if isinstance(c.tag, str):
            yield from _itertext(c)
        if c.tail:
            yield c.tail


def _is_laugh(el) -> bool:
    """``VocalSound[contains(@Description, 'laugh')]``."""
    return el.tag == "VocalSound" and "laugh" in (el.get("Description") or "")


def parse_preambles(
    preambles_path: str,
) -> Tuple[Dict[str, Dict[str, str]], Dict[str, Dict[str, str]]]:
    """Parse ``preambles.mrt`` into (chan_to_part, part_to_chan) maps
    (reference parse.py:54-81).  Only participants with both Name and Channel
    attributes are mapped."""
    root = parse_xml(preambles_path).getroot()
    chan_to_part: Dict[str, Dict[str, str]] = {}
    for meeting in root.iter("Meeting"):
        session = meeting.get("Session")
        chan_map: Dict[str, str] = {}
        for part in meeting.findall("./Preamble/Participants/Participant"):
            if part.get("Name") is not None and part.get("Channel") is not None:
                chan_map[part.get("Channel")] = part.get("Name")
        chan_to_part[session] = chan_map
    part_to_chan: Dict[str, Dict[str, str]] = {}
    for mid, cmap in chan_to_part.items():
        inv: Dict[str, str] = {}
        for c, p in cmap.items():
            if p in inv:
                # A participant on two channels (a mic switch) makes the
                # inversion ambiguous: surface it and keep the first
                # listing, rather than attribute every segment to the last.
                print(
                    f"WARNING: {mid}: participant {p!r} listed on channels "
                    f"{inv[p]} and {c}; segments attributed to {inv[p]}",
                    flush=True,
                )
                continue
            inv[p] = c
        part_to_chan[mid] = inv
    return chan_to_part, part_to_chan


def classify_segment(xml_seg) -> Tuple[SegmentType, Optional[str]]:
    """Classify one ``<Segment>`` element (reference parse.py:117-165).
    Comments and PIs are not children (the JAX package's rule)."""
    children = _elements(xml_seg)
    if len(children) == 0:
        return SegmentType.SPEECH, None
    if len(children) == 1:
        child = children[0]
        if child.tag == "VocalSound":
            desc = child.get("Description") or ""
            if "laugh" in desc:
                if "".join(_itertext(xml_seg)).strip() == "":
                    return SegmentType.LAUGH, desc
                return SegmentType.INVALID, None
            return SegmentType.OTHER_VOCAL, None
        if child.tag == "NonVocalSound":
            return SegmentType.NON_VOCAL, None
        # e.g. <Comment> wrapping plain speech
        return SegmentType.SPEECH, None
    # Multiple children: laughter next to anything else is untrackable ->
    # excluded from evaluation as INVALID.
    if any(_is_laugh(c) for c in children):
        return SegmentType.INVALID, None
    tags = {c.tag for c in children}
    if "NonVocalSound" in tags or "VocalSound" in tags:
        return SegmentType.MIXED, None
    return SegmentType.SPEECH, None


def _as_tree(mrt) -> ET.ElementTree:
    """An .mrt path or an already-parsed tree."""
    return mrt if hasattr(mrt, "getroot") else parse_xml(mrt)


def parse_meeting(
    mrt_path,
    meeting_id: str,
    part_to_chan: Dict[str, Dict[str, str]],
) -> List[Segment]:
    """Parse one meeting transcript (path or parsed tree) into Segment
    records.  Segments whose participant has no mapped audio channel are
    dropped (reference parse.py:93-98)."""
    root = _as_tree(mrt_path).getroot()
    chan_of = part_to_chan.get(meeting_id, {})
    out: List[Segment] = []
    for xml_seg in root.iter("Segment"):
        part_id = xml_seg.get("Participant")
        if part_id not in chan_of:
            continue
        start = float(xml_seg.get("StartTime"))
        end = float(xml_seg.get("EndTime"))
        seg_type, laugh_type = classify_segment(xml_seg)
        out.append(
            Segment(
                meeting_id=meeting_id,
                part_id=part_id,
                chan_id=chan_of[part_id],
                start=start,
                end=end,
                length=end - start,
                type=seg_type,
                laugh_type=laugh_type,
            )
        )
    return out


def meeting_length(mrt_path) -> float:
    """EndTime of the meeting's <Transcript> element (reference
    parse.py:206-215).  Accepts a path or a parsed tree."""
    transcript = _as_tree(mrt_path).find(".//Transcript")
    return float(transcript.get("EndTime"))


def _is_meeting_file(filename: str) -> bool:
    """EXACTLY '<6 chars>.mrt' (every ICSI meeting ID has 6 characters): a
    stray 'Bmr001.orig.mrt' must not parse as a second copy of Bmr001."""
    stem, dot, ext = filename.partition(".")
    return bool(dot) and ext == "mrt" and len(stem) == 6


class TranscriptStore:
    """Parsed corpus ground truth: segment records and channel maps.

    Stands for the JAX package's store, attribute for attribute:
    ``laugh_only`` for ``laugh_only_df``, ``speech`` for ``speech_df``,
    ``invalid`` for ``invalid_df``, ``noise`` for ``noise_df`` (lists of
    :class:`Segment`, in the same order as the DataFrames' rows), and
    ``info`` for ``info_df`` (a list of :class:`ChannelInfo`).
    """

    def __init__(self, transcript_dir: str):
        self.transcript_dir = str(transcript_dir)
        preambles = os.path.join(self.transcript_dir, "preambles.mrt")
        self.chan_to_part, self.part_to_chan = parse_preambles(preambles)
        self.laugh_only: List[Segment] = []
        self.speech: List[Segment] = []
        self.invalid: List[Segment] = []
        self.noise: List[Segment] = []
        self.info: List[ChannelInfo] = []
        groups = {
            SegmentType.LAUGH: self.laugh_only,
            SegmentType.SPEECH: self.speech,
            SegmentType.INVALID: self.invalid,
        }
        for filename in sorted(os.listdir(self.transcript_dir)):
            if not _is_meeting_file(filename):
                continue
            meeting_id = filename[:6]
            tree = parse_xml(os.path.join(self.transcript_dir, filename))
            length = meeting_length(tree)
            for chan_id, part_id in self.chan_to_part.get(meeting_id, {}).items():
                self.info.append(ChannelInfo(
                    meeting_id, part_id, chan_id, length,
                    os.path.join(meeting_id, f"{chan_id}.sph"),
                ))
            for seg in parse_meeting(tree, meeting_id, self.part_to_chan):
                groups.get(seg.type, self.noise).append(seg)

    @property
    def meeting_ids(self) -> List[str]:
        return sorted({c.meeting_id for c in self.info})


_STORE_CACHE: Dict[str, TranscriptStore] = {}


def count_laugh_segments(transcript_dir: str) -> Dict[str, Tuple[int, int]]:
    """Per-meeting (all_laugh_segments, laugh_only_segments) counts: the
    reference's xmllint sweeps (reference
    analysis/transcript_parsing/filter_all_laughs.sh / filter_laugh_only.sh).

    "All" counts ``Segment`` elements with a VocalSound child whose
    Description mentions 'laugh'.  "Laugh only" is the XPath
    ``VocalSound[...][preceding-sibling::text()[normalize-space()=''] and
    following-sibling::text()[normalize-space()='']] and count(./*) < 2``:
    the laugh is the only element child, and a whitespace-only text node
    EXISTS on each side of it.  A text node before the laugh is the
    segment's text or the tail of a comment/PI before it; after it, the
    laugh's tail or such a tail after it.  A missing text node is None and
    never matches, so a serialization with no text nodes is not counted, as
    xmllint reports on the same bytes."""
    out: Dict[str, Tuple[int, int]] = {}
    for path in sorted(Path(transcript_dir).glob("*.mrt")):
        # The store's membership rule, so the totals reconcile with it.
        if len(path.name) != len("Xxx000.mrt") or path.name == "preambles.mrt":
            continue
        n_all = n_only = 0
        for seg in parse_xml(path).getroot().iter("Segment"):
            elements = _elements(seg)
            if not any(_is_laugh(c) for c in elements):
                continue
            n_all += 1
            if len(elements) != 1:
                continue
            nodes = list(seg)
            at = nodes.index(elements[0])
            before = [seg.text] + [c.tail for c in nodes[:at]]
            after = [c.tail for c in nodes[at:]]
            blank = lambda texts: any(
                t is not None and t.strip(_XML_SPACE) == "" for t in texts
            )
            n_only += blank(before) and blank(after)
        out[path.stem] = (n_all, n_only)
    return out


def load(transcript_dir: Optional[str] = None) -> TranscriptStore:
    """Memoized TranscriptStore for ``transcript_dir`` (defaults to
    config.ANALYSIS.transcript_dir).

    Content-keyed like the index cache (indices._cache_key): the key is the
    symlink-resolved dir plus every .mrt's size and mtime, so a changed
    corpus is parsed again in a long-running process, and the superseded
    entry for the same dir is evicted rather than kept forever."""
    tdir = str(transcript_dir or _config.ANALYSIS.transcript_dir)
    prefix = f"{Path(tdir).resolve()}#"
    stat = "|".join(
        f"{p.name}:{p.stat().st_size}:{p.stat().st_mtime_ns}"
        for p in sorted(Path(tdir).glob("*.mrt"))
    )
    key = prefix + stat
    if key not in _STORE_CACHE:
        for old in [k for k in _STORE_CACHE if k.startswith(prefix)]:
            del _STORE_CACHE[old]
        _STORE_CACHE[key] = TranscriptStore(tdir)
    return _STORE_CACHE[key]
