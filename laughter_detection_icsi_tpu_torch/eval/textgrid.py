"""Praat TextGrid IO, dependency-free.

Owns the roles the reference delegates to the ``tgt`` (writing,
reference segment_laughter.py:150-161) and ``textgrids`` (reading,
reference analyse.py:38-45) libraries: write laughter instances as an
IntervalTier named 'laughter' with text 'laugh', and read such files back
into (xmin, xmax, text) interval lists.

Both the long ("ooTextFile" with ``item []`` blocks) and short formats are
parsed; writing uses the long format, with gap intervals filled with empty
text for Praat compatibility.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float, str]


# --------------------------------------------------------------------------- #
# Writing
# --------------------------------------------------------------------------- #


def _quote(s: str) -> str:
    """Praat escapes a double quote inside a string as two ('\"\" ')."""
    return s.replace('"', '""')


def _unquote(s: str) -> str:
    return s.replace('""', '"')


def _fill_gaps(
    intervals: Sequence[Tuple[float, float]], xmin: float, xmax: float, text: str
) -> List[Interval]:
    """Disjoint, monotone tier intervals: overlapping/contained inputs are
    merged into the running laugh interval (a Praat tier must be a
    partition — emitting overlaps would double-count time when read back
    into the evaluator)."""
    out: List[Interval] = []
    cursor = xmin
    for start, end in sorted(intervals):
        if end < start:
            raise ValueError(
                f"textgrid: interval end {end} < start {start}"
            )
        raw_start = start
        # Clamp to the tier: frame->seconds conversion can step a hair past
        # the channel length; unclamped, the tier would declare laugh time
        # past xmax (invalid TextGrid, trips the evaluator's FP-accounting
        # closure assert).
        start = min(max(start, cursor), xmax)
        end = min(end, xmax)
        if end <= cursor or end <= start:
            continue  # contained in an emitted interval, or clamped away
        if start > cursor:
            out.append((cursor, start, ""))
        if out and out[-1][2] == text and out[-1][1] == start and raw_start < cursor:
            # Genuinely OVERLAPPING inputs collapse into the running laugh
            # run.  Exactly-touching instances stay two adjacent intervals
            # (valid in a Praat partition tier) so distinct predicted events
            # keep their count through a write/read round-trip.
            out[-1] = (out[-1][0], end, text)
        else:
            out.append((start, end, text))
        cursor = end
    if cursor < xmax:
        out.append((cursor, xmax, ""))
    if not out:
        out.append((xmin, xmax, ""))
    return out


def write_textgrid(
    path: str,
    instances: Sequence[Tuple[float, float]],
    tier_name: str = "laughter",
    text: str = "laugh",
    xmin: float = 0.0,
    xmax: float = None,
) -> None:
    """Write laughter instances [(start_s, end_s), ...] as one IntervalTier
    (mirrors the output of reference segment_laughter.py:150-161)."""
    if xmax is None:
        xmax = max((e for _, e in instances), default=xmin)
    intervals = _fill_gaps(instances, xmin, xmax, text)
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {xmin}",
        f"xmax = {xmax}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        f'        name = "{_quote(tier_name)}"',
        f"        xmin = {xmin}",
        f"        xmax = {xmax}",
        f"        intervals: size = {len(intervals)}",
    ]
    for i, (a, b, t) in enumerate(intervals, 1):
        lines += [
            f"        intervals [{i}]:",
            f"            xmin = {a}",
            f"            xmax = {b}",
            f'            text = "{_quote(t)}"',
        ]
    Path(path).write_text("\n".join(lines) + "\n")


# --------------------------------------------------------------------------- #
# Reading
# --------------------------------------------------------------------------- #

_NUM = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


def read_textgrid(path: str) -> Dict[str, List[Interval]]:
    """Parse a TextGrid (long or short format) into
    {tier_name: [(xmin, xmax, text), ...]}."""
    raw = Path(path).read_bytes()
    # Praat saves UTF-16 (with BOM) by default for any non-ASCII content;
    # decoding that as UTF-8 interleaves NULs so 'ooTextFile' never matches
    # and a perfectly valid TextGrid is rejected.  The replaced third-party
    # 'textgrids' library sniffed encodings — match that capability.
    if raw[:2] in (b"\xff\xfe", b"\xfe\xff"):
        content = raw.decode("utf-16", errors="replace")
    else:
        content = raw.decode("utf-8-sig", errors="replace")
    if not content.strip():
        return {}
    if "ooTextFile" not in content.splitlines()[0]:
        raise ValueError(f"{path}: not a TextGrid file")
    # Dispatch on BODY shape: both formats share the two-line header
    # ('Object class = "TextGrid"'), so keying on 'class =' would route
    # every real short-format file to the long parser (which silently
    # returns {}).  Only the long format has 'item [...]' block markers.
    if re.search(r"^\s*item\s*\[", content, re.MULTILINE):
        return _read_long(content)
    return _read_short(content)


def _read_long(content: str) -> Dict[str, List[Interval]]:
    tiers: Dict[str, List[Interval]] = {}
    cur_tier = None
    cur_class = "IntervalTier"
    cur: Dict[str, object] = {}
    for raw in content.splitlines():
        line = raw.strip()
        m = re.match(r'class\s*=\s*"(.*)"', line)
        if m:
            cur_class = m.group(1)
            continue
        m = re.match(r'name\s*=\s*"(.*)"', line)
        if m:
            if cur_class == "IntervalTier":
                cur_tier = _unquote(m.group(1))
                tiers.setdefault(cur_tier, [])
            else:
                # TextTier (point tier) etc.: skip explicitly instead of
                # relying on its mark/number lines not matching below
                cur_tier = None
            continue
        m = re.match(r"xmin\s*=\s*(\S+)", line)
        if m:
            cur["xmin"] = float(m.group(1))
            continue
        m = re.match(r"xmax\s*=\s*(\S+)", line)
        if m:
            cur["xmax"] = float(m.group(1))
            continue
        m = re.match(r'text\s*=\s*"(.*)"', line)
        if m and cur_tier is not None:
            tiers[cur_tier].append(
                (
                    float(cur.get("xmin", 0.0)),
                    float(cur.get("xmax", 0.0)),
                    _unquote(m.group(1)),
                )
            )
    return tiers


def _read_short(content: str) -> Dict[str, List[Interval]]:
    lines = [ln.strip() for ln in content.splitlines() if ln.strip()]
    # short format: header(2), xmin, xmax, <exists>, ntiers, then per tier:
    # "IntervalTier", name, xmin, xmax, n, then triples
    i = 0

    def take() -> str:
        nonlocal i
        v = lines[i]
        i += 1
        return v

    def unq(v: str) -> str:
        if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
            return _unquote(v[1:-1])
        return v

    take()  # File type
    take()  # Object class
    take()  # xmin
    take()  # xmax
    take()  # <exists>
    ntiers = int(_NUM.search(take()).group())
    tiers: Dict[str, List[Interval]] = {}
    for _ in range(ntiers):
        klass = unq(take())
        name = unq(take())
        take()  # xmin
        take()  # xmax
        n = int(_NUM.search(take()).group())
        if klass == "IntervalTier":
            ivals = []
            for _ in range(n):
                a = float(take())
                b = float(take())
                t = unq(take())
                ivals.append((a, b, t))
            tiers[name] = ivals
        else:
            # TextTier (point tier): TWO lines per point (time, mark).
            # Consume them so the line cursor stays aligned for the tiers
            # that follow — _read_long skips these explicitly too; points
            # are not intervals, so the tier itself is dropped.
            for _ in range(2 * n):
                take()
    return tiers


def read_laughter_intervals(
    path: str, tier_name: str = "laughter", text: str = "laugh"
) -> List[Tuple[float, float]]:
    """The intervals the evaluator consumes (reference analyse.py:38-45:
    iterate grid['laughter'], keep text == 'laugh')."""
    tiers = read_textgrid(path)
    if tier_name not in tiers:
        return []
    return [(a, b) for a, b, t in tiers[tier_name] if t == text]
