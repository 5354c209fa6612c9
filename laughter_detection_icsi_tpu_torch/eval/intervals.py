"""Integer interval-set algebra for ground-truth indices and evaluation.

Replaces the reference's use of the ``portion`` library (reference
analysis/preprocess.py:27-46, analysis/analyse.py:120-149) with exact
integer half-open intervals backed by sorted numpy arrays.

The reference stores segments as ``P.openclosed(start, end)`` at 1 ms frame
resolution, i.e. the integer frame set {start+1, ..., end}.  We represent the
same set as the half-open range ``[start, end)`` = {start, ..., end-1}: a
uniform shift by -1 that cancels in every length / union / intersection /
difference / overlap computation, while portion's O(duration) ``p_len``
iteration (reference analysis/utils.py:28-37) becomes O(1) per atom.

Portion semantics preserved:
- ``openclosed(a, b) | openclosed(b, c) == openclosed(a, c)`` (adjacent atoms
  merge) -> half-open touching ranges merge.
- ``openclosed(a, a)`` is empty -> ``[a, a)`` is empty.
- ``closed(a, b)`` (used for sampled candidate segments, reference
  create_data_df.py:49-50) = {a, ..., b}; under the -1 shift it maps to
  ``[a-1, b)`` so cross-type overlap checks stay exact.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Tuple

import numpy as np


class IntervalSet:
    """An immutable union of disjoint, non-touching half-open integer ranges.

    ``starts`` / ``ends`` are equal-length sorted int64 arrays with
    ``starts[i] < ends[i]`` and ``ends[i] < starts[i+1]``.
    """

    __slots__ = ("starts", "ends")

    def __init__(self, starts: np.ndarray, ends: np.ndarray, _canonical: bool = False):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        if not _canonical:
            starts, ends = _normalize(starts, ends)
        self.starts = starts
        self.ends = ends

    # ------------------------------------------------------------------ #
    # Constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def empty(cls) -> "IntervalSet":
        z = np.empty(0, dtype=np.int64)
        return cls(z, z, _canonical=True)

    @classmethod
    def halfopen(cls, start: int, end: int) -> "IntervalSet":
        if end <= start:
            return cls.empty()
        return cls(np.array([start]), np.array([end]), _canonical=True)

    @classmethod
    def openclosed(cls, start: int, end: int) -> "IntervalSet":
        """Portion ``P.openclosed(start, end)`` under the uniform -1 shift."""
        return cls.halfopen(start, end)

    @classmethod
    def closed(cls, start: int, end: int) -> "IntervalSet":
        """Portion ``P.closed(start, end)`` under the uniform -1 shift."""
        return cls.halfopen(start - 1, end)

    @classmethod
    def from_pairs(cls, pairs: Iterable[Tuple[int, int]]) -> "IntervalSet":
        pairs = list(pairs)
        if not pairs:
            return cls.empty()
        arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        return cls(arr[:, 0], arr[:, 1])

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #

    @property
    def is_empty(self) -> bool:
        return self.starts.size == 0

    def length(self) -> int:
        """Total number of integer frames covered (exact, O(atoms))."""
        return int(np.sum(self.ends - self.starts))

    def num_atoms(self) -> int:
        return int(self.starts.size)

    def pairs(self) -> Iterator[Tuple[int, int]]:
        for s, e in zip(self.starts.tolist(), self.ends.tolist()):
            yield (s, e)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, IntervalSet):
            return NotImplemented
        return np.array_equal(self.starts, other.starts) and np.array_equal(
            self.ends, other.ends
        )

    def __hash__(self) -> int:
        return hash((self.starts.tobytes(), self.ends.tobytes()))

    def __repr__(self) -> str:
        atoms = ", ".join(f"[{s},{e})" for s, e in list(self.pairs())[:4])
        more = "" if self.num_atoms() <= 4 else f", ...{self.num_atoms()} atoms"
        return f"IntervalSet({atoms}{more})"

    def __bool__(self) -> bool:
        return not self.is_empty

    # ------------------------------------------------------------------ #
    # Set algebra
    # ------------------------------------------------------------------ #

    def union(self, other: "IntervalSet") -> "IntervalSet":
        if self.is_empty:
            return other
        if other.is_empty:
            return self
        starts = np.concatenate([self.starts, other.starts])
        ends = np.concatenate([self.ends, other.ends])
        return IntervalSet(starts, ends)

    __or__ = union

    def intersection(self, other: "IntervalSet") -> "IntervalSet":
        if self.is_empty or other.is_empty:
            return IntervalSet.empty()
        # For every pair of atoms that could overlap, clip.  Vectorized
        # two-pointer: for each atom in self, find candidate range in other.
        out_s: List[int] = []
        out_e: List[int] = []
        i = j = 0
        a_s, a_e = self.starts, self.ends
        b_s, b_e = other.starts, other.ends
        na, nb = a_s.size, b_s.size
        while i < na and j < nb:
            lo = max(a_s[i], b_s[j])
            hi = min(a_e[i], b_e[j])
            if lo < hi:
                out_s.append(lo)
                out_e.append(hi)
            if a_e[i] <= b_e[j]:
                i += 1
            else:
                j += 1
        if not out_s:
            return IntervalSet.empty()
        return IntervalSet(
            np.asarray(out_s, dtype=np.int64),
            np.asarray(out_e, dtype=np.int64),
            _canonical=True,
        )

    __and__ = intersection

    def difference(self, other: "IntervalSet") -> "IntervalSet":
        if self.is_empty or other.is_empty:
            return self
        out_s: List[int] = []
        out_e: List[int] = []
        b_s, b_e = other.starts, other.ends
        nb = b_s.size
        j = 0
        for s, e in zip(self.starts.tolist(), self.ends.tolist()):
            cur = s
            # advance j past atoms ending before cur
            while j < nb and b_e[j] <= cur:
                j += 1
            k = j
            while k < nb and b_s[k] < e:
                if b_s[k] > cur:
                    out_s.append(cur)
                    out_e.append(int(b_s[k]))
                cur = max(cur, int(b_e[k]))
                if cur >= e:
                    break
                k += 1
            if cur < e:
                out_s.append(cur)
                out_e.append(e)
        if not out_s:
            return IntervalSet.empty()
        return IntervalSet(
            np.asarray(out_s, dtype=np.int64),
            np.asarray(out_e, dtype=np.int64),
            _canonical=True,
        )

    __sub__ = difference

    def overlaps(self, other: "IntervalSet") -> bool:
        if self.is_empty or other.is_empty:
            return False
        i = j = 0
        a_s, a_e = self.starts, self.ends
        b_s, b_e = other.starts, other.ends
        na, nb = a_s.size, b_s.size
        while i < na and j < nb:
            if max(a_s[i], b_s[j]) < min(a_e[i], b_e[j]):
                return True
            if a_e[i] <= b_e[j]:
                i += 1
            else:
                j += 1
        return False

    def contains(self, other: "IntervalSet") -> bool:
        """True iff ``other`` is a subset of ``self`` (portion ``.contains``)."""
        return (other - self).is_empty

    def overlap_length(self, other: "IntervalSet") -> int:
        """Number of frames shared with ``other`` (exact)."""
        return self.intersection(other).length()


def _normalize(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort, drop empties, merge overlapping/touching ranges."""
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    if starts.size == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    # Merge: running max of ends; a new atom begins where start > max(prev ends).
    run_max = np.maximum.accumulate(ends)
    new_atom = np.empty(starts.size, dtype=bool)
    new_atom[0] = True
    new_atom[1:] = starts[1:] > run_max[:-1]
    out_s = starts[new_atom]
    # Each merged atom ends at the running max over its member ranges.
    boundaries = np.flatnonzero(new_atom)
    out_e = np.maximum.reduceat(run_max, boundaries)
    return out_s, out_e


# ---------------------------------------------------------------------------- #
# second <-> frame conversion (reference analysis/utils.py:8-25)
# ---------------------------------------------------------------------------- #


def to_frames(time_in_sec: float, frame_duration_ms: int = 1) -> int:
    """Seconds -> integer frames; banker's rounding like the reference's
    ``round`` (reference analysis/utils.py:8-16)."""
    factor = 1000.0 / frame_duration_ms
    return round(time_in_sec * factor)


def to_sec(num_frames: int, frame_duration_ms: int = 1) -> float:
    factor = 1000.0 / frame_duration_ms
    return num_frames / factor
