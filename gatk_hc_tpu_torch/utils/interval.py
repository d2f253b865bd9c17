"""Genomic intervals: ``contig:[begin, end)`` half-open, 0-based.

Mirrors the semantics of hc::Interval (reference utils/interval.hpp), with the
same string parser (``chr``, ``chr:1,000-2,000``, ``chr:1000+``, ``chr:1000``).
"""

from __future__ import annotations

import dataclasses
import sys

_MAX = sys.maxsize


@dataclasses.dataclass(frozen=True, order=True)
class Interval:
    contig: str
    begin: int = 0
    end: int = 0

    def __post_init__(self) -> None:
        if self.end < self.begin:
            raise ValueError(f"invalid interval: {self.contig}:{self.begin}-{self.end}")

    @staticmethod
    def parse(text: str) -> "Interval":
        # interval.hpp:33-61
        colon = text.find(":")
        if colon < 0:
            return Interval(text, 0, _MAX)
        contig = text[:colon]
        remain = text[colon + 1 :].replace(",", "")
        begin = int(_leading_digits(remain))
        dash = remain.find("-")
        if dash < 0:
            end = _MAX if remain.endswith("+") else begin + 1
        else:
            end = int(remain[dash + 1 :])
        return Interval(contig, begin, end)

    @property
    def size(self) -> int:
        return self.end - self.begin

    def is_empty(self) -> bool:
        return self.size == 0

    def overlaps(self, other: "Interval") -> bool:
        return (
            self.contig == other.contig
            and self.begin < other.end
            and other.begin < self.end
        )

    def contains(self, other: "Interval") -> bool:
        return (
            self.contig == other.contig
            and self.begin <= other.begin
            and self.end >= other.end
        )

    def span_with(self, other: "Interval") -> "Interval":
        if self.contig != other.contig:
            raise ValueError("cannot span intervals on different contigs")
        return Interval(self.contig, min(self.begin, other.begin), max(self.end, other.end))

    def expand_within_contig(self, padding: int) -> "Interval":
        # interval.hpp:82-83 -- no clamping at 0 in the reference (size_t
        # wraps); callers never pass begin < padding on the emit path, and we
        # clamp defensively instead of wrapping.
        return Interval(self.contig, max(self.begin - padding, 0), self.end + padding)

    def to_string(self) -> str:
        return f"{self.contig}:{self.begin}-{self.end}"

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.to_string()


def _leading_digits(text: str) -> str:
    """std::stoul semantics: parse the leading integer, ignore the rest."""
    i = 0
    while i < len(text) and text[i].isdigit():
        i += 1
    if i == 0:
        raise ValueError(f"expected digits at start of {text!r}")
    return text[:i]
