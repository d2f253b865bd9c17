"""Haplotype and Variant data models.

Mirror hc::Haplotype (haplotype/haplotype.hpp) and hc::Variant
(variant/variant.hpp) including the event-map overlap query and the VCF row
emitter (byte-for-byte identical formatting).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..utils.cigar import Cigar
from ..utils.interval import Interval


@dataclasses.dataclass
class Variant:
    location: Interval
    ref: str = ""
    alt: str = ""
    alleles: Tuple[str, ...] = ()
    gt: Tuple[int, int] = (0, 0)
    gq: int = 0

    # Ordering by (location, REF, ALT) — variant.hpp:25-29.
    def sort_key(self) -> Tuple:
        return (self.location, self.ref, self.alt)

    @property
    def size(self) -> int:
        return self.location.size

    def to_vcf_row(self) -> str:
        """variant.hpp:31-44, byte-for-byte (1-based POS, '.' fillers)."""
        alts = ",".join(self.alleles[1:])
        return (
            f"{self.location.contig}\t{self.location.begin + 1}\t.\t"
            f"{self.alleles[0]}\t{alts}\t.\t.\t.\tGT:GQ\t"
            f"{self.gt[0]}/{self.gt[1]}:{self.gq}\n"
        )


@dataclasses.dataclass
class Haplotype:
    bases: str
    score: float = float("-inf")
    cigar: Cigar = ()
    alignment_begin_wrt_ref: int = 0
    rank: int = 0
    # event start (absolute contig coordinate) -> Variant; at most one per
    # start, like std::map<std::size_t, Variant> (haplotype.hpp:18)
    event_map: Dict[int, Variant] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.bases)

    def get_overlapping_events(self, begin: int) -> List[Variant]:
        """haplotype.hpp:31-39: events with key <= begin and end > begin,
        in key order."""
        return [
            event
            for key in sorted(self.event_map)
            if key <= begin
            for event in (self.event_map[key],)
            if event.location.end > begin
        ]
