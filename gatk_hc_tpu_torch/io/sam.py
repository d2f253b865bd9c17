"""SAM record model + line parser.

Mirrors hc::SAMRecord (reference sam/sam.hpp): 11 mandatory whitespace-split
columns, optional tags ignored, no BAM support.  Coordinates are converted to
0-based half-open on access, exactly like ``get_alignment_begin``/``_end``
(sam.hpp:69-72).  GOP/GCP are the constant strings 'I'*len / '+'*len
(sam.hpp:30-32) — the PairHMM consumes those constants directly.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional

from ..utils.cigar import Cigar, cigar_to_string, parse_cigar, reference_length
from ..utils.interval import Interval

FLAG_READ_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_READ_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_READ_REVERSE_STRAND = 0x10
FLAG_MATE_REVERSE_STRAND = 0x20
FLAG_FIRST_OF_PAIR = 0x40
FLAG_SECOND_OF_PAIR = 0x80
FLAG_SECONDARY_ALIGNMENT = 0x100
FLAG_VENDOR_QUALITY_CHECK = 0x200
FLAG_DUPLICATE_READ = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclasses.dataclass
class SAMRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # 1-based, as in the SAM text
    mapq: int
    cigar: Cigar
    rnext: str
    pnext: int
    tlen: int
    seq: str
    qual: str

    # --- flag predicates (sam.hpp:34-45) ---
    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FLAG_READ_PAIRED)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_READ_UNMAPPED)

    @property
    def mate_unmapped(self) -> bool:
        return bool(self.flag & FLAG_MATE_UNMAPPED)

    @property
    def is_reverse_strand(self) -> bool:
        return bool(self.flag & FLAG_READ_REVERSE_STRAND)

    @property
    def mate_reverse_strand(self) -> bool:
        return bool(self.flag & FLAG_MATE_REVERSE_STRAND)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY_ALIGNMENT)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FLAG_DUPLICATE_READ)

    # --- geometry (sam.hpp:67-81) ---
    def __len__(self) -> int:
        return len(self.seq)

    @property
    def alignment_begin(self) -> int:
        return self.pos - 1

    @property
    def alignment_end(self) -> int:
        # NOTE: uses the CURRENT cigar; the clipper intentionally leaves the
        # cigar stale after hard_clip_to_interval, matching the reference
        # (read_clipper.hpp:68-91 trims SEQ/QUAL only).
        return self.alignment_begin + reference_length(self.cigar)

    @property
    def interval(self) -> Interval:
        return Interval(self.rname, self.alignment_begin, self.alignment_end)

    def to_line(self) -> str:
        return "\t".join(
            (
                self.qname,
                str(self.flag),
                self.rname,
                str(self.pos),
                str(self.mapq),
                cigar_to_string(self.cigar) or "*",
                self.rnext,
                str(self.pnext),
                str(self.tlen),
                self.seq,
                self.qual,
            )
        )


def parse_sam_line(line: str) -> SAMRecord:
    fields = line.split()
    if len(fields) < 11:
        raise ValueError(f"SAM line with {len(fields)} fields: {line[:80]!r}")
    return SAMRecord(
        qname=fields[0],
        flag=int(fields[1]),
        rname=fields[2],
        pos=int(fields[3]),
        mapq=int(fields[4]),
        cigar=parse_cigar(fields[5]),
        rnext=fields[6],
        pnext=int(fields[7]),
        tlen=int(fields[8]),
        seq=fields[9],
        qual=fields[10],
    )


def read_sam(path: str) -> Iterator[SAMRecord]:
    """Stream records from a SAM file, skipping the @ header block."""
    with open(path) as handle:
        for line in handle:
            if not line or line[0] == "@":
                continue
            line = line.rstrip("\n")
            if line:
                yield parse_sam_line(line)


def load_reads_by_start(
    records: Iterable[SAMRecord], ref_size: int
) -> List[List[SAMRecord]]:
    """Bucket reads by 0-based alignment start (haplotypecaller.hpp:24-42).

    Reads whose start lies outside [0, ref_size) are dropped (the reference
    would index out of bounds; we clamp deliberately — SURVEY.md §3 quirks).
    """
    buckets: List[List[SAMRecord]] = [[] for _ in range(ref_size)]
    for record in records:
        start = record.alignment_begin
        if 0 <= start < ref_size:
            buckets[start].append(record)
    return buckets


def load_reads_by_contig(
    records: Iterable[SAMRecord], contig_sizes: "dict[str, int]"
) -> "dict[str, List[List[SAMRecord]]]":
    """Per-contig positional buckets (multi-contig generalization; the
    reference handles exactly one contig)."""
    buckets = {
        name: [[] for _ in range(size)] for name, size in contig_sizes.items()
    }
    for record in records:
        contig = buckets.get(record.rname)
        if contig is None:
            continue
        start = record.alignment_begin
        if 0 <= start < len(contig):
            contig[start].append(record)
    return buckets
