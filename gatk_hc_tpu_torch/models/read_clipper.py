"""Read clipping (reference utils/read_clipper.hpp).

Replicated quirks (deliberate, required for output parity — SURVEY.md §3):

* ``revert_soft_clipped_bases`` is strand-dependent: on the reverse strand the
  trailing S is converted to M in the CIGAR while the *leading* S bases are
  trimmed; on the forward strand the leading S becomes M (and POS moves back)
  while the trailing S bases are trimmed.
* ``hard_clip_to_interval`` trims SEQ/QUAL but does NOT rewrite CIGAR or POS,
  so downstream ``alignment_end`` is computed from the stale CIGAR.
"""

from __future__ import annotations

from typing import List

from ..config import HCConfig
from ..io.sam import SAMRecord
from ..utils.interval import Interval
from .read_filters import fails_minimum_length


def hard_clip_soft_clipped_bases(read: SAMRecord) -> None:
    """read_clipper.hpp:11-30 (unused by the main pipeline, kept for parity)."""
    if not read.cigar:
        return
    front_length, front_op = read.cigar[0]
    if front_op == "S":
        read.seq = read.seq[front_length:]
        read.qual = read.qual[front_length:]
    back_length, back_op = read.cigar[-1]
    if back_op == "S":
        read.seq = read.seq[: len(read.seq) - back_length]
        read.qual = read.qual[: len(read.qual) - back_length]


def revert_soft_clipped_bases(read: SAMRecord) -> None:
    """read_clipper.hpp:32-66."""
    if not read.cigar:
        return
    cigar = list(read.cigar)
    if read.is_reverse_strand:
        front_length, front_op = cigar[0]
        if front_op == "S":
            read.seq = read.seq[front_length:]
            read.qual = read.qual[front_length:]
        back_length, back_op = cigar[-1]
        if back_op == "S":
            cigar[-1] = (back_length, "M")
    else:
        front_length, front_op = cigar[0]
        alignment_begin = read.alignment_begin
        if front_op == "S" and alignment_begin >= front_length:
            cigar[0] = (front_length, "M")
            read.pos = alignment_begin - front_length + 1
        back_length, back_op = cigar[-1]
        if back_op == "S":
            read.seq = read.seq[: len(read.seq) - back_length]
            read.qual = read.qual[: len(read.qual) - back_length]
    read.cigar = tuple(cigar)


def hard_clip_to_interval(read: SAMRecord, interval: Interval) -> None:
    """read_clipper.hpp:68-91: trim SEQ/QUAL to the window, CIGAR untouched."""
    assert read.rname == interval.contig
    alignment_begin = read.alignment_begin
    alignment_end = read.alignment_end
    if alignment_begin < interval.begin:
        clip_size = min(interval.begin - alignment_begin, len(read.seq))
        read.seq = read.seq[clip_size:]
        read.qual = read.qual[clip_size:]
    if alignment_end > interval.end:
        clip_size = alignment_end - interval.end
        read.seq = read.seq[: max(len(read.seq) - clip_size, 0)]
        read.qual = read.qual[: max(len(read.qual) - clip_size, 0)]


def hard_clip_reads(
    reads: List[SAMRecord], padded_region: Interval, cfg: HCConfig
) -> List[SAMRecord]:
    """The caller's clip pipeline (haplotypecaller.hpp:68-81): revert soft
    clips, clip to the padded window, drop reads shorter than 10."""
    for read in reads:
        revert_soft_clipped_bases(read)
    for read in reads:
        hard_clip_to_interval(read, padded_region)
    return [read for read in reads if not fails_minimum_length(read, cfg)]
