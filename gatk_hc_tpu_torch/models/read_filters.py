"""Read filters (reference utils/read_filter.hpp) and the filter pipeline
order used by the caller (haplotypecaller.hpp:52-66)."""

from __future__ import annotations

from typing import List

from ..config import HCConfig
from ..io.sam import SAMRecord


def fails_mapping_quality(read: SAMRecord, cfg: HCConfig) -> bool:
    return read.mapq < cfg.min_mapping_quality


def fails_duplicate(read: SAMRecord) -> bool:
    return read.is_duplicate


def fails_secondary(read: SAMRecord) -> bool:
    return read.is_secondary


def fails_minimum_length(read: SAMRecord, cfg: HCConfig) -> bool:
    return len(read) < cfg.min_read_length_after_trimming


def fails_mate_contig(read: SAMRecord) -> bool:
    # MateOnSameContigReadFilter: RNEXT must be "=" (read_filter.hpp:34-38)
    return read.rnext != "="


def filter_reads(reads: List[SAMRecord], cfg: HCConfig) -> List[SAMRecord]:
    """The four pre-clip filter passes, in the caller's order."""
    return [
        read
        for read in reads
        if not fails_mapping_quality(read, cfg)
        and not fails_duplicate(read)
        and not fails_secondary(read)
        and not fails_mate_contig(read)
    ]
