"""FASTA reader/writer mirroring hc::Fasta (reference fasta/fasta.hpp).

The reference pipeline reads exactly one record and uppercases it
(haplotypecaller.hpp:118-122); ``read_fasta`` returns the first record and
``read_all_fasta`` supports multi-contig files for the scale-out path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, TextIO


@dataclasses.dataclass
class FastaRecord:
    name: str
    comment: str
    seq: str


def _iter_fasta(handle: TextIO) -> Iterator[FastaRecord]:
    name = None
    comment = ""
    chunks: List[str] = []
    for line in handle:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if name is not None:
                yield FastaRecord(name, comment, "".join(chunks))
            header = line[1:]
            parts = header.split(None, 1)
            name = parts[0] if parts else ""
            comment = parts[1] if len(parts) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield FastaRecord(name, comment, "".join(chunks))


def read_all_fasta(path: str) -> List[FastaRecord]:
    with open(path) as handle:
        return list(_iter_fasta(handle))


def read_fasta(path: str, uppercase: bool = True) -> FastaRecord:
    """First record only, uppercased like haplotypecaller.hpp:122."""
    with open(path) as handle:
        for record in _iter_fasta(handle):
            if uppercase:
                record.seq = record.seq.upper()
            return record
    raise ValueError(f"no FASTA records in {path}")


def write_fasta(path: str, records: List[FastaRecord], width: int = 50) -> None:
    with open(path, "w") as handle:
        for record in records:
            sep = " " if record.comment else ""
            handle.write(f">{record.name}{sep}{record.comment}\n")
            for pos in range(0, len(record.seq), width):
                handle.write(record.seq[pos : pos + width] + "\n")
