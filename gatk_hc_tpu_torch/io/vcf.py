"""VCF reading/compare helpers (tooling + tests).

The writer lives with the Variant model (models/haplotype.py) to keep the
byte-for-byte row format next to its semantics; this module reads VCFs back
for golden comparisons and concordance tooling.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class VCFRow:
    chrom: str
    pos: int  # 1-based, as printed
    id: str
    ref: str
    alts: Tuple[str, ...]
    qual: str
    filter: str
    info: str
    fmt: str
    sample: str

    @property
    def gt(self) -> Optional[Tuple[int, int]]:
        if not self.fmt.startswith("GT"):
            return None
        gt = self.sample.split(":")[0]
        sep = "/" if "/" in gt else "|"
        a, b = gt.split(sep)
        return int(a), int(b)

    @property
    def gq(self) -> Optional[int]:
        keys = self.fmt.split(":")
        values = self.sample.split(":")
        if "GQ" in keys:
            return int(values[keys.index("GQ")])
        return None


def read_vcf(path: str) -> Tuple[List[str], List[VCFRow]]:
    """Returns (header lines, rows)."""
    header: List[str] = []
    rows: List[VCFRow] = []
    with open(path) as handle:
        for line in handle:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#"):
                header.append(line)
                continue
            fields = line.split("\t")
            rows.append(
                VCFRow(
                    chrom=fields[0],
                    pos=int(fields[1]),
                    id=fields[2],
                    ref=fields[3],
                    alts=tuple(fields[4].split(",")),
                    qual=fields[5],
                    filter=fields[6],
                    info=fields[7],
                    fmt=fields[8] if len(fields) > 8 else "",
                    sample=fields[9] if len(fields) > 9 else "",
                )
            )
    return header, rows


def concordance(path_a: str, path_b: str) -> dict:
    """Site-level concordance summary between two VCFs."""
    _, rows_a = read_vcf(path_a)
    _, rows_b = read_vcf(path_b)
    key = lambda r: (r.chrom, r.pos, r.ref, r.alts)
    set_a = {key(r): r for r in rows_a}
    set_b = {key(r): r for r in rows_b}
    shared = set(set_a) & set(set_b)
    gt_match = sum(1 for k in shared if set_a[k].gt == set_b[k].gt)
    return {
        "a_only": len(set_a) - len(shared),
        "b_only": len(set_b) - len(shared),
        "shared": len(shared),
        "gt_concordant": gt_match,
    }
