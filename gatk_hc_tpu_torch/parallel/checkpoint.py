"""Region-manifest checkpoint/resume.

The reference streams VCF rows per window so a crash leaves a prefix-valid
file but no way to resume (SURVEY.md §5).  Here each completed region
appends one manifest record (region id, variant rows) to a JSONL file;
resuming skips completed regions and the final VCF is assembled from the
manifest in region order — idempotent and multi-host friendly (each host
owns its region block's manifest shard).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from ..models.haplotype import Variant
from ..utils.interval import Interval


class RegionManifest:
    def __init__(self, path: str):
        self.path = path
        self._done: Dict[int, List[dict]] = {}
        if os.path.exists(path):
            with open(path) as handle:
                for line in handle:
                    line = line.strip()
                    if not line:
                        continue
                    record = json.loads(line)
                    self._done[record["region"]] = record["variants"]

    def is_done(self, region_id: int) -> bool:
        return region_id in self._done

    def completed_regions(self) -> List[int]:
        return sorted(self._done)

    def record(self, region_id: int, variants: Sequence[Variant]) -> None:
        encoded = [
            {
                "contig": v.location.contig,
                "begin": v.location.begin,
                "end": v.location.end,
                "alleles": list(v.alleles),
                "gt": list(v.gt),
                "gq": v.gq,
            }
            for v in variants
        ]
        with open(self.path, "a") as handle:
            handle.write(json.dumps({"region": region_id, "variants": encoded}) + "\n")
        self._done[region_id] = encoded

    def variants_for(self, region_id: int) -> List[Variant]:
        return [
            Variant(
                location=Interval(e["contig"], e["begin"], e["end"]),
                alleles=tuple(e["alleles"]),
                gt=tuple(e["gt"]),
                gq=e["gq"],
            )
            for e in self._done.get(region_id, [])
        ]

    def write_vcf(self, out_path: str, header: str) -> None:
        with open(out_path, "w") as handle:
            handle.write(header)
            for region_id in sorted(self._done):
                for variant in self.variants_for(region_id):
                    handle.write(variant.to_vcf_row())
