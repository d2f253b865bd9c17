"""Compare a called VCF against a make_fixture truth file.

Prints one JSON line: sensitivity overall and per variant type, plus the
fraction of calls within +-5 bp of a planted variant (near-truth
precision).  Works with both truth formats: the historical 3-column
``pos\\tkind\\tpayload`` (single contig) and the 4-column
``contig\\tpos\\tkind\\tpayload`` written by multi-contig fixtures.

Usage: python -m gatk_hc_tpu_torch.tools.check_truth CALLED.vcf TRUTH.txt
"""

from __future__ import annotations

import json
import sys

from ..io.vcf import read_vcf


def load_truth(path: str):
    """[(contig | None, pos, kind)] — contig None for the 3-column format."""
    entries = []
    with open(path) as handle:
        for line in handle:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 3:
                entries.append((None, int(parts[0]), parts[1]))
            elif len(parts) == 4:
                entries.append((parts[0], int(parts[1]), parts[2]))
    return entries


def check(called_vcf: str, truth_path: str) -> dict:
    """Sensitivity (overall and per kind) and near-truth precision of
    ``called_vcf`` against the planted variants in ``truth_path``."""
    truth = load_truth(truth_path)
    _, rows = read_vcf(called_vcf)
    called = {(r.chrom, r.pos) for r in rows}
    called_any_contig = {pos for _, pos in called}

    def hit(contig, pos):
        # a planted event is "called" if any VCF row lands within the
        # GATK-style anchor slack: [pos-2, pos+5] (indel left-anchoring
        # shifts the reported POS by up to a few bases)
        for p in range(pos - 2, pos + 6):
            if contig is None:
                if p in called_any_contig:
                    return True
            elif (contig, p) in called:
                return True
        return False

    by_kind = {}
    hits = 0
    near_truth = set()
    for contig, pos, kind in truth:
        ok = hit(contig, pos)
        hits += ok
        total, good = by_kind.get(kind, (0, 0))
        by_kind[kind] = (total + 1, good + ok)
        for p in range(pos - 5, pos + 6):
            near_truth.add((contig, p) if contig is not None else p)

    multi = truth and truth[0][0] is not None
    far = 0
    for r in rows:
        key = (r.chrom, r.pos) if multi else r.pos
        if key not in near_truth:
            far += 1

    return {
        "truth": len(truth),
        "called_rows": len(rows),
        "sensitivity": round(hits / len(truth), 4) if truth else None,
        "per_type": {
            k: round(g / t, 4) for k, (t, g) in sorted(by_kind.items())
        },
        "calls_within_5bp_of_truth": (
            round(1.0 - far / len(rows), 4) if rows else None
        ),
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    called_vcf, truth_path = argv[0], argv[1]
    print(json.dumps(check(called_vcf, truth_path)))


if __name__ == "__main__":
    main()
