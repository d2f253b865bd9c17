"""A seeded WGS shard: reference FASTA, coordinate-sorted SAM and the
planted truth, in the model of the port's ``tools/make_fixture.py``,
vectorised with numpy so that 2 Mb at 30x is made in seconds.

The model (every number from the configuration or the traffic mix):

* the reference is uniform random sequence, ``shard_bp`` long, one
  contig;
* a diploid donor: haplotype A is the reference, haplotype B carries a
  SNP, an insertion of 1-4 random bases or a deletion of 1-4 bases
  (``variant_kinds``: 3 : 1 : 1) at 500 bp in and then every
  ``variant_spacing`` bp (300-700, uniform), up to 500 bp from the end;
* ``coverage x shard_bp / read_length`` reads, each from haplotype A or B
  with equal odds at a uniform start, placed at the reference position
  its start projects to (through the indels before it), as make_fixture
  places them; qualities Phred ``qual_phred`` (28-40), and each base
  replaced by another with probability ``error_rate`` and given Phred
  ``error_phred`` (5-20); MAPQ 60, a full-length M CIGAR, flag 99 or
  163, the mate 150-350 bp on;
* the truth is make_fixture's: one ``pos\\tkind\\tpayload`` line a
  planted variant, 0-based.

Seeds draw the reference, the variants and the reads from streams of
their own (``numpy.random.default_rng([seed, k])``), so the same seed
gives the same bytes.  ``sensitivity`` is ``tools/check_truth.py``'s
measure.  Nothing here imports the port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from hcbench.gen import ACGT, SEED_MASK

KINDS = ("snp", "ins", "del")
FASTA_WIDTH = 50  # bases a line, as the port's io/fasta.py::write_fasta

Variant = Tuple[int, str, str]  # 0-based position, kind, payload


@dataclasses.dataclass
class Shard:
    fasta: str
    sam: str
    truth: List[Variant]
    contig: str
    length: int
    reads: int


def _rng(seed: int, stream: int):
    return np.random.default_rng([seed & SEED_MASK, stream])


def plant(rng, ref: np.ndarray, traffic: Dict):
    """-> (haplotype B, planted variants, anchors): ``anchors`` holds the
    (B offset, reference offset) where each stretch between variants
    starts, so that a B position maps back to the reference."""
    lo, hi = traffic["variant_spacing"]
    n = ref.size // lo + 2
    pos = 500 + np.concatenate([[0], np.cumsum(rng.integers(lo, hi + 1, n))])
    pos = pos[pos < ref.size - 500]
    weights = np.asarray(traffic["variant_kinds"], np.float64)
    kind = rng.choice(len(KINDS), pos.size, p=weights / weights.sum())
    shift = rng.integers(1, 4, pos.size)  # a SNP's base, ref + shift mod 4
    size = rng.integers(1, 5, pos.size)  # bases inserted or deleted
    inserted = ACGT[rng.integers(0, 4, int(size[kind == 1].sum()))]
    code = np.searchsorted(ACGT, ref)
    parts, variants = [], []
    a_off, r_off = [0], [0]
    cursor = at_ins = 0
    for p, k, s, n_bp in zip(pos.tolist(), kind.tolist(), shift.tolist(),
                             size.tolist()):
        parts.append(ref[cursor:p])
        if k == 0:
            alt = ACGT[(code[p] + s) % 4]
            parts.append(np.array([alt], np.uint8))
            variants.append((p, "snp", chr(alt)))
            cursor = p + 1
        elif k == 1:
            payload = inserted[at_ins:at_ins + n_bp]
            at_ins += n_bp
            parts.append(np.concatenate([ref[p:p + 1], payload]))
            variants.append((p, "ins", payload.tobytes().decode()))
            cursor = p + 1
        else:
            parts.append(ref[p:p + 1])
            variants.append((p, "del", str(n_bp)))
            cursor = p + 1 + n_bp
        a_off.append(a_off[-1] + int(parts[-2].size) + int(parts[-1].size))
        r_off.append(cursor)
    parts.append(ref[cursor:])
    anchors = (np.asarray(a_off, np.int64), np.asarray(r_off, np.int64))
    return np.concatenate(parts), variants, anchors


def simulate(rng, ref: np.ndarray, alt: np.ndarray, anchors, config: Dict,
             traffic: Dict):
    """-> (pos, flag, mate_pos, bases, quals, name_index), sorted by
    position: 1-based positions, (reads, read_length) u8 rows."""
    length = ref.size
    read_len = config["read_length"]
    n = config["coverage"] * length // read_len
    use_alt = rng.random(n) >= 0.5
    hap_len = np.where(use_alt, alt.size, length)
    start = (rng.random(n) * (hap_len - read_len + 1)).astype(np.int64)
    bases = np.empty((n, read_len), np.uint8)
    for hap, which in ((ref, ~use_alt), (alt, use_alt)):
        windows = np.lib.stride_tricks.sliding_window_view(hap, read_len)
        bases[which] = windows[start[which]]
    q_lo, q_hi = traffic["qual_phred"]
    quals = rng.integers(q_lo + 33, q_hi + 34, (n, read_len), dtype=np.uint8)
    flat_b, flat_q = bases.reshape(-1), quals.reshape(-1)
    hits = np.unique(rng.integers(0, flat_b.size,
                                  rng.binomial(flat_b.size,
                                               traffic["error_rate"])))
    code = np.searchsorted(ACGT, flat_b[hits])
    flat_b[hits] = ACGT[(code + rng.integers(1, 4, hits.size)) % 4]
    e_lo, e_hi = traffic["error_phred"]
    flat_q[hits] = rng.integers(e_lo + 33, e_hi + 34, hits.size,
                                dtype=np.uint8)
    a_off, r_off = anchors
    k = np.searchsorted(a_off, start, side="right") - 1
    ref_start = np.where(use_alt, r_off[k] + (start - a_off[k]), start)
    pos = np.clip(ref_start, 0, length - 1) + 1
    flag = np.where(rng.random(n) < 0.5, 99, 163)
    mate = np.minimum(pos + rng.integers(150, 351, n), length)
    order = np.argsort(pos, kind="stable")
    return (pos[order], flag[order], mate[order], bases[order],
            quals[order], order)


def write_sam(path: str, contig: str, length: int, reads) -> None:
    pos, flag, mate, bases, quals, names = reads
    read_len = bases.shape[1]
    tlen = mate - pos + read_len
    seq, qual = bases.tobytes(), quals.tobytes()
    head = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n"
    fixed = f"\t{contig}\t%d\t60\t{read_len}M\t=\t%d\t%d\t".encode()
    line = b"sim%06d\t%d" + fixed + b"%s\t%s\n"
    with open(path, "wb") as handle:
        handle.write(head.encode())
        handle.write(b"".join(
            line % (name, f, p, m, t, seq[i * read_len:(i + 1) * read_len],
                    qual[i * read_len:(i + 1) * read_len])
            for i, (name, f, p, m, t) in enumerate(zip(
                names.tolist(), flag.tolist(), pos.tolist(), mate.tolist(),
                tlen.tolist()))))


def make_shard(config: Dict, traffic: Dict, seed: int,
               directory: str) -> Shard:
    """The seed's shard as ``shard.fa``, ``shard.sam`` and
    ``shard.truth.txt`` in ``directory``."""
    contig, length = traffic["contig"], config["shard_bp"]
    ref = ACGT[_rng(seed, 0).integers(0, 4, length)]
    alt, variants, anchors = plant(_rng(seed, 1), ref, traffic)
    reads = simulate(_rng(seed, 2), ref, alt, anchors, config, traffic)
    shard = Shard(os.path.join(directory, "shard.fa"),
                  os.path.join(directory, "shard.sam"), variants, contig,
                  length, int(reads[0].size))
    with open(shard.fasta, "wb") as handle:
        handle.write(f">{contig} synthetic shard\n".encode())
        rows = ref[:length - length % FASTA_WIDTH].reshape(-1, FASTA_WIDTH)
        body = np.concatenate([rows, np.full((rows.shape[0], 1), 10,
                                             np.uint8)], axis=1).tobytes()
        tail = ref[rows.size:].tobytes()
        handle.write(body + (tail + b"\n" if tail else b""))
    write_sam(shard.sam, contig, length, reads)
    with open(os.path.join(directory, "shard.truth.txt"), "w") as handle:
        handle.writelines(f"{p}\t{k}\t{v}\n" for p, k, v in variants)
    return shard


def sensitivity(vcf_text: str, truth: List[Variant]) -> Dict:
    """``tools/check_truth.py``'s measure: a planted variant is called
    when a VCF record lies at 1-based POS pos-2 .. pos+5 of its 0-based
    position; overall, per kind, and the share of records within 5 bp of
    a planted variant; with the planted positions ``missed`` and the
    records' positions ``far`` from every planted variant."""
    rows = [int(line.split("\t", 2)[1]) for line in vcf_text.splitlines()
            if line and not line.startswith("#")]
    called = set(rows)
    by_kind: Dict[str, List[int]] = {}
    near = set()
    missed = []
    for p, kind, _ in truth:
        hit = any(q in called for q in range(p - 2, p + 6))
        total = by_kind.setdefault(kind, [0, 0])
        total[0] += 1
        total[1] += hit
        if not hit:
            missed.append(p)
        near.update(range(p - 5, p + 6))
    hits = sum(g for _, g in by_kind.values())
    return {
        "missed": missed,
        "far": [q for q in rows if q not in near],
        "truth": len(truth),
        "called_rows": len(rows),
        "sensitivity": hits / len(truth) if truth else None,
        "per_type": {k: g / t for k, (t, g) in sorted(by_kind.items())},
        "calls_within_5bp_of_truth": (
            sum(q in near for q in rows) / len(rows) if rows else None),
    }
