"""Generate the chrM test fixture: synthetic reference + simulated reads.

The upstream repo documents a chrM.sam/chrM.fa workflow (README.md:12) but
bundles no data, so the fixture is synthesized deterministically:

* a random 16,569bp "chrM" contig (the real chrM length), fixed seed;
* a diploid donor: haplotype A = reference, haplotype B = reference with
  planted SNPs/insertions/deletions at known spacing;
* paired-end-style 151bp reads (``--read-length`` for longer runs: 250
  for 2x250 kits, 300 for MiSeq 2x300) sampled uniformly with sequencing
  errors, Phred-encoded qualities, and proper SAM fields
  (FLAG/RNEXT='='/TLEN).

Usage:  python -m gatk_hc_tpu_torch.tools.make_fixture [outdir] [--depth N]
        [--length L] [--contigs N] [--read-length R]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import random
import shutil

from ..io.fasta import FastaRecord, write_fasta

BASES = "ACGT"
CHRM_LEN = 16569
READ_LEN = 151


def make_reference(rng: random.Random, length: int, profile: str = "uniform") -> str:
    if profile == "uniform":
        return "".join(rng.choice(BASES) for _ in range(length))
    if profile == "homopolymer":
        # ~half the sequence inside 4-12bp single-base runs — the classic
        # PairHMM/assembly stress shape (polymerase slippage hotspots)
        parts = []
        n = 0
        while n < length:
            if rng.random() < 0.35:
                run = rng.randint(4, 12)
                parts.append(rng.choice(BASES) * run)
                n += run
            else:
                k = rng.randint(2, 6)
                parts.append("".join(rng.choice(BASES) for _ in range(k)))
                n += k
        return "".join(parts)[:length]
    raise ValueError(f"unknown reference profile {profile!r}")


def _run_length(ref: str, pos: int) -> int:
    """Length of the homopolymer run starting at ref[pos]."""
    j = pos
    while j < len(ref) and ref[j] == ref[pos]:
        j += 1
    return j - pos


def plant_variants(rng: random.Random, ref: str, profile: str = "uniform"):
    """Return (alt haplotype, list of (ref_pos, kind, payload)).

    Variants are spaced >= 300bp apart so most windows hold at most one
    event, with a few dense clusters for multi-allele coverage.

    profile="homopolymer": indel-heavy (ins/del ~4x snp) and each indel
    snaps to the start of a nearby homopolymer run when one exists, with
    slippage-shaped payloads (insertions duplicate the run base) — the
    hardest case for left-anchored event extraction (genotyper.hpp:35-111)
    and for assembly of low-complexity sequence.
    """
    homopoly = profile == "homopolymer"
    kinds = (
        ["ins", "del", "ins", "del", "snp"]
        if homopoly
        else ["snp", "snp", "snp", "ins", "del"]
    )
    variants = []
    pos = 500
    while pos < len(ref) - 500:
        kind = rng.choice(kinds)
        if homopoly and kind in ("ins", "del"):
            # snap to the first run of >= 4 within the next 200bp
            for probe in range(pos, min(pos + 200, len(ref) - 500)):
                if _run_length(ref, probe) >= 4:
                    pos = probe
                    break
        if kind == "snp":
            alt_base = rng.choice([b for b in BASES if b != ref[pos]])
            variants.append((pos, "snp", alt_base))
        elif kind == "ins":
            if homopoly and _run_length(ref, pos) >= 2:
                ins = ref[pos] * rng.randint(1, 3)  # slippage duplication
            else:
                ins = "".join(
                    rng.choice(BASES) for _ in range(rng.randint(1, 4))
                )
            variants.append((pos, "ins", ins))
        else:
            if homopoly:
                # contract the run by 1-2 (never past its end)
                span = min(rng.randint(1, 2), max(_run_length(ref, pos) - 1, 1))
            else:
                span = rng.randint(1, 4)
            variants.append((pos, "del", span))
        pos += rng.randint(300, 700)

    # build alt haplotype + alt->ref coordinate anchors (indels make alt
    # coordinates drift from ref coordinates — reads sampled from alt must
    # be PLACED at ref-projected positions or the drift accumulates to
    # hundreds of bp over megabase contigs and breaks local assembly)
    alt_parts = []
    anchors = [(0, 0)]  # (alt_offset, ref_offset) at each segment start
    cursor = 0
    alt_len = 0
    for pos, kind, payload in variants:
        alt_parts.append(ref[cursor:pos])
        alt_len += pos - cursor
        if kind == "snp":
            alt_parts.append(payload)
            alt_len += 1
            cursor = pos + 1
        elif kind == "ins":
            alt_parts.append(ref[pos] + payload)
            alt_len += 1 + len(payload)
            cursor = pos + 1
        else:
            alt_parts.append(ref[pos])  # anchor base kept, next `payload` deleted
            alt_len += 1
            cursor = pos + 1 + payload
        anchors.append((alt_len, cursor))
    alt_parts.append(ref[cursor:])
    return "".join(alt_parts), variants, anchors


def simulate_reads(
    rng: random.Random,
    contig: str,
    hap_a: str,
    hap_b: str,
    depth: int,
    error_rate: float = 0.001,
    anchors=None,
    read_len: int = READ_LEN,
):
    """Sample reads from both haplotypes; yields SAM lines sorted by POS.

    hap-B sample starts are projected to REF coordinates through the
    alt->ref anchors so indel drift never displaces a read by more than
    one local event (a naive alt-coordinate POS accumulates hundreds of bp
    of drift over megabase contigs, which breaks any windowed caller)."""
    import bisect

    reads = []
    genome_len = len(hap_a)
    n_reads = depth * genome_len // read_len
    alt_offsets = [a for a, _ in anchors] if anchors else None
    for i in range(n_reads):
        use_alt = rng.random() >= 0.5
        hap = hap_b if use_alt else hap_a
        start = rng.randint(0, len(hap) - read_len)
        bases = list(hap[start : start + read_len])
        quals = []
        for j in range(read_len):
            q = rng.randint(28, 40)
            quals.append(chr(q + 33))
            if rng.random() < error_rate:
                bases[j] = rng.choice([b for b in BASES if b != bases[j]])
                quals[j] = chr(rng.randint(5, 20) + 33)
        if use_alt and anchors:
            k = bisect.bisect_right(alt_offsets, start) - 1
            alt_off, ref_off = anchors[k]
            ref_start = ref_off + (start - alt_off)
        else:
            ref_start = start
        pos = min(max(ref_start, 0), genome_len - 1) + 1
        flag = 99 if rng.random() < 0.5 else 163
        mate_pos = min(pos + rng.randint(150, 350), genome_len)
        reads.append(
            (
                pos,
                f"sim{i:06d}\t{flag}\t{contig}\t{pos}\t60\t{read_len}M\t=\t"
                f"{mate_pos}\t{mate_pos - pos + read_len}\t"
                f"{''.join(bases)}\t{''.join(quals)}",
            )
        )
    reads.sort(key=lambda item: item[0])
    return [line for _, line in reads]


def _write_contig(job):
    """One contig of the fixture: its reference, planted variants and reads,
    the reads' SAM lines written to ``part`` -> (record, reads, variants).
    Each contig draws from its own ``random.Random(seed)``, so contigs made
    in separate processes give the same bytes as in one."""
    name, seed, length, depth, profile, read_len, part = job
    rng = random.Random(seed)
    ref = make_reference(rng, length, profile=profile)
    alt, variants, anchors = plant_variants(rng, ref, profile=profile)
    sam_lines = simulate_reads(rng, name, ref, alt, depth, anchors=anchors,
                               read_len=read_len)
    with open(part, "w") as handle:
        for line in sam_lines:
            handle.write(line + "\n")
    return FastaRecord(name, "synthetic fixture", ref), len(sam_lines), variants


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("outdir", nargs="?", default="fixtures")
    parser.add_argument("--depth", type=int, default=30)
    parser.add_argument("--length", type=int, default=CHRM_LEN)
    parser.add_argument("--seed", type=int, default=20260816)
    parser.add_argument("--name", default="chrM")
    parser.add_argument(
        "--profile",
        default="uniform",
        choices=("uniform", "homopolymer"),
        help="reference/variant profile: uniform random bases with"
        " snp-heavy variants (default), or homopolymer-rich sequence with"
        " slippage-shaped indel-heavy variants (PairHMM/assembly stress)",
    )
    parser.add_argument(
        "--contigs",
        type=int,
        default=1,
        help="generate N contigs of --length bp each (named <name>1..<name>N)"
        " into one FASTA/SAM — the whole-genome-shaped multi-contig workload"
        " for streaming/multihost benchmarks (BASELINE config 5)",
    )
    parser.add_argument(
        "--read-length",
        type=int,
        default=READ_LEN,
        help="bases per read (default %(default)s; 250 and 300 make the"
        " long-read inputs that pad past the largest read bucket)",
    )
    args = parser.parse_args(argv)

    names = (
        [args.name]
        if args.contigs == 1
        else [f"{args.name}{i + 1}" for i in range(args.contigs)]
    )
    os.makedirs(args.outdir, exist_ok=True)
    jobs = [
        (name, args.seed + i, args.length, args.depth, args.profile,
         args.read_length, os.path.join(args.outdir, f".{name}.part.sam"))
        for i, name in enumerate(names)
    ]
    try:
        workers = min(len(jobs), os.cpu_count() or 1)
        if workers > 1:
            # several contigs: one spawned process each, up to one per CPU
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(workers) as pool:
                per_contig = pool.map(_write_contig, jobs)
        else:
            per_contig = [_write_contig(job) for job in jobs]
        records = [record for record, _, _ in per_contig]
        write_fasta(os.path.join(args.outdir, f"{args.name}.fa"), records)
        with open(os.path.join(args.outdir, f"{args.name}.sam"), "w") as handle:
            handle.write(f"@HD\tVN:1.6\tSO:coordinate\n")
            for record in records:
                handle.write(f"@SQ\tSN:{record.name}\tLN:{len(record.seq)}\n")
            for job in jobs:
                with open(job[-1]) as part:
                    shutil.copyfileobj(part, handle, 1 << 24)
    finally:
        for job in jobs:
            if os.path.exists(job[-1]):
                os.remove(job[-1])
    n_reads = sum(n for _, n, _ in per_contig)
    n_variants = 0
    with open(os.path.join(args.outdir, f"{args.name}.truth.txt"), "w") as handle:
        for record, _, variants in per_contig:
            for pos, kind, payload in variants:
                # single-contig keeps the historical 3-column format
                prefix = f"{record.name}\t" if args.contigs > 1 else ""
                handle.write(f"{prefix}{pos}\t{kind}\t{payload}\n")
            n_variants += len(variants)
    print(
        f"wrote {args.name}.fa ({len(records)} contig(s) x {args.length}bp), "
        f"{args.name}.sam ({n_reads} reads), {n_variants} planted variants"
    )


if __name__ == "__main__":
    main()
