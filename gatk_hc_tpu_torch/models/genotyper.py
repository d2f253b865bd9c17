"""Single-sample diploid exact genotyper.

Mirrors hc::Genetyper (reference genotyper/genotyper.hpp) including:

* event extraction by walking each haplotype's SW CIGAR against the padded
  window reference (SNPs from M-mismatches, left-anchored indels;
  genotyper.hpp:35-111);
* spanning-deletion '*' replacement (:141-156);
* compatible-allele resolution against the longest REF (:158-193), alleles
  ordered [ref] + sorted(alts) (std::set<string> lexicographic);
* haplotype->allele mapping with later allele indices overwriting earlier
  assignments for multi-event haplotypes (:195-232);
* marginalization over reads overlapping the longest event ±2: per-read max
  likelihood over the haplotypes of each allele (:234-274);
* diploid genotype likelihoods: hom = lik + log10(2) per read, het =
  approximate_log10_sum_log10(lik1, lik2); summed over reads minus
  n*log10(2) (:276-328);
* GQ = round(-10*(second_best-best)) capped at 99 (:330-362); emit unless
  hom-ref, unless 0/x het with GQ < 50, skip sites with > 7 alleles
  (:379-395).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..config import HCConfig
from ..io.sam import SAMRecord
from ..utils.interval import Interval
from ..utils.quality import (
    JACOBIAN_F64,
    JACOBIAN_LOG_TABLE_INV_STEP,
    MAX_JACOBIAN_TOLERANCE,
)
from .haplotype import Haplotype, Variant

SPAN_DEL = "*"
_LOG10_2 = math.log10(2.0)
_LOWEST = -float(np.finfo(np.float64).max)  # std::numeric_limits<double>::lowest


def process_cigar_for_initial_events(
    haplotype: Haplotype, ref: str, padded_region: Interval,
    ref_arr: Optional[np.ndarray] = None,
) -> None:
    """genotyper.hpp:35-111.  ``ref_arr`` (byte view of ``ref``) can be
    passed by per-region callers so the window reference is encoded once
    per region instead of once per haplotype."""
    contig = padded_region.contig
    padded_begin = padded_region.begin
    ref_pos = haplotype.alignment_begin_wrt_ref
    hap_pos = 0
    hap = haplotype.bases
    # byte views: the M-mismatch scan is a vectorized compare instead of a
    # per-base Python loop (same events, found left-to-right)
    if ref_arr is None:
        ref_arr = np.frombuffer(ref.encode("ascii"), dtype=np.uint8)
    hap_arr = getattr(haplotype, "bases_u8", None)
    if hap_arr is None:
        hap_arr = np.frombuffer(hap.encode("ascii"), dtype=np.uint8)
    for length, op in haplotype.cigar:
        if op == "M":
            mismatches = np.nonzero(
                ref_arr[ref_pos : ref_pos + length]
                != hap_arr[hap_pos : hap_pos + length]
            )[0]
            for offset in mismatches:
                offset = int(offset)
                begin = padded_begin + ref_pos + offset
                haplotype.event_map[begin] = Variant(
                    location=Interval(contig, begin, begin + 1),
                    ref=ref[ref_pos + offset],
                    alt=hap[hap_pos + offset],
                )
            ref_pos += length
            hap_pos += length
        elif op == "I":
            if ref_pos > 0:
                begin = padded_begin + ref_pos - 1
                anchor = ref[ref_pos - 1]
                haplotype.event_map[begin] = Variant(
                    location=Interval(contig, begin, begin + 1),
                    ref=anchor,
                    alt=anchor + hap[hap_pos : hap_pos + length],
                )
            hap_pos += length
        elif op == "D":
            if ref_pos > 0:
                begin = padded_begin + ref_pos - 1
                haplotype.event_map[begin] = Variant(
                    location=Interval(contig, begin, begin + length + 1),
                    ref=ref[ref_pos - 1 : ref_pos + length],
                    alt=ref[ref_pos - 1],
                )
            ref_pos += length
        elif op == "S":
            hap_pos += length
        else:
            raise ValueError(f"unsupported CIGAR op {op!r} from SW alignment")


def _set_events_for_haplotypes(
    haplotypes: List[Haplotype], ref: str, padded_region: Interval
) -> List[int]:
    event_begins: Set[int] = set()
    ref_arr = np.frombuffer(ref.encode("ascii"), dtype=np.uint8)
    for rank, h in enumerate(haplotypes):
        h.rank = rank
        h.event_map = {}
        process_cigar_for_initial_events(h, ref, padded_region, ref_arr)
        event_begins.update(h.event_map.keys())
    return sorted(event_begins)


def _get_events_from_haplotypes(
    begin: int, haplotypes: List[Haplotype]
) -> List[Variant]:
    unique: Dict[Tuple, Variant] = {}
    for h in haplotypes:
        for event in h.get_overlapping_events(begin):
            unique.setdefault(event.sort_key(), event)
    return [unique[key] for key in sorted(unique)]


def _replace_span_dels(
    events: List[Variant], ref_allele: str, begin: int, contig: str
) -> List[Variant]:
    return [
        event
        if event.location.begin == begin
        else Variant(
            location=Interval(contig, begin, begin + 1), ref=ref_allele, alt=SPAN_DEL
        )
        for event in events
    ]


def _get_compatible_alternate_allele(ref_allele: str, event: Variant) -> str:
    if event.alt == SPAN_DEL:
        return SPAN_DEL
    return event.alt + ref_allele[len(event.ref) :]


def _get_compatible_alleles(
    events: List[Variant],
) -> Tuple[List[str], Interval]:
    longest_event = events[0]
    # determine_reference_allele: first REF of maximal length (:158-162)
    best_len = max(len(e.ref) for e in events)
    ref_allele = next(e.ref for e in events if len(e.ref) == best_len)
    alts: Set[str] = set()
    for event in events:
        if event.size > longest_event.size:
            longest_event = event
        if event.ref == ref_allele:
            alts.add(event.alt)
        else:
            alts.add(_get_compatible_alternate_allele(ref_allele, event))
    alleles = [ref_allele] + sorted(alts)
    return alleles, longest_event.location


def _get_allele_mapper(
    alleles: List[str], begin: int, haplotypes: List[Haplotype]
) -> Dict[int, List[int]]:
    result: Dict[int, List[int]] = {0: []}
    ref_allele = alleles[0]

    def get_index(allele: str) -> int:
        return alleles.index(allele)

    for h in haplotypes:
        spanning = h.get_overlapping_events(begin)
        if not spanning:
            result[0].append(h.rank)
        for event in spanning:
            if event.location.begin == begin:
                if len(event.ref) == len(ref_allele):
                    result.setdefault(get_index(event.alt), []).append(h.rank)
                elif len(event.ref) < len(ref_allele):
                    idx = get_index(_get_compatible_alternate_allele(ref_allele, event))
                    result.setdefault(idx, []).append(h.rank)
            else:
                result.setdefault(get_index(SPAN_DEL), []).append(h.rank)
    return result


def _get_haplotype_mapper(
    allele_mapper: Dict[int, List[int]], haplotype_count: int
) -> List[int]:
    haplotype_mapper = [0] * haplotype_count
    for allele_index in sorted(allele_mapper):  # std::map iteration order
        for h in allele_mapper[allele_index]:
            haplotype_mapper[h] = allele_index
    return haplotype_mapper


def _marginalize(
    haplotype_mapper: List[int],
    allele_count: int,
    keep_mask: np.ndarray,  # (n_reads,) bool: read overlaps the event span
    likelihoods: np.ndarray,  # (n_reads, n_haps)
) -> np.ndarray:
    """Vectorized per-read max over each allele's haplotypes
    (genotyper.hpp:245-264).  Max is order-independent, so this matches the
    reference's sequential strict-> scan bit-for-bit."""
    lik = likelihoods[keep_mask]
    mapper = np.asarray(haplotype_mapper, dtype=np.int64)
    allele_lik = np.full((lik.shape[0], allele_count), _LOWEST)
    for a in range(allele_count):
        cols = mapper == a
        if cols.any():
            allele_lik[:, a] = lik[:, cols].max(axis=1)
    return allele_lik


_TRIU_CACHE: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def _triu_pairs(allele_count: int) -> Tuple[np.ndarray, np.ndarray]:
    """Genotype pair indices (a1<=a2), the allele_index_cache analogue."""
    cached = _TRIU_CACHE.get(allele_count)
    if cached is None:
        cached = _TRIU_CACHE[allele_count] = np.triu_indices(allele_count)
    return cached


def _calculate_genotype_likelihoods(
    allele_lik: np.ndarray, allele_count: int
) -> np.ndarray:
    """Vectorized diploid GL composition (genotyper.hpp:276-328).

    hom: lik[a] + log10(2) per read; het: approximate_log10_sum_log10 as a
    Jacobian-table gather.  Per-genotype read sums use cumsum, whose prefix
    outputs force the exact left-to-right addition order of the reference's
    scalar loop (np.sum's pairwise reassociation would drift the bits)."""
    n_reads = allele_lik.shape[0]
    a1_idx, a2_idx = _triu_pairs(allele_count)
    if n_reads == 0:
        return np.zeros(len(a1_idx))
    l1 = allele_lik[:, a1_idx]  # (n_reads, n_genotypes)
    l2 = allele_lik[:, a2_idx]
    big = np.maximum(l1, l2)
    small = np.minimum(l1, l2)
    with np.errstate(over="ignore"):
        diff = big - small
    in_range = diff < MAX_JACOBIAN_TOLERANCE
    ind = np.floor(
        np.where(in_range, diff, 0.0) * JACOBIAN_LOG_TABLE_INV_STEP + 0.5
    ).astype(np.int64)
    het = np.where(in_range, big + JACOBIAN_F64[ind], big)
    vals = np.where(a1_idx == a2_idx, l1 + _LOG10_2, het)
    # alleles with no supporting haplotype carry LOWEST; summing two of
    # them overflows to -inf exactly like the reference's double addition
    with np.errstate(over="ignore"):
        return np.cumsum(vals, axis=0)[-1] - n_reads * _LOG10_2


def _gq_and_max_index(genotypes: List[float], max_gq: int) -> Tuple[int, int]:
    """genotyper.hpp:330-362 (note >= lets later ties win the max slot)."""
    if genotypes[0] > genotypes[1]:
        second, best, best_index = genotypes[1], genotypes[0], 0
    else:
        second, best, best_index = genotypes[0], genotypes[1], 1
    for i in range(2, len(genotypes)):
        g = genotypes[i]
        if g >= best:
            second, best, best_index = best, g, i
        elif g > second:
            second = g
    # std::round = half away from zero (argument is non-negative here);
    # Python round() is banker's rounding, so use floor(x + 0.5).
    gq = int(math.floor(-10.0 * (second - best) + 0.5))
    return best_index, min(gq, max_gq)


def _genotype_alleles(allele_count: int, genotype_index: int) -> Tuple[int, int]:
    """allele_index_cache (genotyper.hpp:22-33): pairs (a1<=a2) in order."""
    index = 0
    for a1 in range(allele_count):
        for a2 in range(a1, allele_count):
            if index == genotype_index:
                return a1, a2
            index += 1
    raise IndexError(genotype_index)


def _site_specs(
    reads: Sequence[SAMRecord],
    haplotypes: List[Haplotype],
    ref: str,
    padded_region: Interval,
    origin_region: Interval,
    cfg: HCConfig,
):
    """The per-site host preparation shared by both genotyper engines:
    event extraction, allele resolution, haplotype->allele mapping and the
    read-overlap filter.  Yields (alleles, alleles_loc, haplotype_mapper,
    keep_mask) per emitted site in event order."""
    event_begins = _set_events_for_haplotypes(haplotypes, ref, padded_region)
    if not event_begins:
        return
    # read geometry, gathered once per region: the per-site overlap filter
    # (genotyper.hpp:266-274) becomes a vector compare.  Columnar
    # WindowReads already hold the spans as arrays; per-record inputs
    # gather them here.
    n = len(reads)
    if hasattr(reads, "abegin"):
        read_begins = reads.abegin
        read_ends = reads.aend
        contig_ok = np.full(n, reads.contig == padded_region.contig)
    else:
        read_begins = np.fromiter(
            (r.alignment_begin for r in reads), np.int64, n
        )
        read_ends = np.fromiter((r.alignment_end for r in reads), np.int64, n)
        contig_ok = np.fromiter(
            (r.rname == padded_region.contig for r in reads), bool, n
        )
    for begin in event_begins:
        if begin < origin_region.begin or begin >= origin_region.end:
            continue
        events = _get_events_from_haplotypes(begin, haplotypes)
        events = _replace_span_dels(
            events, ref[begin - padded_region.begin], begin, origin_region.contig
        )
        alleles, alleles_loc = _get_compatible_alleles(events)
        if len(alleles) > cfg.max_allele_count:
            continue
        allele_mapper = _get_allele_mapper(alleles, begin, haplotypes)
        haplotype_mapper = _get_haplotype_mapper(allele_mapper, len(haplotypes))
        overlap = alleles_loc.expand_within_contig(cfg.allele_extension)
        keep_mask = (
            contig_ok & (read_begins < overlap.end) & (read_ends > overlap.begin)
        )
        yield alleles, alleles_loc, haplotype_mapper, keep_mask


def _emit(alleles, alleles_loc, genotype_index_pair, gq, cfg, variants):
    """Shared emission filters (genotyper.hpp:386-395): hom-ref skip and
    low-GQ 0/x het skip."""
    gt = genotype_index_pair
    if gt == (0, 0):
        return
    if gt[0] == 0 and gq < cfg.min_heterozygosity_quality:
        return
    variants.append(
        Variant(location=alleles_loc, alleles=tuple(alleles), gt=gt, gq=gq)
    )


def assign_genotype_likelihoods(
    reads: Sequence[SAMRecord],
    haplotypes: List[Haplotype],
    likelihoods: np.ndarray,  # (n_reads, n_haps) float64
    ref: str,
    padded_region: Interval,
    origin_region: Interval,
    cfg: HCConfig,
    device="cuda",
) -> List[Variant]:
    """genotyper.hpp:369-398.  The "cuda" engine runs the reductions on
    ``device`` (genotype_regions_device)."""
    if cfg.genotyper_engine == "cuda":
        return _assign_genotype_likelihoods_device(
            reads, haplotypes, likelihoods, ref, padded_region,
            origin_region, cfg, device,
        )
    variants: List[Variant] = []
    for alleles, alleles_loc, haplotype_mapper, keep_mask in _site_specs(
        reads, haplotypes, ref, padded_region, origin_region, cfg
    ):
        allele_count = len(alleles)
        allele_lik = _marginalize(
            haplotype_mapper, allele_count, keep_mask, likelihoods
        )
        genotype_lik = _calculate_genotype_likelihoods(allele_lik, allele_count)
        genotype_index, gq = _gq_and_max_index(genotype_lik, cfg.max_genotype_quality)
        _emit(
            alleles, alleles_loc,
            _genotype_alleles(allele_count, genotype_index), gq, cfg, variants,
        )
    return variants


def _pad_up(value: int, buckets) -> int:
    for b in buckets:
        if value <= b:
            return b
    return value


_R_BUCKETS = (64, 128, 256, 512, 1024, 2048)
_H_BUCKETS = (16, 32, 64, 128)
_S_BUCKETS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _genotype_sites_numpy(lik, h2a, keep, hv, ac: int, max_gq: int):
    """Pure-NumPy f64 twin of ops/genotyper_cuda.py::genotype_sites_cuda
    for one allele-count bucket (``ac`` a Python int, so only the true genotype
    columns are computed).  Bit-exact with the per-site host reductions:
    max is order-independent, masked reads add 0.0 inside the same
    left-to-right cumsum, and the flipped-argmax best scan reproduces
    _gq_and_max_index's later-ties-win rule (genotyper.hpp:330-362).

    lik (S, R, H) f64; h2a (S, H) int; keep (S, R) bool; hv (S, H) bool.
    Returns (best_index (S,), gq (S,)) with best_index into the ac-allele
    (a1 <= a2) pair order."""
    allele_lik = np.empty(lik.shape[:2] + (ac,))
    for a in range(ac):
        sel = (h2a == a) & hv  # (S, H)
        allele_lik[:, :, a] = np.max(
            lik, axis=2, where=sel[:, None, :], initial=_LOWEST
        )
    a1, a2 = _triu_pairs(ac)
    l1 = allele_lik[:, :, a1]  # (S, R, G)
    l2 = allele_lik[:, :, a2]
    big = np.maximum(l1, l2)
    small = np.minimum(l1, l2)
    with np.errstate(over="ignore"):
        diff = big - small
    in_range = diff < MAX_JACOBIAN_TOLERANCE
    ind = np.floor(
        np.where(in_range, diff, 0.0) * JACOBIAN_LOG_TABLE_INV_STEP + 0.5
    ).astype(np.int64)
    het = np.where(in_range, big + JACOBIAN_F64[ind], big)
    vals = np.where(a1 == a2, l1 + _LOG10_2, het)
    vals = np.where(keep[:, :, None], vals, 0.0)
    n_reads = keep.sum(axis=1)
    with np.errstate(over="ignore", invalid="ignore"):
        totals = (
            np.cumsum(vals, axis=1)[:, -1, :]
            - n_reads[:, None] * _LOG10_2
        )
    G = totals.shape[1]
    best_index = G - 1 - np.argmax(totals[:, ::-1], axis=1)
    best = np.take_along_axis(totals, best_index[:, None], axis=1)[:, 0]
    rest = totals.copy()
    np.put_along_axis(rest, best_index[:, None], _LOWEST, axis=1)
    second = rest.max(axis=1)
    gq = np.minimum(
        np.floor(-10.0 * (second - best) + 0.5).astype(np.int64), max_gq
    )
    return best_index, gq


def _site_refs(region_inputs, cfg):
    """[(region idx, alleles, loc, hap -> allele map, kept reads)] of every
    emitted site of ``region_inputs``, in region then event order."""
    return [
        (ridx, alleles, loc, mapper, keep)
        for ridx, (reads, haps, _lik, ref, padded, origin)
        in enumerate(region_inputs)
        for alleles, loc, mapper, keep in _site_specs(
            reads, haps, ref, padded, origin, cfg)
    ]


def _site_tile(region_inputs, site_refs, site_ids, R: int, H: int, S: int):
    """Sites ``site_ids`` padded into one (S, R, H) tile: f64
    likelihoods, hap -> allele map, kept reads, valid haps and allele
    counts (padding sites: no reads, no haps, one allele)."""
    lik_t = np.zeros((S, R, H))
    h2a = np.zeros((S, H), np.int32)
    keep_t = np.zeros((S, R), bool)
    hv = np.zeros((S, H), bool)
    ac = np.ones(S, np.int32)
    for k, s_i in enumerate(site_ids):
        ridx, alleles, _loc, mapper, keep = site_refs[s_i]
        lik = region_inputs[ridx][2]
        nr, nh = lik.shape
        lik_t[k, :nr, :nh] = lik
        h2a[k, :nh] = mapper
        keep_t[k, :nr] = keep
        hv[k, :nh] = True
        ac[k] = len(alleles)
    return lik_t, h2a, keep_t, hv, ac


def genotype_regions_numpy(region_inputs, cfg) -> List[List[Variant]]:
    """Cross-region batched HOST genotyping: the production shape of the
    default ("host") engine.  Sites from a whole drained chunk are bucketed
    by (padded reads, padded haps, allele count) and each bucket is a
    handful of big vectorized f64 reductions — replacing per-site
    small-matrix NumPy calls whose fixed overhead dominated the genotype
    stage at WGS scale.  Bit-identical to the per-site path (which remains
    the oracle; tests/test_genotyper.py differential-tests the two)."""
    site_refs = _site_refs(region_inputs, cfg)
    variants: List[List[Variant]] = [[] for _ in region_inputs]
    if not site_refs:
        return variants
    buckets: Dict[Tuple[int, int, int], List[int]] = {}
    for s_i, (ridx, alleles, *_rest) in enumerate(site_refs):
        lik = region_inputs[ridx][2]
        R = _pad_up(lik.shape[0], _R_BUCKETS)
        H = _pad_up(lik.shape[1], _H_BUCKETS)
        buckets.setdefault((R, H, len(alleles)), []).append(s_i)
    out_gt: List = [None] * len(site_refs)
    out_gq: List = [None] * len(site_refs)
    for (R, H, ac), site_ids in buckets.items():
        lik_t, h2a, keep_t, hv, _ac = _site_tile(
            region_inputs, site_refs, site_ids, R, H, len(site_ids))
        best, gq = _genotype_sites_numpy(
            lik_t, h2a, keep_t, hv, ac, cfg.max_genotype_quality
        )
        a1, a2 = _triu_pairs(ac)
        for k, s_i in enumerate(site_ids):
            out_gt[s_i] = (int(a1[best[k]]), int(a2[best[k]]))
            out_gq[s_i] = int(gq[k])
    for s_i, (ridx, alleles, loc, _m, _k) in enumerate(site_refs):
        _emit(alleles, loc, out_gt[s_i], out_gq[s_i], cfg, variants[ridx])
    return variants


#: f32 unit roundoff (the kernel's type on the guarded f32 path)
_EPS32 = 2.0 ** -24
#: worst-case Jacobian-table index flip (f32 diff can round the table index
#: to a neighbour; adjacent log10(1+10^-x) entries differ by < 2.6e-5)
_JAC_SLOT_ERR = 3e-5


def _f32_total_bound(m: np.ndarray, n_reads: np.ndarray) -> np.ndarray:
    """Conservative absolute error bound |totals_f32 - totals_f64| per site.

    Per-read terms carry the f64->f32 input cast (<= m*eps), the het/hom
    compose roundings (<= 2*m*eps + table cast), and a possible Jacobian
    index flip (<= _JAC_SLOT_ERR); the Neumaier-compensated device sum
    contributes <= 2*eps*sum|v| <= 2*eps*n*m, and the final n*log10(2)
    subtract two more roundings.  Folded: n * (7*m*eps + slot_err).

    m: per-site max |value| (max |lik| + 0.4 covers the log10(2)/Jacobian
    adds); n_reads: kept reads per site."""
    return n_reads * (7.0 * m * _EPS32 + _JAC_SLOT_ERR) + 1e-7


def genotype_regions_device(
    region_inputs, cfg, device="cuda", use_f64=True, counters=None
) -> List[List[Variant]]:
    """Cross-region batched device genotyping (the "cuda" engine): sites
    from MANY regions are bucketed into a handful of padded (S, R, H)
    tiles and each bucket is ONE genotype kernel launch
    (ops/genotyper_cuda.py) on ``device`` ("cuda": the card; "cpu": the
    kernel's plain PyTorch version).

    ``region_inputs``: [(reads, haplotypes, likelihoods, window_ref,
    padded_region, origin_region)] per region.  Returns each region's
    variants in region order.

    On a card the tiles go through pinned host memory on the genotyper's
    own CUDA stream: phase 1 copies and launches every bucket without a
    wait, phase 2 brings every bucket's best + GQ home in ONE readback (and,
    on the f32 path, every genotype likelihood tile in one more), so it
    neither waits behind nor touches the PairHMM runner's stream.

    EXACTNESS: ``use_f64`` (the default on every device: the H100 has
    native f64) runs the float64 kernel, bit-identical to the host engine.
    With ``use_f64=False`` the float32 kernel's result is accepted ONLY
    where it is provably stable: the top-2 genotype gap must exceed twice
    the f32 error bound (GT/argmax stability, including the
    later-ties-win rule) and -10*(second-best)+0.5 must sit farther than
    the scaled bound from its floor boundary (GQ rounding stability, with
    the >=max_gq cap handled in the deep-capped branch).  Sites failing
    either check, counted in counters.gq_host_verified, recompute on the
    exact host f64 path, so neither type can emit a GT/GQ that differs from
    the host engine."""
    import contextlib

    import torch

    from ..ops.genotyper_cuda import genotype_pair_tables, genotype_sites_device

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "genotype_regions_device: no CUDA device is available "
            "(pass device='cpu' to run the kernel's plain version)"
        )
    site_refs = _site_refs(region_inputs, cfg)
    variants: List[List[Variant]] = [[] for _ in region_inputs]
    if not site_refs:
        return variants
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    dtype = np.float64 if use_f64 else np.float32
    max_gq = cfg.max_genotype_quality
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for s_i, (ridx, *_rest) in enumerate(site_refs):
        lik = region_inputs[ridx][2]
        R = _pad_up(lik.shape[0], _R_BUCKETS)
        H = _pad_up(lik.shape[1], _H_BUCKETS)
        buckets.setdefault((R, H), []).append(s_i)
    out_gt: List = [None] * len(site_refs)
    out_gq: List = [None] * len(site_refs)
    unstable_ids: List[int] = []
    a1_tab, a2_tab = genotype_pair_tables()
    pending = []  # (site_ids, lik_t, keep_t, gl_dev, best_dev, gq_dev)
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        # Phase 1: copy and launch EVERY bucket before reading anything
        for (R, H), site_ids in buckets.items():
            # f64 originals: the guard and the recompute read them
            lik_t, h2a, keep_t, hv, ac = _site_tile(
                region_inputs, site_refs, site_ids, R, H,
                _pad_up(len(site_ids), _S_BUCKETS))
            gl, best, gq = genotype_sites_device(
                lik_t.astype(dtype), h2a, keep_t, hv, ac, device,
                max_gq=max_gq,
            )
            pending.append((site_ids, lik_t, keep_t, gl, best, gq))
        # Phase 2: every bucket's best + GQ in one readback; the f32
        # guard's likelihood tiles (36 wide everywhere) in one more
        sizes = [int(p[4].shape[0]) for p in pending]
        ints = torch.cat(
            [p[4] for p in pending] + [p[5] for p in pending]).cpu().numpy()
        gl_all = None if use_f64 else torch.cat(
            [p[3] for p in pending]).cpu().numpy()
    off = np.cumsum([0] + sizes)
    total = int(off[-1])
    for i, (site_ids, lik_t, keep_t, _gl, _b, _g) in enumerate(pending):
        best = ints[off[i]:off[i + 1]]
        gq = ints[total + off[i]:total + off[i + 1]]
        n = len(site_ids)
        if use_f64:
            stable = np.ones(n, bool)
        else:
            gl = gl_all[off[i]:off[i + 1]].astype(np.float64)[:n]
            m = np.abs(lik_t[:n]).max(axis=(1, 2)) + 0.4
            bound = _f32_total_bound(m, keep_t[:n].sum(axis=1))
            best_val = np.take_along_axis(gl, best[:n, None], axis=1)[:, 0]
            rest = gl.copy()
            np.put_along_axis(rest, best[:n, None], -np.inf, axis=1)
            second_val = rest.max(axis=1)
            gap = best_val - second_val
            gt_stable = gap > 2.0 * bound
            # GQ rounding: floor(q + 0.5) flips only if q + 0.5 is within
            # 10*(2*bound) of an integer; deep-capped sites (q + 0.5 past
            # max_gq + 1 by the same margin) emit max_gq regardless
            q = -10.0 * (second_val - best_val)
            frac = (q + 0.5) % 1.0
            margin = 20.0 * bound
            gq_stable = np.minimum(frac, 1.0 - frac) > margin
            deep_capped = (q + 0.5) - (max_gq + 1) > margin
            stable = gt_stable & (gq_stable | deep_capped)
        for k, s_i in enumerate(site_ids):
            if stable[k]:
                out_gt[s_i] = (int(a1_tab[best[k]]), int(a2_tab[best[k]]))
                out_gq[s_i] = int(gq[k])
            else:
                unstable_ids.append(s_i)
    if unstable_ids:
        if counters is not None:
            counters.gq_host_verified += len(unstable_ids)
        _host_recompute_sites(
            region_inputs, site_refs, unstable_ids, out_gt, out_gq, cfg
        )
    for s_i, (ridx, alleles, loc, _m, _k) in enumerate(site_refs):
        _emit(alleles, loc, out_gt[s_i], out_gq[s_i], cfg, variants[ridx])
    return variants


def _host_recompute_sites(
    region_inputs, site_refs, site_ids, out_gt, out_gq, cfg
) -> None:
    """Exact host f64 recompute for guard-flagged sites, grouped by
    (padded R, padded H, allele count) through _genotype_sites_numpy."""
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for s_i in site_ids:
        ridx = site_refs[s_i][0]
        lik = region_inputs[ridx][2]
        R = _pad_up(lik.shape[0], _R_BUCKETS)
        H = _pad_up(lik.shape[1], _H_BUCKETS)
        groups.setdefault((R, H, len(site_refs[s_i][1])), []).append(s_i)
    for (R, H, ac), ids in groups.items():
        lik_t, h2a, keep_t, hv, _ac = _site_tile(
            region_inputs, site_refs, ids, R, H, len(ids))
        best, gq = _genotype_sites_numpy(
            lik_t, h2a, keep_t, hv, ac, cfg.max_genotype_quality
        )
        a1, a2 = _triu_pairs(ac)
        for k, s_i in enumerate(ids):
            out_gt[s_i] = (int(a1[best[k]]), int(a2[best[k]]))
            out_gq[s_i] = int(gq[k])


def _assign_genotype_likelihoods_device(
    reads, haplotypes, likelihoods, ref, padded_region, origin_region, cfg,
    device="cuda",
) -> List[Variant]:
    """Device-engine genotyper for ONE region: the same host-side site
    prep, reductions in ops/genotyper_cuda.py.  The batched production
    path (caller.py genotype_entries) calls genotype_regions_device
    directly, one launch per bucket of a whole drained chunk."""
    return genotype_regions_device(
        [(reads, haplotypes, likelihoods, ref, padded_region, origin_region)],
        cfg, device=device,
    )[0]
