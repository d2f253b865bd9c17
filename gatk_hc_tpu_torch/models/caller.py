"""Pipeline: the region walker that stitches the full caller together.

Mirrors hc::HaplotypeCaller::do_work / call_region
(haplotypecaller.hpp:83-154): fixed-size windows with padding (the first
window is only end-padded), positional downsampling, filter -> clip ->
assemble -> PairHMM -> genotype -> VCF rows.

Deliberate fixes over the reference (documented, SURVEY.md §3):
* windows and read-bucket indexing are clamped to the contig instead of
  reading out of bounds;
* downsampling is deterministic (HCConfig.downsample_mode).

The PairHMM engine is pluggable so the same pipeline runs the CUDA kernel
engine, the anti-diagonal PyTorch-ops engine, the C++ native engine, or the
Python oracle; the genotyper runs on the host or through the CUDA genotype
kernel.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_CONFIG, HCConfig
from ..io.fasta import read_all_fasta, read_fasta
from ..io.sam import SAMRecord, load_reads_by_contig, load_reads_by_start, read_sam
from ..utils.interval import Interval
from ..utils.logging import NULL_LOGGER, HCLogger, RunCounters, StageTimers, span
from .assembler import PathExplosionError
from .downsampler import downsample_window
from .genotyper import assign_genotype_likelihoods
from .haplotype import Haplotype, Variant
from .read_clipper import hard_clip_reads
from .read_filters import filter_reads

# Regions assembled before each incremental device submission in
# call_batched: large enough to fill dispatch groups, small enough that the
# GPU overlaps with host assembly of the next chunk.
SUBMIT_CHUNK_REGIONS = 512
# Submitted-but-undrained chunks kept in flight during the walk.  Beyond
# this, the oldest chunk is drained + genotyped + freed mid-walk: bounds
# job-array memory to O(MAX_INFLIGHT_BATCHES x SUBMIT_CHUNK_REGIONS)
# regions and overlaps genotyping with assembly.
MAX_INFLIGHT_BATCHES = 4

# Engine signature: (reads, haplotypes) -> (n_reads x n_haps log10 matrix).
PairHMMEngine = Callable[[Sequence[SAMRecord], Sequence[Haplotype]], np.ndarray]
AssembleFn = Callable[[Sequence[SAMRecord], str, HCConfig], List[Haplotype]]


@dataclasses.dataclass
class RegionResult:
    origin: Interval
    padded: Interval
    n_reads: int
    n_haplotypes: int
    variants: List[Variant]
    # raw PairHMM work volume for the benchmark counters
    cell_updates: int = 0
    region_id: int = -1


def vcf_header(contigs: Sequence[Tuple[str, int]], cfg: HCConfig) -> str:
    """haplotypecaller.hpp:132-135.  ``contigs`` is [(name, length), ...] in
    FASTA order.  The single-contig header is byte-for-byte the reference's
    (it emits no ##contig line — the chrM golden depends on this); when rows
    can span multiple contigs the header declares every contig so the file
    stays VCF-spec compliant."""
    contig_lines = (
        "".join(
            f"##contig=<ID={name},length={length}>\n" for name, length in contigs
        )
        if len(contigs) > 1
        else ""
    )
    return (
        "##fileformat=VCFv4.2\n"
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        + contig_lines
        + f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{cfg.sample_name}\n"
    )


def iter_windows(
    contig: str, ref_size: int, cfg: HCConfig
) -> Iterable[Tuple[Interval, Interval]]:
    """(origin, padded) window pairs (haplotypecaller.hpp:125-151).

    First window: [0, region+padding).  Later: [begin-padding, end+padding).
    The padded interval is clamped to the contig for safety; the origin
    interval is NOT clamped (event filtering uses it as a half-open bound,
    and the reference behaves identically because events can't start past
    the contig end)."""
    windows_number = (ref_size + cfg.region_size - 1) // cfg.region_size
    origin = Interval(contig, 0, cfg.region_size)
    padded = Interval(contig, 0, cfg.region_size + cfg.padding_size)
    for _ in range(windows_number):
        # Clamp begin at 0 as well as end at the contig: --padding-size >
        # --region-size would otherwise yield a negative begin, which the
        # Python path would silently wrap (seq[-k:end]) and the fused native
        # path would turn into an out-of-bounds pointer read.  The reference
        # never hits this (its sizes are hardcoded 245/85,
        # haplotypecaller.hpp:112-113).
        clamped = Interval(
            contig, max(0, padded.begin), min(padded.end, ref_size)
        )
        yield origin, clamped
        origin = Interval(contig, origin.begin + cfg.region_size, origin.end + cfg.region_size)
        padded = Interval(
            contig, origin.begin - cfg.padding_size, origin.end + cfg.padding_size
        )


def call_region(
    reads: List[SAMRecord],
    window_ref: str,
    padded_region: Interval,
    origin_region: Interval,
    cfg: HCConfig,
    pairhmm_engine: PairHMMEngine,
    assemble_fn: AssembleFn,
    device="cuda",
) -> RegionResult:
    """haplotypecaller.hpp:83-107 for one window (``device``: where the
    "cuda" genotyper runs)."""
    reads = filter_reads(reads, cfg)
    reads = hard_clip_reads(reads, padded_region, cfg)
    result = RegionResult(origin_region, padded_region, len(reads), 0, [])
    if not reads:
        return result

    haplotypes = assemble_fn(reads, window_ref, cfg)
    result.n_haplotypes = len(haplotypes)
    if len(haplotypes) <= 1:
        return result

    result.cell_updates = sum(len(r) for r in reads) * sum(len(h) for h in haplotypes)
    likelihoods, kept = compute_likelihoods(reads, haplotypes, cfg, pairhmm_engine)
    result.variants = assign_genotype_likelihoods(
        kept, haplotypes, likelihoods, window_ref, padded_region, origin_region,
        cfg, device,
    )
    return result


def compute_likelihoods(
    reads: List[SAMRecord],
    haplotypes: List[Haplotype],
    cfg: HCConfig,
    pairhmm_engine: PairHMMEngine,
) -> Tuple[np.ndarray, List[SAMRecord]]:
    """Engine dispatch + the normalization/poorly-modeled-read filter that
    the reference applies inside IntelPairHMM::compute_likelihoods."""
    from ..ops.pairhmm_oracle import normalize_and_filter

    matrix = pairhmm_engine(reads, haplotypes)
    filtered, kept_indices = normalize_and_filter(
        matrix,
        [len(r) for r in reads],
        cfg.max_best_alt_likelihood_difference,
        cfg.expected_error_rate_per_base,
        cfg.log10_quality_per_base,
        cfg.max_expected_error_per_read,
    )
    kept_reads = [reads[i] for i in kept_indices]
    return filtered, kept_reads


def call(
    sam_path: str,
    fasta_path: str,
    out_path: Optional[str],
    cfg: HCConfig = DEFAULT_CONFIG,
    pairhmm_engine: Optional[PairHMMEngine] = None,
    assemble_fn: Optional[AssembleFn] = None,
    region_filter: Optional[Callable[[int], bool]] = None,
    device="cuda",
) -> List[RegionResult]:
    """End-to-end SAM + FASTA -> VCF.  Returns per-region results; writes the
    VCF if ``out_path`` is given.  ``device`` is where the "cuda" and "diag"
    PairHMM engines and the "cuda" genotyper run."""
    from ..ops.engines import make_pairhmm_engine, make_assemble_fn

    if pairhmm_engine is None:
        pairhmm_engine = make_pairhmm_engine(cfg, device=device)
    if assemble_fn is None:
        assemble_fn = make_assemble_fn(cfg)

    fasta = read_fasta(fasta_path)
    ref = fasta.seq
    buckets = load_reads_by_start(read_sam(sam_path), len(ref))

    results: List[RegionResult] = []
    for index, (origin, padded) in enumerate(iter_windows(fasta.name, len(ref), cfg)):
        if region_filter is not None and not region_filter(index):
            continue
        reads = downsample_window(buckets, padded.begin, padded.end, cfg)
        if not reads:
            results.append(RegionResult(origin, padded, 0, 0, []))
            continue
        window_ref = ref[padded.begin : padded.end]
        results.append(
            call_region(reads, window_ref, padded, origin, cfg, pairhmm_engine,
                        assemble_fn, device)
        )

    if out_path is not None:
        write_vcf(out_path, [(fasta.name, len(ref))], results, cfg)
    return results


def call_batched(
    sam_path: str,
    fasta_path: str,
    out_path: Optional[str],
    cfg: HCConfig = DEFAULT_CONFIG,
    assemble_fn: Optional[AssembleFn] = None,
    region_filter: Optional[Callable[[int], bool]] = None,
    runner=None,
    logger: HCLogger = NULL_LOGGER,
    timers: Optional[StageTimers] = None,
    counters: Optional[RunCounters] = None,
    manifest=None,
    start_ranges=None,
    device="cuda",
) -> List[RegionResult]:
    """Two-phase pipeline for device engines: assemble ALL regions on the
    host first, dispatch PairHMM for all regions in a few large device
    batches (ops/runner.py), then genotype.  Amortizes per-dispatch
    host<->device latency across the whole contig.

    ``start_ranges`` ({contig: (lo, hi)} 0-based start positions) restricts
    the columnar parse to reads the selected windows can actually use — the
    multi-host shard path passes each process's padded region span so N
    hosts no longer parse the full file N times (SURVEY.md §7 step 7).
    With cfg.stream_contigs, contigs are parsed one at a time from byte
    slices found by a single ranged scan, and each contig's columns are
    freed once its last region is assembled (bounded memory for WGS).

    ``device`` is where the runner this builds for the "cuda", "diag" or
    "shardmap" engine and the "cuda" genotyper run ("cuda" or "cpu"); it is not a
    config key.

    Each ``timers`` stage is also a span: ``caller.parse``, ``caller.io``,
    ``caller.pairhmm`` (this thread blocked in the runner's submit, drain
    or run), ``caller.genotype`` (on the "genotype" thread where it has
    one) and ``caller.assemble``, one a region on the host thread that
    assembles it."""
    from ..ops.engines import make_assemble_fn
    from ..ops.pairhmm_oracle import normalize_and_filter
    from ..ops.runner import PairHMMJob

    assemble_overridden = assemble_fn is not None
    if assemble_fn is None:
        assemble_fn = make_assemble_fn(cfg)
    if runner is None:
        if cfg.pairhmm_engine == "cuda":
            from ..ops.torch_runner import TorchPairHMMRunner

            runner = TorchPairHMMRunner(cfg, device=device)
        elif cfg.pairhmm_engine == "native":
            from ..ops.runner import NativePairHMMRunner

            runner = NativePairHMMRunner(cfg)
        elif cfg.pairhmm_engine == "diag":
            from ..ops.torch_runner import DiagPairHMMRunner

            runner = DiagPairHMMRunner(cfg, device=device)
        elif cfg.pairhmm_engine == "shardmap":
            from ..parallel.sharded_step import ShardMapPairHMMRunner

            runner = ShardMapPairHMMRunner(cfg, device=device)
        else:
            raise ValueError(
                f"pairhmm engine {cfg.pairhmm_engine!r} has no batched runner"
            )
    timers = timers or StageTimers()
    counters = counters or RunCounters()

    use_columnar = cfg.data_engine == "native"
    if cfg.data_engine == "auto":
        from .. import native

        use_columnar = native.available()
    stream = use_columnar and cfg.stream_contigs
    layout = None
    with timers.stage("parse"):
        contigs = read_all_fasta(fasta_path)
        for record in contigs:
            record.seq = record.seq.upper()
        contig_sizes = {c.name: len(c.seq) for c in contigs}
        store = None
        if use_columnar:
            from ..io.columnar import ColumnarReadStore, SamLayout

            if stream:
                # one cheap ranged scan; per-contig slice parses happen
                # lazily as the walk reaches each contig
                layout = SamLayout(
                    sam_path, contig_sizes, start_ranges,
                    threads=cfg.host_threads,
                )
            else:
                store = ColumnarReadStore(
                    sam_path, contig_sizes, start_ranges=start_ranges,
                    threads=cfg.host_threads,
                )
                counters.reads_parsed = store.n_bucketed
        else:
            all_buckets = load_reads_by_contig(read_sam(sam_path), contig_sizes)
            counters.reads_parsed = sum(
                len(b) for buckets in all_buckets.values() for b in buckets
            )

    # global region index across contigs (contig-major, FASTA order)
    def all_windows():
        index = 0
        for contig in contigs:
            for origin, padded in iter_windows(contig.name, len(contig.seq), cfg):
                yield index, contig, origin, padded
                index += 1

    # phase A: host prepare + assembly + job packing per region, on a pool
    # of host threads (the native prepare/assemble/SW calls release the GIL,
    # so this scales with cores; a 1-CPU host runs the inline path), with
    # chunked device submission from the consuming thread.
    # whole-window native fast path: downsample/filter/clip + assembly + SW
    # in ONE ctypes call per region (only when nothing is overridden — the
    # separate-stage path remains the differential oracle)
    fused_capable = (
        use_columnar
        and not assemble_overridden
        and cfg.assembler_engine == "native"
        and cfg.sw_engine == "native"
    )
    if fused_capable:
        from .. import native as _native

    # per-contig mutable data source (streaming swaps it at contig
    # boundaries; the non-streaming path fills it once)
    contig_seqs = {c.name: c.seq for c in contigs}
    data = {"store": store, "fused": None}
    if fused_capable and store is not None:
        data["fused"] = _native.fused_window_fn(cfg, store, contig_seqs)

    def build_job(reads, haplotypes):
        if len(haplotypes) <= 1:
            return None
        if hasattr(reads, "pair_view"):  # columnar WindowReads: O(1) CSR
            read_arrays = reads.pair_view()
        else:
            read_arrays = [
                (r.seq_u8, r.qual_u8)
                if hasattr(r, "seq_u8")
                else (
                    np.frombuffer(r.seq.encode(), dtype=np.uint8),
                    np.frombuffer(r.qual.encode(), dtype=np.uint8),
                )
                for r in reads
            ]
        hap_arrays = [
            h.bases_u8
            if getattr(h, "bases_u8", None) is not None
            else np.frombuffer(h.bases.encode(), dtype=np.uint8)
            for h in haplotypes
        ]
        return PairHMMJob(read_arrays, hap_arrays)

    def prep_assemble(contig, origin, padded):
        """Worker body: everything per-region that needs no shared state.
        Returns (status, payload, prep_seconds, assemble_seconds).  Reads
        the data source through ``data`` so contig streaming can swap the
        store between contigs (all in-flight workers are drained first)."""
        fused_fn = data["fused"]
        if fused_fn is not None:
            window_ref = contig.seq[padded.begin : padded.end]
            try:
                with span("caller.assemble") as asm:
                    reads, n_downsampled, haplotypes = fused_fn(
                        contig.name, padded.begin, padded.end, window_ref
                    )
            except PathExplosionError as exc:
                # pathological window (assembly path explosion): skip the
                # region instead of aborting a whole-genome run.  Other
                # native errors are internal bugs and propagate.
                return "failed", str(exc), asm.seconds, 0.0
            if n_downsampled == 0:
                return "ignored", None, asm.seconds, 0.0
            if not reads:
                return "empty", None, asm.seconds, 0.0
            payload = (reads, haplotypes, window_ref, build_job(reads, haplotypes))
            # one fused call: attribute its time to the assemble stage
            return "ok", payload, 0.0, asm.seconds
        t0 = time.perf_counter()
        if use_columnar:
            reads, n_downsampled = data["store"].prepare_window(
                contig.name, padded.begin, padded.end, cfg
            )
            if n_downsampled == 0:
                return "ignored", None, time.perf_counter() - t0, 0.0
        else:
            reads = downsample_window(
                all_buckets[contig.name], padded.begin, padded.end, cfg
            )
            if not reads:
                return "ignored", None, time.perf_counter() - t0, 0.0
            reads = filter_reads(reads, cfg)
            reads = hard_clip_reads(reads, padded, cfg)
        t1 = time.perf_counter()
        if not reads:
            return "empty", None, t1 - t0, 0.0
        window_ref = contig.seq[padded.begin : padded.end]
        try:
            with span("caller.assemble") as asm:
                haplotypes = assemble_fn(reads, window_ref, cfg)
        except PathExplosionError as exc:
            return "failed", str(exc), t1 - t0, asm.seconds
        payload = (reads, haplotypes, window_ref, build_job(reads, haplotypes))
        return "ok", payload, t1 - t0, asm.seconds

    pending = []  # (result, reads, haplotypes, window_ref, job)
    unsubmitted: List = []
    submitted_batches: List = []
    can_overlap = hasattr(runner, "submit") and hasattr(runner, "drain")
    results: List[RegionResult] = []

    def submit_unsubmitted():
        nonlocal unsubmitted
        jobs = [e[4] for e in unsubmitted]
        with timers.stage("pairhmm"):
            submitted_batches.append((runner.submit(jobs), unsubmitted))
        unsubmitted = []

    def consume(result, origin, padded, outcome):
        status, payload, dt_prep, dt_asm = outcome
        timers.add("downsample_clip", dt_prep)
        timers.add("assemble", dt_asm)
        if status == "ignored":
            counters.regions_skipped += 1
            logger.region_ignored(origin, padded)
            return
        if status == "empty":
            counters.regions_skipped += 1
            return
        if status == "failed":
            counters.regions_failed += 1
            logger.region_failed(origin, payload)
            return
        reads, haplotypes, window_ref, job = payload
        result.n_reads = len(reads)
        counters.reads_used += len(reads)
        logger.region_start(origin, padded, len(reads))
        result.n_haplotypes = len(haplotypes)
        counters.haplotypes += len(haplotypes)
        logger.haplotypes_found(len(haplotypes))
        if job is None:
            return
        read_bases = (
            int(reads.off[-1])
            if hasattr(reads, "off")
            else sum(len(r) for r in reads)
        )
        result.cell_updates = read_bases * sum(len(h) for h in haplotypes)
        counters.pairs += len(reads) * len(haplotypes)
        counters.cell_updates += result.cell_updates
        entry = (result, reads, haplotypes, window_ref, job)
        if not can_overlap:
            # overlap path drains + genotypes + frees chunk by chunk; a
            # second global list would pin every region's read/hap arrays
            # to end-of-run (13+ GB at 60 Mb)
            pending.append(entry)
        unsubmitted.append(entry)
        # phase overlap: ship a chunk of assembled regions to the device and
        # keep assembling — dispatches are async, so the GPU computes while
        # the host works the next regions (runners without submit/drain,
        # e.g. test shims, fall back to one run() at the end)
        if can_overlap and len(unsubmitted) >= SUBMIT_CHUNK_REGIONS:
            submit_unsubmitted()
            # bound in-flight memory: with > MAX_INFLIGHT_BATCHES chunks
            # queued, the oldest has surely finished on device — drain,
            # genotype, and FREE it now, overlapped with assembly of the
            # next regions (previously every chunk's arrays lived to
            # end-of-run and genotyping was serial after the walk)
            while len(submitted_batches) > MAX_INFLIGHT_BATCHES:
                token, entries = submitted_batches.pop(0)
                with timers.stage("pairhmm"):
                    runner.drain([token])
                genotype_chunk(entries)

    def genotype_entries(entries):
        # Both engines genotype a whole drained chunk as ONE cross-region
        # batch: "cuda" as padded tiles through the genotype kernel on
        # ``device`` (genotype_regions_device, its own CUDA stream), "host"
        # as padded NumPy f64 tiles (genotype_regions_numpy) — per-site
        # small-matrix call overhead dominated the stage at WGS scale.  The
        # per-site path (assign_genotype_likelihoods) remains the oracle,
        # used by call_region and the differential tests.
        batched = []
        for result, reads, haplotypes, window_ref, job in entries:
            columnar_reads = hasattr(reads, "lengths")
            filtered, kept_indices = normalize_and_filter(
                job.result,
                reads.lengths if columnar_reads else [len(r) for r in reads],
                cfg.max_best_alt_likelihood_difference,
                cfg.expected_error_rate_per_base,
                cfg.log10_quality_per_base,
                cfg.max_expected_error_per_read,
            )
            kept_reads = (
                reads.select(kept_indices)
                if columnar_reads
                else [reads[i] for i in kept_indices]
            )
            batched.append(
                (result,
                 (kept_reads, haplotypes, filtered, window_ref,
                  result.padded, result.origin))
            )
        if batched:
            from .genotyper import genotype_regions_device, genotype_regions_numpy

            if cfg.genotyper_engine == "cuda":
                per_region = genotype_regions_device(
                    [b[1] for b in batched], cfg, device=device,
                    counters=counters,
                )
            else:
                per_region = genotype_regions_numpy(
                    [b[1] for b in batched], cfg
                )
            for (result, _inputs), region_variants in zip(batched, per_region):
                result.variants = region_variants
                counters.variants += len(result.variants)
                if manifest is not None:
                    manifest.record(result.region_id, result.variants)

    n_workers = cfg.host_threads if cfg.host_threads > 0 else (os.cpu_count() or 1)
    pool = ThreadPoolExecutor(n_workers) if n_workers > 1 else None

    # chunk genotyping overlaps assembly on multi-core hosts: one worker
    # keeps manifest appends and counter updates serialized (and chunk
    # order deterministic); bounded pending futures give backpressure so
    # drained-but-ungenotyped chunks cannot pile up in memory.  Single-core
    # (pool is None) genotypes inline exactly as before.
    genotype_pool = (
        ThreadPoolExecutor(1, thread_name_prefix="genotype")
        if pool is not None and can_overlap
        else None
    )
    genotype_futs: deque = deque()

    def genotype_chunk(entries):
        if genotype_pool is None:
            with timers.stage("genotype"):
                genotype_entries(entries)
            entries.clear()
            return

        def work():
            with span("caller.genotype") as step:
                genotype_entries(entries)
            timers.add("genotype", step.seconds)
            entries.clear()

        genotype_futs.append(genotype_pool.submit(work))
        while len(genotype_futs) > 2:
            genotype_futs.popleft().result()
    inflight = deque()  # (result, origin, padded, future) in region order
    max_inflight = max(64, 8 * n_workers)
    current_contig = [None]

    # streaming parse-ahead: one background thread slice-parses the next
    # contig's columns while the current contig assembles, so only the
    # first contig's parse blocks the walk (cfg.parse_ahead; bounded at
    # one contig in flight).  Store construction is independent of the
    # active store (own buffers, thread-local native scratch), so it is
    # safe alongside the assembly workers.
    contig_order = [c.name for c in contigs]
    prefetch: Dict[str, object] = {}  # name -> Future[ColumnarReadStore]
    prefetch_pool = (
        ThreadPoolExecutor(1, thread_name_prefix="parse-ahead")
        if stream and cfg.parse_ahead and len(contig_order) > 1
        else None
    )

    def prefetch_after(name: str) -> None:
        if prefetch_pool is None:
            return
        i = contig_order.index(name)
        if i + 1 < len(contig_order):
            nxt = contig_order[i + 1]
            if nxt not in prefetch:
                prefetch[nxt] = prefetch_pool.submit(
                    layout.store_for, nxt, threads=cfg.host_threads
                )

    def switch_contig(contig):
        """Contig streaming: drain every in-flight worker touching the old
        contig's columns, free them, and slice-parse the next contig."""
        if not stream or current_contig[0] == contig.name:
            return
        while inflight:
            r, o, p, fut = inflight.popleft()
            consume(r, o, p, fut.result())
        fut = prefetch.pop(contig.name, None)
        for stale in list(prefetch):  # skipped contigs: free their columns
            prefetch.pop(stale).cancel()
        with timers.stage("parse"):
            # the stage timer charges only the blocking wait; a prefetch
            # that finished during assembly costs ~0 here
            new_store = fut.result() if fut is not None else layout.store_for(
                contig.name, threads=cfg.host_threads
            )
        counters.reads_parsed += new_store.n_bucketed
        data["store"] = new_store
        data["fused"] = (
            _native.fused_window_fn(cfg, new_store, contig_seqs)
            if fused_capable
            else None
        )
        current_contig[0] = contig.name
        prefetch_after(contig.name)

    try:
        for index, contig, origin, padded in all_windows():
            if region_filter is not None and not region_filter(index):
                continue
            result = RegionResult(origin, padded, 0, 0, [])
            results.append(result)
            counters.regions += 1
            if manifest is not None and manifest.is_done(index):
                result.variants = manifest.variants_for(index)
                counters.variants += len(result.variants)
                continue
            result.region_id = index
            switch_contig(contig)
            if pool is None:
                consume(result, origin, padded, prep_assemble(contig, origin, padded))
            else:
                inflight.append(
                    (result, origin, padded,
                     pool.submit(prep_assemble, contig, origin, padded))
                )
                while len(inflight) > max_inflight:
                    r, o, p, fut = inflight.popleft()
                    consume(r, o, p, fut.result())
        while inflight:
            r, o, p, fut = inflight.popleft()
            consume(r, o, p, fut.result())
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        if prefetch_pool is not None:
            prefetch_pool.shutdown(wait=True)
        prefetch.clear()
    if stream:
        # all jobs hold copies of their read data; the last contig's
        # columns are dead weight during pairhmm drain + genotyping
        data["store"] = data["fused"] = None

    # phases B+C: drain + genotype + free any chunks still in flight after
    # the walk (most were already handled mid-walk by consume's bounded
    # in-flight loop); host genotyping of chunk k overlaps device compute
    # of the still-queued later chunks
    try:
        if can_overlap:
            if unsubmitted:
                submit_unsubmitted()
            while submitted_batches:
                token, entries = submitted_batches.pop(0)
                with timers.stage("pairhmm"):
                    runner.drain([token])
                # frees the chunk's read/hap/likelihood arrays after
                # genotyping — only the RegionResult variants are needed
                # past this point
                genotype_chunk(entries)
            while genotype_futs:
                genotype_futs.popleft().result()
        else:
            with timers.stage("pairhmm"):
                runner.run([e[4] for e in unsubmitted])
            with timers.stage("genotype"):
                genotype_entries(pending)
    finally:
        if genotype_pool is not None:
            genotype_pool.shutdown(wait=True)

    with timers.stage("io"):
        if out_path is not None:
            write_vcf(
                out_path, [(c.name, len(c.seq)) for c in contigs], results, cfg
            )
    if hasattr(runner, "stop_prewarm"):
        runner.stop_prewarm()
    logger.done()
    return results


def write_vcf(
    out_path: str,
    contigs: Sequence[Tuple[str, int]],
    results: Sequence[RegionResult],
    cfg: HCConfig,
) -> None:
    with open(out_path, "w") as handle:
        handle.write(vcf_header(contigs, cfg))
        for region in results:
            for variant in region.variants:
                handle.write(variant.to_vcf_row())
