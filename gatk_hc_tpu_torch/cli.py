"""Command-line interface, mirroring the reference binary's flags
(src/main.cpp:6-16): -I/--input SAM, -O/--output VCF, -R/--reference FASTA.

    python -m gatk_hc_tpu_torch.cli -I reads.sam -R ref.fa -O out.vcf

Extensions over the reference: engine and device selection, deterministic
downsampling, interval restriction (-L), verbosity, stage timing stats,
checkpoint/resume manifests, and assembly-graph dumps.  The PairHMM runs on
the CUDA card by default (--pairhmm cuda --device cuda) through the ppe
kernel, or the striped kernel with --pallas-algo striped; --pairhmm diag
runs the anti-diagonal forward in PyTorch ops, --pairhmm native the C++
engine, --pairhmm shardmap splits each region's pair grid over a (data,
hap) grid of the visible cards (the same kernels per block), and --pairhmm
auto picks native or cuda by the SAM's size on the card (always native
with --device cpu).
--genotyper cuda runs the genotype reductions through the CUDA genotype
kernel (f64) instead of on the host.  --device cpu runs cuda, diag and the
cuda genotyper through the plain PyTorch versions of their kernels.  The
dispatch flags (--dispatch-mode, --no-packed-nib, --fuse-groups,
--no-fuse-auto, --device-timeout) choose how groups are shipped and
launched; every choice gives the same VCF.  --num-processes N
--process-id I --coordinator HOST:PORT run one of N processes, each calling
its own block of regions on the cards it sees, joined by a gloo process
group; process 0 writes the VCF.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from .config import DEFAULT_CONFIG, FUSE_GROUPS


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gatk-hc-torch",
        description="HaplotypeCaller on PyTorch + CUDA: SAM + FASTA -> VCF",
    )
    parser.add_argument("-I", "--input", required=True, help="SAM file containing reads")
    parser.add_argument("-O", "--output", required=True, help="output VCF path")
    parser.add_argument("-R", "--reference", required=True, help="reference FASTA")
    parser.add_argument(
        "-L", "--intervals", default=None,
        help="restrict calling to contig:begin-end (0-based half-open)",
    )
    parser.add_argument(
        "--pairhmm",
        default=DEFAULT_CONFIG.pairhmm_engine,
        choices=("auto", "cuda", "diag", "native", "python", "shardmap"),
        help="PairHMM engine (default: %(default)s; cuda = the hand-written "
        "CUDA kernel through the batched runner, diag = the anti-diagonal "
        "forward in PyTorch ops, one call per region, native = the C++ "
        "host engine, python = the NumPy oracle, shardmap = each region's "
        "pair grid split over a (data, hap) grid of the visible cards, the "
        "same kernels per block, auto = native for a SAM "
        "under the size where the card wins end to end, cuda otherwise; "
        "native with --device cpu — bit-exact either way)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where --pairhmm cuda / diag / shardmap and --genotyper cuda "
        "run: every visible card (default) or the CPU through the kernels' "
        "plain PyTorch versions",
    )
    parser.add_argument(
        "--assembler",
        default=DEFAULT_CONFIG.assembler_engine,
        choices=("native", "python"),
    )
    parser.add_argument(
        "--genotyper",
        default=DEFAULT_CONFIG.genotyper_engine,
        choices=("host", "cuda"),
        help="genotype reductions: exact host NumPy f64 (default) or the "
        "CUDA genotype kernel in f64, batched over a chunk's sites (the "
        "same VCF)",
    )
    parser.add_argument(
        "--downsample",
        default=DEFAULT_CONFIG.downsample_mode,
        choices=("first", "seeded"),
        help="one read per start position: deterministic rule",
    )
    parser.add_argument(
        "--data",
        default=DEFAULT_CONFIG.data_engine,
        choices=("auto", "native", "python"),
        help="SAM parse + window prep: columnar C++ or per-record Python",
    )
    parser.add_argument(
        "--host-threads", type=int, default=DEFAULT_CONFIG.host_threads,
        help="host pipeline threads (0 = one per CPU, 1 = inline)",
    )
    parser.add_argument(
        "--stream-contigs", action="store_true",
        help="bounded-memory data path: parse one contig slice at a time "
        "and free its columns when its regions finish (WGS-scale inputs)",
    )
    parser.add_argument(
        "--pallas-algo", default=DEFAULT_CONFIG.pallas_algo,
        choices=("ppe", "striped"),
        help="CUDA PairHMM kernel of --pairhmm cuda: ppe (one warp per "
        "pair, the default) or striped (a warp's lanes sweep stripes of a "
        "pair's rows); both give the same result",
    )
    parser.add_argument(
        "--stripe-height", type=int, default=DEFAULT_CONFIG.stripe_height,
        choices=(8, 16, 32), help="rows of a stripe in the striped kernel "
        "(every value gives the same result)",
    )
    parser.add_argument(
        "--ppe-rows", type=int, default=DEFAULT_CONFIG.ppe_rows,
        choices=(1, 2, 4, 8), help="the fewest read rows one lane of the "
        "ppe kernel holds (every value gives the same result)",
    )
    parser.add_argument(
        "--dispatch-mode", default=DEFAULT_CONFIG.dispatch_mode,
        choices=("adaptive", "planes", "packed"),
        help="shipping encoding of the ppe kernel's groups: adaptive (the "
        "default: the measured winner after 32 groups), or, for tests and "
        "diagnostics, planes (i32 planes, lookups on the host) or packed "
        "(bytes, the ppe kernel applies the lookups); all give the "
        "same result",
    )
    parser.add_argument(
        "--no-packed-nib", action="store_true",
        help="for tests and diagnostics: packed groups ship raw bytes (2 B "
        "per read base) instead of the nibble-dictionary encoding (1 B per "
        "read base + a span table)",
    )
    parser.add_argument(
        "--fuse-groups", type=int, default=DEFAULT_CONFIG.fuse_groups,
        choices=FUSE_GROUPS, help="fuse up to N same-path groups into one "
        "copy and one kernel launch (1 = off)",
    )
    parser.add_argument(
        "--no-fuse-auto", action="store_true",
        help="for tests and diagnostics: fuse whenever --fuse-groups > 1, "
        "not only in a measured deeply degraded phase",
    )
    parser.add_argument(
        "--device-timeout", type=float, default=DEFAULT_CONFIG.device_timeout_s,
        metavar="S", help="seconds a device batch or the kernel build may "
        "take before a probe of the card decides between waiting longer and "
        "stopping with an error (0 = wait forever)",
    )
    parser.add_argument("--seed", type=int, default=DEFAULT_CONFIG.downsample_seed)
    parser.add_argument("--region-size", type=int, default=DEFAULT_CONFIG.region_size)
    parser.add_argument("--padding-size", type=int, default=DEFAULT_CONFIG.padding_size)
    parser.add_argument("--stats", action="store_true", help="print run stats as JSON")
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="-v: reference-style progress lines; -vv: debug",
    )
    parser.add_argument(
        "--manifest", default=None,
        help="region-manifest JSONL for checkpoint/resume",
    )
    parser.add_argument(
        "--dump-graph", type=int, default=None, metavar="REGION",
        help="write graph.dot for the given region index and exit",
    )
    # multi-process
    parser.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="where process 0 listens for the others (gloo over TCP)",
    )
    parser.add_argument(
        "--num-processes", type=int, default=None,
        help="processes of the run, each calling its own block of regions",
    )
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's index, 0 .. N-1")
    return parser


def _dump_graph(args, cfg) -> int:
    from .io.fasta import read_fasta
    from .io.sam import load_reads_by_start, read_sam
    from .models.assembler import build_debug_graph, graph_to_dot
    from .models.caller import iter_windows
    from .models.downsampler import downsample_window
    from .models.read_clipper import hard_clip_reads
    from .models.read_filters import filter_reads

    fasta = read_fasta(args.reference)
    buckets = load_reads_by_start(read_sam(args.input), len(fasta.seq))
    for index, (origin, padded) in enumerate(
        iter_windows(fasta.name, len(fasta.seq), cfg)
    ):
        if index != args.dump_graph:
            continue
        reads = downsample_window(buckets, padded.begin, padded.end, cfg)
        reads = hard_clip_reads(filter_reads(reads, cfg), padded, cfg)
        graph = build_debug_graph(
            reads, fasta.seq[padded.begin : padded.end], cfg.initial_kmer_size, cfg
        )
        with open(args.output, "w") as handle:
            handle.write(graph_to_dot(graph))
        print(f"wrote assembly graph for region {index} to {args.output}")
        return 0
    print(f"error: region {args.dump_graph} not found", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.num_processes and args.num_processes > 1):
        return _run(args)
    from .parallel.multihost import shutdown

    try:
        return _run(args)
    finally:
        shutdown()  # leave the process group, on errors too


def config_from_args(args, pairhmm: str):
    """The run's config: DEFAULT_CONFIG (with its GATK_HC_TPU_TORCH_*
    overrides) under the parsed flags, with the resolved PairHMM engine."""
    return dataclasses.replace(
        DEFAULT_CONFIG,
        pairhmm_engine=pairhmm,
        assembler_engine=args.assembler,
        data_engine=args.data,
        genotyper_engine=args.genotyper,
        downsample_mode=args.downsample,
        downsample_seed=args.seed,
        region_size=args.region_size,
        padding_size=args.padding_size,
        host_threads=args.host_threads,
        stream_contigs=args.stream_contigs,
        pallas_algo=args.pallas_algo,
        stripe_height=args.stripe_height,
        ppe_rows=args.ppe_rows,
        dispatch_mode=args.dispatch_mode,
        # the flags turn off what the defaults (or their
        # GATK_HC_TPU_TORCH_* overrides) turn on
        packed_nib=DEFAULT_CONFIG.packed_nib and not args.no_packed_nib,
        fuse_groups=args.fuse_groups,
        fuse_auto=DEFAULT_CONFIG.fuse_auto and not args.no_fuse_auto,
        device_timeout_s=args.device_timeout,
    )


def _run(args) -> int:
    pairhmm = args.pairhmm
    if pairhmm == "auto":
        import os

        from .config import resolve_auto_pairhmm_engine

        try:
            sam_bytes = os.path.getsize(args.input)
        except OSError:
            sam_bytes = 0  # a missing input errors out later as usual
        pairhmm = resolve_auto_pairhmm_engine(sam_bytes, args.device)
    cfg = config_from_args(args, pairhmm)
    if args.dump_graph is not None:
        return _dump_graph(args, cfg)

    from .models.caller import call, call_batched, iter_windows
    from .utils.logging import HCLogger, RunCounters, StageTimers, maybe_profile

    logger = HCLogger(verbosity=args.verbose)
    timers = StageTimers()
    counters = RunCounters()

    region_filter = None
    if args.intervals:
        from .io.fasta import read_all_fasta
        from .utils.interval import Interval

        target = Interval.parse(args.intervals)
        clamped = Interval(target.contig, target.begin, min(target.end, 2**62))
        # region ids are GLOBAL across contigs (contig-major, FASTA order),
        # exactly like call_batched's all_windows(); origin.overlaps checks
        # the contig name, so only the target contig's windows match
        wanted = set()
        index = 0
        for record in read_all_fasta(args.reference):
            for origin, _padded in iter_windows(record.name, len(record.seq), cfg):
                if origin.overlaps(clamped):
                    wanted.add(index)
                index += 1
        region_filter = lambda i: i in wanted

    manifest = None
    if args.manifest:
        from .parallel.checkpoint import RegionManifest

        manifest = RegionManifest(args.manifest)

    start = time.perf_counter()
    runner = None
    multi = bool(args.num_processes and args.num_processes > 1)
    if cfg.pairhmm_engine in ("cuda", "shardmap") or cfg.genotyper_engine == "cuda":
        # the engines that launch CUDA kernels build and find them in the
        # kernel cache (GATK_HC_TPU_TORCH_KERNEL_CACHE); native and python
        # never touch torch
        from .parallel.compile_cache import enable_compile_cache

        enable_compile_cache()
    try:
        if multi:
            from .parallel.multihost import run_multihost

            if cfg.pairhmm_engine == "cuda":
                from .ops.runner import BackgroundRunner

                # each process drives the cards it sees
                runner = BackgroundRunner(cfg, device=args.device)
            try:
                results, _merged = run_multihost(
                    args.input, args.reference, args.output, cfg,
                    args.coordinator, args.num_processes, args.process_id,
                    logger=logger, timers=timers, counters=counters,
                    manifest_path=args.manifest, region_filter=region_filter,
                    runner=runner, device=args.device,
                )
            finally:
                if runner is not None:
                    runner.stop_prewarm()
        elif cfg.pairhmm_engine in ("cuda", "diag", "native", "shardmap"):
            # all run the cross-region batched pipeline (same grouping +
            # columnar data path); "python" stays on the simple per-region
            # oracle pipeline
            if cfg.pairhmm_engine == "cuda":
                from .ops.runner import BackgroundRunner

                # the torch import, kernel build + load, CUDA context,
                # device tables and the kernels' warm-up launches run on a
                # background thread, overlapped with parse/assembly
                runner = BackgroundRunner(cfg, device=args.device)
            try:
                with maybe_profile():
                    results = call_batched(
                        args.input, args.reference, args.output, cfg,
                        region_filter=region_filter, logger=logger,
                        timers=timers, counters=counters, manifest=manifest,
                        runner=runner, device=args.device,
                    )
            finally:
                # on ANY exit (errors included): no warm-up launch that has
                # not started keeps the process alive
                if runner is not None:
                    runner.stop_prewarm()
        else:
            results = call(
                args.input, args.reference, args.output, cfg,
                region_filter=region_filter, device=args.device,
            )
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - start
    n_variants = sum(len(r.variants) for r in results)
    cells = sum(r.cell_updates for r in results)
    if args.stats:
        stats = {
            "regions": len(results),
            "variants": n_variants,
            "cell_updates": cells,
            "wall_s": round(elapsed, 3),
            "cells_per_s": round(cells / elapsed) if elapsed else 0,
            "engine": cfg.pairhmm_engine,
            "genotyper": cfg.genotyper_engine,
            "stages": timers.summary(),
        }
        if args.pairhmm == "auto":
            stats["engine_requested"] = "auto"
        if counters.gq_host_verified:
            # the f32 genotyper path: sites its stability guard routed to
            # the exact host f64 recompute
            stats["gq_host_verified"] = counters.gq_host_verified
        try:
            import resource

            stats["peak_rss_mb"] = (
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
            )
        except Exception:
            pass
        # cold-start attribution: interpreter + imports (process age minus
        # the CLI wall)
        from .utils.logging import process_age_s

        age = process_age_s()
        if age == age:  # not NaN
            stats["process_age_s"] = round(age, 3)
            stats["pre_main_s"] = round(age - elapsed, 3)
        # the runner once its build has ended without error, never waiting
        # for it: a run that submitted no PairHMM job does not join the
        # build (as the reference's getattr(runner, "_runner", None))
        inner = runner.built() if runner is not None else None
        if inner is not None:
            # cold start: runner construction, kernel build + load, warm-up
            # launches, first submit / drain
            if inner.init_profile:
                stats["init_profile"] = dict(inner.init_profile)
            # launches per shipping path and fusion width: one runner holds
            # every count, so nothing is merged
            if inner.dispatch_counts:
                stats["dispatch_profile"] = dict(inner.dispatch_counts)
            # groups by padded shape "r_padxc_pad" (the shapes the kernels
            # ran at; the port launches exact sizes, so it has no program
            # signatures to log as the reference's GATK_HC_TPU_LOG_PROGRAMS)
            buckets = getattr(inner, "bucket_counts", None)
            if buckets:
                stats["bucket_counts"] = {
                    f"{r}x{c}": n for (r, c), n in sorted(buckets.items())}
            # stage medians (ms): the caller's time in submit, host pack,
            # H2D, gather (striped only), kernel, D2H (per submit) and host
            # finalize, with their sums
            stats["device_stages_ms"] = inner.stage_medians()
            if inner.device.type == "cuda":
                import torch

                stats["cuda_max_memory_allocated_mb"] = round(
                    torch.cuda.max_memory_allocated(inner.device) / 2**20, 1
                )
        from .ops._kernels import LAUNCHES

        # kernel launches of this process (the PairHMM kernels and the
        # genotype kernel; warm-up launches uncounted)
        launched = {name: n for name, n in LAUNCHES.items() if n}
        if launched:
            stats["kernel_launches"] = launched
        try:
            from . import native

            profile = native.profile_read()
            if profile["regions_assembled"]:
                stats["host_profile"] = {
                    k: round(v, 4) if isinstance(v, float) else v
                    for k, v in profile.items()
                }
        except Exception:
            pass
        if multi:
            # collective: every process takes part; process 0 prints the
            # merged cross-process stats beside its own
            from .parallel.multihost import gather_stats, process_index

            merged = gather_stats(counters, timers)
            if process_index() == 0:
                stats["cluster"] = merged
                print(json.dumps(stats))
        else:
            print(json.dumps(stats))
    print(f"HaplotypeCaller done. {n_variants} variants in {elapsed:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
