"""Multi-process scale-out: region sharding + variant gathering, on
torch.distributed.

Each process (one per host, or several on one host) calls its own
contiguous block of regions over the cards it sees
(``CUDA_VISIBLE_DEVICES`` selects them) and parses only the part of the SAM
those regions can read; the FASTA and the configuration are the same
everywhere.  The per-region variant rows encode to a flat fixed-width
record array, every process all-gathers them, and process 0 writes the one
VCF in region order.

Every gathered payload is a host array (the variant records, the stats
JSON), so the process group is gloo over TCP: it needs no card and runs on
CPU-only hosts and card hosts alike (NCCL would move device buffers, which
none of these are, and cannot put two ranks on one card).

The counterpart of gatk_hc_tpu/parallel/multihost.py (jax.distributed and
multihost_utils.process_allgather there); the record layout is the
reference's byte for byte.  A single process (no ``num_processes`` above 1)
needs no process group: the partition is trivial and the gathers return
their input.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import HCConfig
from ..models.haplotype import Variant
from ..utils.interval import Interval

# flat record: region, contig id, begin, end, gt pair, gq, then allele lens
_MAX_ALLELES = 8
_MAX_ALLELE_LEN = 64
_FIXED_COLS = 7

# how long process-group set-up and each gather wait for the other
# processes (a region shard may finish well before the slowest one)
TIMEOUT_S = 1800.0


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def distributed_init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> Tuple[int, int]:
    """Join the gloo process group at ``tcp://<coordinator>`` (host:port,
    where process 0 listens) when ``num_processes`` > 1; nothing otherwise.
    Returns (rank, world size): (0, 1) without a process group.  A failure
    to join raises: a multi-process run never goes on as one process."""
    if num_processes is not None and num_processes > 1:
        if not coordinator:
            raise ValueError("a multi-process run needs --coordinator host:port")
        if process_id is None or not 0 <= process_id < num_processes:
            raise ValueError(
                f"process id {process_id} is not in [0, {num_processes})")
        if not dist.is_available() or not dist.is_gloo_available():
            raise RuntimeError("torch.distributed with gloo is not available")
        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=timeout_s),
            )
        if dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"process group has {dist.get_world_size()} processes, "
                f"{num_processes} asked for")
    return process_index(), process_count()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def shutdown() -> None:
    """Leave the process group, if one was joined (the end of a run)."""
    if _initialized():
        dist.destroy_process_group()


def _all_gather(array: np.ndarray) -> np.ndarray:
    """Every process's array (same shape and dtype everywhere), stacked in
    rank order, through the gloo group."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def partition_regions(n_regions: int, process_index: int, process_count: int):
    """Contiguous block partition; block i -> process i."""
    per = -(-n_regions // process_count)
    start = process_index * per
    return range(start, min(start + per, n_regions))


def shard_start_ranges(contigs, cfg: HCConfig, region_range: range):
    """Per-contig 0-based start-position spans a process's region block can
    select reads from — the columnar parse filter for the process's SAM
    shard (each process materializes only its own reads instead of N full
    parses).

    Windows pick reads by START position inside their padded interval
    (models/downsampler.py), so the span for a contiguous run of local
    windows [first, last] is [first's padded begin, last's padded end):
    window 0 is only end-padded, later windows pad both sides
    (models/caller.py::iter_windows).  Reads in the overlap between two
    shards' spans are parsed by both — exactly the reads whose windows
    straddle the shard boundary."""
    ranges = {}
    base = 0
    for c in contigs:
        size = len(c.seq)
        n_c = (size + cfg.region_size - 1) // cfg.region_size
        lo_id = max(region_range.start, base)
        hi_id = min(region_range.stop, base + n_c)
        if lo_id < hi_id:
            first_local = lo_id - base
            last_local = hi_id - base - 1
            lo = (
                0
                if first_local == 0
                else first_local * cfg.region_size - cfg.padding_size
            )
            hi = min(
                size, (last_local + 1) * cfg.region_size + cfg.padding_size
            )
            ranges[c.name] = (lo, hi)
        base += n_c
    return ranges


def encode_variants(
    region_ids: Sequence[int],
    variants: Sequence[Variant],
    contig_names: Sequence[str] = (),
):
    """Variants -> (int32 table, uint8 allele blob) fixed-width records.
    Records carry the contig as an index into ``contig_names`` (FASTA
    order), so multi-contig runs gather losslessly.  Unknown contigs raise
    (a silent index-0 relabel would corrupt the gathered VCF)."""
    if isinstance(contig_names, str):
        contig_names = (contig_names,)
    index = {name: i for i, name in enumerate(contig_names)}
    n = len(variants)
    table = np.zeros((n, _FIXED_COLS + _MAX_ALLELES), dtype=np.int32)
    blob = np.zeros((n, _MAX_ALLELES, _MAX_ALLELE_LEN), dtype=np.uint8)
    for i, (rid, v) in enumerate(zip(region_ids, variants)):
        alleles = v.alleles[:_MAX_ALLELES]
        if v.location.contig not in index:
            raise KeyError(
                f"variant contig {v.location.contig!r} not in FASTA "
                f"contigs {list(contig_names)!r}"
            )
        table[i, :_FIXED_COLS] = (
            rid, index[v.location.contig],
            v.location.begin, v.location.end, v.gt[0], v.gt[1], v.gq,
        )
        for a, allele in enumerate(alleles):
            encoded = allele.encode()[:_MAX_ALLELE_LEN]
            table[i, _FIXED_COLS + a] = len(encoded)
            blob[i, a, : len(encoded)] = np.frombuffer(encoded, dtype=np.uint8)
    return table, blob


def decode_variants(
    table: np.ndarray, blob: np.ndarray, contig_names: Sequence[str]
):
    """Inverse of encode_variants -> [(region_id, Variant)] sorted by
    (region, begin).  ``contig_names`` may be a single name (str) for
    single-contig convenience."""
    if isinstance(contig_names, str):
        contig_names = (contig_names,)
    out = []
    for i in range(table.shape[0]):
        rid, cid, begin, end, gt1, gt2, gq = (
            int(x) for x in table[i, :_FIXED_COLS]
        )
        alleles = []
        for a in range(_MAX_ALLELES):
            ln = int(table[i, _FIXED_COLS + a])
            if ln == 0 and a > 0:
                break
            alleles.append(blob[i, a, :ln].tobytes().decode())
        out.append(
            (
                rid,
                Variant(
                    location=Interval(contig_names[cid], begin, end),
                    alleles=tuple(alleles),
                    gt=(gt1, gt2),
                    gq=gq,
                ),
            )
        )
    out.sort(key=lambda item: (item[0], item[1].location.begin))
    return out


def gather_variants(
    region_ids: Sequence[int],
    variants: Sequence[Variant],
    contig_names: Sequence[str],
):
    """All-gather variant records across processes (no-op single-process):
    the counts first, then the tables padded to the largest count with -1
    rows and the blobs, of which the valid rows are kept."""
    if isinstance(contig_names, str):
        contig_names = (contig_names,)
    table, blob = encode_variants(region_ids, variants, contig_names)
    if process_count() == 1:
        return decode_variants(table, blob, contig_names)
    counts = _all_gather(np.array([table.shape[0]], dtype=np.int64))
    pad = int(counts.max()) - table.shape[0]
    tables = _all_gather(
        np.pad(table, ((0, pad), (0, 0)), constant_values=-1)
    ).reshape(-1, table.shape[1])
    blobs = _all_gather(
        np.pad(blob, ((0, pad), (0, 0), (0, 0)))
    ).reshape(-1, _MAX_ALLELES, _MAX_ALLELE_LEN)
    valid = tables[:, 0] >= 0
    return decode_variants(tables[valid], blobs[valid], contig_names)


_STATS_PAD = 8192


def gather_stats(counters, timers):
    """All-reduce of run counters + stage timers across processes.  Every
    process must call this (it is a collective); returns the merged dict on
    all of them.

    Counters sum; timers sum (they are per-process thread-seconds) and a
    per-stage max is included as ``timers_max`` — the straggler view."""
    payload = json.dumps(
        {
            "counters": dataclasses.asdict(counters)
            if counters is not None else {},
            "timers": dict(timers.totals) if timers is not None else {},
        }
    ).encode()
    if len(payload) > _STATS_PAD:
        raise ValueError(f"stats payload {len(payload)}B exceeds {_STATS_PAD}")
    if process_count() == 1:
        rows = [payload]
    else:
        buf = np.zeros(_STATS_PAD, np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
        rows = [bytes(row[row != 0].tobytes()) for row in _all_gather(buf)]
    counters_sum: dict = {}
    timers_sum: dict = {}
    timers_max: dict = {}
    for row in rows:
        decoded = json.loads(row.decode())
        for k, v in decoded["counters"].items():
            counters_sum[k] = counters_sum.get(k, 0) + v
        for k, v in decoded["timers"].items():
            timers_sum[k] = timers_sum.get(k, 0.0) + v
            timers_max[k] = max(timers_max.get(k, 0.0), v)
    return {
        "processes": len(rows),
        "counters": counters_sum,
        "timers": {k: round(v, 4) for k, v in timers_sum.items()},
        "timers_max": {k: round(v, 4) for k, v in timers_max.items()},
    }


def run_multihost(
    sam_path: str,
    fasta_path: str,
    out_path: Optional[str],
    cfg: HCConfig,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    logger=None,
    timers=None,
    counters=None,
    manifest_path: Optional[str] = None,
    region_filter=None,
    runner=None,
    device="cuda",
):
    """Whole-pipeline multi-process entry: join the group, call this
    process's region block, gather, and write the VCF from process 0.

    Returns (local RegionResults, merged [(region_id, Variant)]).  The
    region id space is the contig-major global index that call_batched's
    all_windows() walks, so multi-contig inputs shard correctly.
    ``region_filter`` (global ids, as -L gives them) narrows every block;
    ``runner`` and ``device`` go to call_batched.  The process group stays
    up for a later ``gather_stats``; ``shutdown`` ends it."""
    from ..io.fasta import read_all_fasta
    from ..models.caller import call_batched, vcf_header
    from ..utils.logging import NULL_LOGGER

    pidx, pcount = distributed_init(coordinator, num_processes, process_id)
    contigs = read_all_fasta(fasta_path)
    contig_names = [c.name for c in contigs]
    n_regions = sum(
        (len(c.seq) + cfg.region_size - 1) // cfg.region_size for c in contigs
    )
    mine = partition_regions(n_regions, pidx, pcount)
    mine_set = set(mine)
    if region_filter is not None:
        mine_set = {i for i in mine_set if region_filter(i)}

    manifest = None
    if manifest_path is not None:
        # per-process manifest: region ids are the global index, so each
        # shard's checkpoint file resumes independently
        from .checkpoint import RegionManifest

        manifest = RegionManifest(f"{manifest_path}.p{pidx}")

    results = call_batched(
        sam_path, fasta_path, None, cfg,
        region_filter=lambda i: i in mine_set,
        logger=logger or NULL_LOGGER,
        timers=timers, counters=counters,
        manifest=manifest,
        # shard parse: this process materializes only the reads its padded
        # windows can select instead of the whole file
        start_ranges=shard_start_ranges(contigs, cfg, mine),
        runner=runner, device=device,
    )
    region_ids: List[int] = []
    variants: List[Variant] = []
    # results arrive in region order, one per selected region
    for rid, region in zip(sorted(mine_set), results):
        for v in region.variants:
            region_ids.append(rid)
            variants.append(v)

    merged = gather_variants(region_ids, variants, contig_names)
    if out_path is not None and pidx == 0:
        with open(out_path, "w") as handle:
            handle.write(
                vcf_header([(c.name, len(c.seq)) for c in contigs], cfg)
            )
            for _, variant in merged:
                handle.write(variant.to_vcf_row())
    return results, merged
