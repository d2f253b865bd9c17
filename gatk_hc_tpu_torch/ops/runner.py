"""Cross-region PairHMM dispatch runner — the production device path.

The region pipeline produces many small (reads × haps) jobs; launching each
separately would drown in per-launch overhead.  ``TorchPairHMMRunner``:

1. groups jobs greedily until a launch fills up (pair budget / unique-read
   budget / unique-hap budget);
2. packs each group's UNIQUE reads and haplotypes once on the host into one
   pinned buffer: for the ppe kernel (cfg.pallas_algo "ppe") i32 planes
   with the table lookups applied there; for the striped kernel
   ("striped") the raw bytes, 2 B per base, whose lookups run on the card
   once per group (ops/pairhmm_striped.py::prepare_tables_striped);
   divisions stay on the host either way;
3. on one CUDA stream: copies the buffer to the card, expands (read, hap)
   pairs with device index ops and launches the kernel per chunk,
   concatenates a submit's outputs and copies them back in one transfer;
4. at drain, scatters raw f32 probabilities back to per-job read-major
   matrices and finalizes log10 likelihoods (sentinel or exact host float64
   rescue for underflowed pairs, cfg.f64_rescue).

This is the GPU counterpart of gatk_hc_tpu/ops/runner.py::
PallasPairHMMRunner on its planes and striped paths, and of the
reference's flat testcase batch + OpenMP loop (intel_pairhmm.hpp:115-203).
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import HCConfig
from ..utils.quality import INITIAL_CONSTANT_F32

ReadArray = Tuple[np.ndarray, np.ndarray]  # (bases u8, quals u8)

STAGES = ("pack", "h2d", "gather", "kernel", "d2h", "finalize")


@dataclasses.dataclass
class PairHMMJob:
    """One region's likelihood request.

    Every read and haplotype must be non-empty (the pipeline's
    min_read_length_after_trimming filter guarantees this on the production
    path; the check makes the public API safe too — a zero-length row would
    otherwise hit the underflow-rescue path with an undefined likelihood).

    NOTE on ``result``: under the default cfg.f64_rescue="sentinel", entries
    whose f32 forward probability underflowed MIN_ACCEPTED hold
    RESCUE_SENTINEL_LOG10 (-100.0) instead of the reference's exact f64
    recompute.  This is provably VCF-neutral through normalize_and_filter,
    but any NEW consumer of raw likelihoods (annotations, QUAL refinement)
    must either tolerate sentinels below -64.1 or run with
    f64_rescue="exact".
    """

    reads: Sequence[ReadArray]
    haps: Sequence[np.ndarray]
    # filled by the runner: read-major log10 matrix (n_reads, n_haps).
    # CAVEAT: with cfg.f64_rescue="sentinel" (default), underflowed entries
    # hold RESCUE_SENTINEL_LOG10 (-100.0), not exact values — see the class
    # docstring before consuming raw likelihoods downstream.
    result: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        off = getattr(self.reads, "off", None)
        if off is not None:  # columnar ReadPairs: vectorized check (the
            # cached .lengths diff is reused by group packing later)
            reads_ok = len(off) < 2 or int(self.reads.lengths.min()) > 0
        else:
            reads_ok = all(len(b) for b, _ in self.reads)
        if not reads_ok or any(len(h) == 0 for h in self.haps):
            raise ValueError("PairHMMJob rows must be non-empty")


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")


class _Stamp:
    """A point in a stage timeline: a CUDA event on the runner's stream, or
    a host clock reading on the CPU path (where every step is synchronous)."""

    __slots__ = ("event", "t")

    def __init__(self, stream):
        if stream is None:
            self.event, self.t = None, time.perf_counter()
        else:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(stream)

    def ms_until(self, other: "_Stamp") -> float:
        if self.event is None:
            return (other.t - self.t) * 1e3
        return self.event.elapsed_time(other.event)


@dataclasses.dataclass
class _Group:
    spans: List[Tuple[int, int, int, int]]  # (job, start, nr, nh)
    start: int  # offset of the group's pairs in the submit's output
    total: int
    pack_ms: float
    h2d: Tuple[_Stamp, _Stamp]
    chunks: List[Tuple[_Stamp, _Stamp, _Stamp]]  # gather start, launch, end


@dataclasses.dataclass
class _Batch:
    jobs: Sequence[PairHMMJob]
    groups: List[_Group]
    host_out: torch.Tensor  # (n_pairs,) f32, pinned on the CUDA path
    d2h: Optional[Tuple[_Stamp, _Stamp]]


class TorchPairHMMRunner:
    """Batches PairHMMJobs into PairHMM kernel launches on one device: the
    ppe kernel, or the striped one when cfg.pallas_algo is "striped".

    ``device`` is "cuda" (the default: the CUDA kernel; raises when no card
    is visible) or "cpu" (the same packing, gather and finalize around the
    kernel's plain PyTorch version — what the tests run).  ``tables``
    replaces the numeric tables (ops/pairhmm_torch.py::make_tables layout,
    e.g. from convert.tables_from_reference)."""

    # Grouping limits.  One group is one launch unless a single job
    # overflows the pair budget, which is then also the most pairs of one
    # launch (a chunk).  A group of 65,536 pairs runs 65,536
    # threads (512 blocks of 128, ~3.9 per SM on an H100's 132 SMs), all
    # resident at once at every NR: the kernel uses 48-96 registers a
    # thread, and even at 96 an SM holds 5 such blocks.  At 30x coverage a
    # region contributes ~300 pairs from ~80 reads, so the read and hap
    # budgets below do not cut groups short first.
    READ_BUCKETS = (4096, 16384)
    HAP_BUCKETS = (1024, 4096)
    GROUP_PAIRS = 65536
    ROW_ALIGN = 8  # ppe: r_pad past the buckets rounds to the largest NR

    def __init__(self, cfg: HCConfig, device="cuda",
                 pair_budget: Optional[int] = None, tables=None):
        from .pairhmm_torch import make_tables

        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchPairHMMRunner: no CUDA device is available "
                    "(pass device='cpu' to run the kernel's plain version)"
                )
            self._stream = torch.cuda.Stream(self.device)
        elif self.device.type == "cpu":
            self._stream = None
        else:
            raise ValueError(f"unsupported device {self.device}")
        self.cfg = cfg
        if tables is None:
            tables = make_tables(cfg, "cpu")
        host = {k: v.cpu().numpy() for k, v in tables.items()}
        self._mask_tab = host["mask"]
        self._omq_bits_tab = host["omq_bits"]
        self._q3_bits_tab = host["q3_bits"]
        self.trans = tuple(np.float32(t) for t in host["trans"])
        self.striped = cfg.pallas_algo == "striped"
        if self.striped:
            from .pairhmm_striped import striped_tables

            # byte -> code, Phred -> 1 - q, Phred -> q / 3, on the device
            self._striped_tabs = tuple(
                torch.from_numpy(t).to(self.device)
                for t in striped_tables(host["base_table"], host["ph2pr"])
            )
        self.pair_budget = pair_budget or self.GROUP_PAIRS
        # launches by path, surfaced as dispatch_profile in --stats
        self.dispatch_counts: Dict[str, int] = {}
        # per-group (per-submit for d2h) stage times in ms
        self.stage_ms: Dict[str, List[float]] = {s: [] for s in STAGES}

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[PairHMMJob]) -> None:
        """Compute results for all jobs in-place (submit + drain)."""
        self.drain([self.submit(jobs)])

    def submit(self, jobs: Sequence[PairHMMJob]) -> _Batch:
        """Pack every group on the host and enqueue its device work without
        waiting: one H2D copy and one launch per chunk per group, then one
        concatenated D2H copy for the whole submit.  Pass the token to
        drain() to collect."""
        groups: List[_Group] = []
        outs: List[torch.Tensor] = []
        start = 0
        stream = self._stream
        ctx = torch.cuda.stream(stream) if stream is not None else nullcontext()
        with ctx:
            for group in self._plan_groups(jobs):
                g, g_outs = self._submit_group(jobs, group, start)
                groups.append(g)
                outs.extend(g_outs)
                start += g.total
            if not outs:
                return _Batch(jobs, groups, torch.zeros(0), None)
            dev_out = outs[0] if len(outs) == 1 else torch.cat(outs)
            if stream is None:
                return _Batch(jobs, groups, dev_out, None)
            host_out = torch.empty(
                dev_out.shape, dtype=torch.float32, pin_memory=True
            )
            d0 = _Stamp(stream)
            host_out.copy_(dev_out, non_blocking=True)
            d1 = _Stamp(stream)
        return _Batch(jobs, groups, host_out, (d0, d1))

    def drain(self, batches: Sequence[_Batch]) -> None:
        """Wait for each batch's transfer back, then finalize its groups."""
        for batch in batches:
            if batch.d2h is not None:
                batch.d2h[1].event.synchronize()
                self.stage_ms["d2h"].append(batch.d2h[0].ms_until(batch.d2h[1]))
            probs = batch.host_out.numpy()
            for g in batch.groups:
                t0 = time.perf_counter()
                self._finalize_group(
                    batch.jobs, probs[g.start : g.start + g.total], g.spans
                )
                self.stage_ms["finalize"].append((time.perf_counter() - t0) * 1e3)
                self.stage_ms["pack"].append(g.pack_ms)
                self.stage_ms["h2d"].append(g.h2d[0].ms_until(g.h2d[1]))
                self.stage_ms["gather"].append(
                    sum(a.ms_until(b) for a, b, _ in g.chunks)
                )
                self.stage_ms["kernel"].append(
                    sum(b.ms_until(c) for _, b, c in g.chunks)
                )

    def stage_medians(self) -> Dict[str, object]:
        """Median ms per group of each stage (d2h: per submit), the summed
        ms of each stage, and the device the times were taken on."""
        out: Dict[str, object] = {
            s: round(statistics.median(v), 4)
            for s, v in self.stage_ms.items()
            if v
        }
        out["sum_ms"] = {
            s: round(sum(v), 3) for s, v in self.stage_ms.items() if v
        }
        out["groups"] = len(self.stage_ms["pack"])
        out["device"] = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda"
            else "cpu"
        )
        return out

    # ------------------------------------------------------------------
    def _round_rows(self, r: int) -> int:
        # striped: a multiple of the stripe height, which then divides r_pad
        a = self.cfg.stripe_height if self.striped else self.ROW_ALIGN
        return ((r + a - 1) // a) * a

    def _pads_for_group(self, jobs, group):
        """Per-group padded shapes: tightest bucket over the group's actual
        lengths (fewer wasted cells than one global shape)."""
        max_r = max(
            (
                jobs[g].reads.max_len
                if hasattr(jobs[g].reads, "max_len")
                else max((len(b) for b, _ in jobs[g].reads), default=1)
            )
            for g in group
        ) if group else 1
        max_r = max(max_r, 1)
        max_c = max((len(h) for g in group for h in jobs[g].haps), default=1)
        r_pad = next(
            (b for b in self.cfg.read_pad_buckets if max_r <= b),
            self._round_rows(max_r),
        )
        r_pad = self._round_rows(r_pad)
        c_pad = next(
            (b for b in self.cfg.hap_pad_buckets if max_c <= b),
            ((max_c + 127) // 128) * 128,
        )
        return r_pad, c_pad

    def _plan_groups(self, jobs: Sequence[PairHMMJob]) -> List[List[int]]:
        groups: List[List[int]] = []
        current: List[int] = []
        pairs = reads = haps = 0
        for idx, job in enumerate(jobs):
            jp = len(job.reads) * len(job.haps)
            if jp == 0:
                job.result = np.zeros((len(job.reads), len(job.haps)))
                continue
            if jp > self.pair_budget:
                # oversized region: its own group (multiple launches inside)
                if current:
                    groups.append(current)
                    current, pairs, reads, haps = [], 0, 0, 0
                groups.append([idx])
                continue
            if (
                current
                and (
                    pairs + jp > self.pair_budget
                    or reads + len(job.reads) > self.READ_BUCKETS[-1]
                    or haps + len(job.haps) > self.HAP_BUCKETS[-1]
                )
            ):
                groups.append(current)
                current, pairs, reads, haps = [], 0, 0, 0
            current.append(idx)
            pairs += jp
            reads += len(job.reads)
            haps += len(job.haps)
        if current:
            groups.append(current)
        return groups

    def _submit_group(self, jobs: Sequence[PairHMMJob], group: List[int],
                      start: int):
        # pairhmm_planes' two halves, inlined so each is timed
        from .pairhmm_torch import gather_pairs, ppe_forward

        t_pack = time.perf_counter()
        r_pad, c_pad = self._pads_for_group(jobs, group)
        n_reads = sum(len(jobs[g].reads) for g in group)
        n_haps = sum(len(jobs[g].haps) for g in group)
        nr_pad = _bucket(n_reads, self.READ_BUCKETS)
        nh_pad = _bucket(n_haps, self.HAP_BUCKETS)

        def pack_rows(seq_lists, n_pad, w_pad):
            """Vectorized fill of (n_pad, w_pad) row tables from variable-
            length uint8 arrays (a python per-row loop costs ~1.5us/row).
            Rows are non-empty (PairHMMJob validates); padding rows default
            to length 1."""
            clipped = [s[:w_pad] for s in seq_lists]
            lens = np.fromiter(
                (len(s) for s in clipped), dtype=np.int64, count=len(clipped)
            )
            starts = np.arange(len(clipped), dtype=np.int64) * w_pad
            within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            pos = np.repeat(starts, lens) + within
            out_lens = np.ones(n_pad, dtype=np.int32)
            out_lens[: len(clipped)] = lens.astype(np.int32)
            return pos, clipped, out_lens

        # Per-JOB read collection: columnar ReadPairs jobs contribute their
        # whole flat CSR buffers (no per-read views), generic tuple-list
        # jobs stay per-read.  No clipping is needed on this side:
        # _pads_for_group sizes r_pad from the group's max read length.
        len_parts: List[np.ndarray] = []
        seq_parts: List[np.ndarray] = []
        qual_parts: List[np.ndarray] = []
        for g in group:
            r = jobs[g].reads
            if hasattr(r, "flat_seq"):
                nb = int(r.off[-1])
                len_parts.append(np.asarray(r.lengths, dtype=np.int64))
                seq_parts.append(r.flat_seq[:nb])
                qual_parts.append(r.flat_qual[:nb])
            else:
                len_parts.append(np.fromiter(
                    (len(b) for b, _ in r), dtype=np.int64, count=len(r)
                ))
                seq_parts.extend(b for b, _ in r)
                qual_parts.extend(q for _, q in r)
        lens = (
            np.concatenate(len_parts)
            if len_parts
            else np.zeros(0, dtype=np.int64)
        )
        starts = np.arange(lens.size, dtype=np.int64) * r_pad
        within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        rpos = np.repeat(starts, lens) + within
        read_lens = np.ones(nr_pad, dtype=np.int32)
        read_lens[: lens.size] = lens.astype(np.int32)

        haps_flat = [h for g in group for h in jobs[g].haps]
        hpos, hclip, hap_lens = pack_rows(haps_flat, nh_pad, c_pad)
        read_u8 = np.zeros(nr_pad * r_pad, dtype=np.uint8)
        qual_u8 = np.zeros(nr_pad * r_pad, dtype=np.uint8)
        hap_u8 = np.zeros(nh_pad * c_pad, dtype=np.uint8)
        if lens.size:
            read_u8[rpos] = (
                seq_parts[0] if len(seq_parts) == 1
                else np.concatenate(seq_parts)
            )
            qual_u8[rpos] = (
                qual_parts[0] if len(qual_parts) == 1
                else np.concatenate(qual_parts)
            )
        if haps_flat:
            hap_u8[hpos] = np.concatenate(hclip)
        hap_init_y = (
            INITIAL_CONSTANT_F32 / hap_lens.astype(np.float32)
        ).astype(np.float32)

        # pair lists (read-major per job, jobs in group order), vectorized
        spans: List[Tuple[int, int, int, int]] = []  # (job, start, nr, nh)
        pr_parts: List[np.ndarray] = []
        ph_parts: List[np.ndarray] = []
        total = rb = hb = 0
        for g in group:
            nr, nh = len(jobs[g].reads), len(jobs[g].haps)
            spans.append((g, total, nr, nh))
            pr_parts.append(
                np.repeat(np.arange(rb, rb + nr, dtype=np.int32), nh)
            )
            ph_parts.append(
                np.tile(np.arange(hb, hb + nh, dtype=np.int32), nr)
            )
            total += nr * nh
            rb += nr
            hb += nh

        if self.striped:
            return self._submit_striped(
                read_u8, qual_u8, hap_u8, read_lens, hap_lens, hap_init_y,
                pr_parts, ph_parts, spans, start, total, t_pack,
                (nr_pad, nh_pad, r_pad, c_pad),
            )

        # one host buffer: [planes | pair reads | pair haps], pinned for an
        # asynchronous copy on the CUDA path
        n_planes = nr_pad + 2 * nh_pad + 3 * nr_pad * r_pad + nh_pad * c_pad
        cuda = self._stream is not None
        host = torch.empty(n_planes + 2 * total, dtype=torch.int32,
                           pin_memory=cuda)
        host_np = host.numpy()
        self._build_planes(
            read_u8, qual_u8, hap_u8, read_lens, hap_lens, hap_init_y,
            nr_pad, nh_pad, r_pad, c_pad, out=host_np[:n_planes],
        )
        host_np[n_planes : n_planes + total] = np.concatenate(pr_parts)
        host_np[n_planes + total :] = np.concatenate(ph_parts)
        pack_ms = (time.perf_counter() - t_pack) * 1e3

        h0 = _Stamp(self._stream)
        dev = host.to(self.device, non_blocking=True) if cuda else host
        h1 = _Stamp(self._stream)
        buf = dev[:n_planes]
        pairs = dev[n_planes:].view(2, total)
        outs, chunks = [], []
        for off in range(0, total, self.pair_budget):
            size = min(self.pair_budget, total - off)
            s0 = _Stamp(self._stream)
            args = gather_pairs(
                buf, pairs[:, off : off + size], nr_pad, nh_pad, r_pad, c_pad
            )
            s1 = _Stamp(self._stream)
            outs.append(ppe_forward(*args, self.trans, self.cfg.ppe_rows))
            chunks.append((s0, s1, _Stamp(self._stream)))
            self.dispatch_counts["planes"] = (
                self.dispatch_counts.get("planes", 0) + 1
            )
        return _Group(spans, start, total, pack_ms, (h0, h1), chunks), outs

    def _submit_striped(self, read_u8, qual_u8, hap_u8, read_lens, hap_lens,
                        hap_init_y, pr_parts, ph_parts, spans, start, total,
                        t_pack, pads):
        """The striped kernel's shipping path (the counterpart of the
        reference runner's raw-byte branch): one host buffer
        [reads | quals | haps] uint8, padded to 4 bytes, then
        [read lens | hap lens | init_y bits | pair reads | pair haps] i32;
        one copy to the card; the base and Phred tables applied there once
        per group; a pair gather and a striped launch per chunk."""
        from .pairhmm_striped import (
            gather_pairs_striped, prepare_tables_striped, striped_forward,
        )

        nr_pad, nh_pad, r_pad, c_pad = pads
        nrr = nr_pad * r_pad
        n_u8 = 2 * nrr + nh_pad * c_pad
        i32_at = (n_u8 + 3) // 4 * 4
        head = nr_pad + 2 * nh_pad
        cuda = self._stream is not None
        host = torch.empty(i32_at + 4 * (head + 2 * total), dtype=torch.uint8,
                           pin_memory=cuda)
        host_np = host.numpy()
        host_np[:nrr] = read_u8
        host_np[nrr : 2 * nrr] = qual_u8
        host_np[2 * nrr : n_u8] = hap_u8
        ints = host_np[i32_at:].view(np.int32)
        ints[:nr_pad] = read_lens
        ints[nr_pad : nr_pad + nh_pad] = hap_lens
        ints[nr_pad + nh_pad : head] = hap_init_y.view(np.int32)
        ints[head : head + total] = np.concatenate(pr_parts)
        ints[head + total :] = np.concatenate(ph_parts)
        pack_ms = (time.perf_counter() - t_pack) * 1e3

        h0 = _Stamp(self._stream)
        dev = host.to(self.device, non_blocking=True) if cuda else host
        h1 = _Stamp(self._stream)
        u8buf = dev[:n_u8]
        i32buf = dev[i32_at:].view(torch.int32)
        pairs = i32buf[head:].view(2, total)
        tables = None
        outs, chunks = [], []
        for off in range(0, total, self.pair_budget):
            size = min(self.pair_budget, total - off)
            s0 = _Stamp(self._stream)
            if tables is None:  # once per group, timed with the gather
                tables = prepare_tables_striped(
                    u8buf, i32buf, *self._striped_tabs,
                    nr_pad, nh_pad, r_pad, c_pad,
                )
            args = gather_pairs_striped(*tables, pairs[:, off : off + size])
            s1 = _Stamp(self._stream)
            outs.append(
                striped_forward(*args, self.trans, self.cfg.stripe_height)
            )
            chunks.append((s0, s1, _Stamp(self._stream)))
            self.dispatch_counts["striped"] = (
                self.dispatch_counts.get("striped", 0) + 1
            )
        return _Group(spans, start, total, pack_ms, (h0, h1), chunks), outs

    def _build_planes(self, read_u8, qual_u8, hap_u8, read_lens, hap_lens,
                      hap_init_y, nr_pad, nh_pad, r_pad, c_pad, out=None):
        """Host-side plane buffer for pairhmm_planes:
        [rlens | hlens | iy bits | read masks | omq bits | q3 bits | hap
        masks], all int32."""
        nrr = nr_pad * r_pad
        head = nr_pad + 2 * nh_pad
        size = head + 3 * nrr + nh_pad * c_pad
        buf = np.empty(size, np.int32) if out is None else out
        assert buf.shape == (size,) and buf.dtype == np.int32
        buf[:nr_pad] = read_lens
        buf[nr_pad : nr_pad + nh_pad] = hap_lens
        buf[nr_pad + nh_pad : head] = hap_init_y.view(np.int32)
        np.take(self._mask_tab, read_u8, out=buf[head : head + nrr])
        np.take(self._omq_bits_tab, qual_u8, out=buf[head + nrr : head + 2 * nrr])
        np.take(self._q3_bits_tab, qual_u8, out=buf[head + 2 * nrr : head + 3 * nrr])
        np.take(self._mask_tab, hap_u8, out=buf[head + 3 * nrr :])
        return buf

    def _finalize_group(self, jobs, probs, spans) -> None:
        # scatter back + finalize with f64 rescue
        from .pairhmm_oracle import finalize_log10

        for g, start, nr, nh in spans:
            job = jobs[g]
            raw = probs[start : start + nr * nh]

            def rescue(indices, job=job, nh=nh):
                from .pairhmm_torch import _host_f64_rescue

                local_read = (indices // nh).astype(np.int64)
                local_hap = (indices % nh).astype(np.int64)
                return _host_f64_rescue(
                    self.cfg, list(job.reads), list(job.haps),
                    local_read, local_hap,
                )

            job.result = finalize_log10(
                raw, rescue, mode=self.cfg.f64_rescue
            ).reshape(nr, nh)


def torch_pairhmm_engine(cfg: HCConfig, device="cuda"):
    """Per-region engine: a single-job run through the batched runner
    (call_batched's cross-region batching is the production path)."""
    from .engines import _to_arrays

    runner = TorchPairHMMRunner(cfg, device=device)

    def engine(reads, haplotypes):
        read_arrays, hap_arrays = _to_arrays(reads, haplotypes)
        job = PairHMMJob(read_arrays, hap_arrays)
        runner.run([job])
        return job.result

    return engine


class NativePairHMMRunner:
    """CPU batch runner over the C++ PairHMM engine — same job interface and
    exact semantics (f32 + FTZ with f64 rescue below MIN_ACCEPTED) as the
    CUDA runner, for call_batched with cfg.pairhmm_engine == 'native'.

    Jobs fan out over a host thread pool (cfg.host_threads, 0 = one per
    CPU): the C++ compute releases the GIL, so this is the CPU-engine
    equivalent of the reference's OpenMP `parallel for` over testcases
    (intel_pairhmm.hpp:128-131).  Each job's result is written to its own
    slot, so scheduling cannot affect output."""

    def __init__(self, cfg: HCConfig):
        self.cfg = cfg

    def run(self, jobs: Sequence[PairHMMJob]) -> None:
        n_workers = (
            self.cfg.host_threads
            if self.cfg.host_threads > 0
            else (os.cpu_count() or 1)
        )
        if n_workers > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(n_workers) as pool:
                list(pool.map(self._run_one, jobs))
        else:
            for job in jobs:
                self._run_one(job)

    def _run_one(self, job: PairHMMJob) -> None:
        from .. import native
        from .pairhmm_oracle import finalize_log10

        gop, gcp = self.cfg.gop_char, self.cfg.gcp_char
        nr, nh = len(job.reads), len(job.haps)
        if nr * nh == 0:
            job.result = np.zeros((nr, nh))
            return
        r_stride = max(len(b) for b, _ in job.reads)
        rb = np.zeros((nr, r_stride), dtype=np.uint8)
        rq = np.zeros((nr, r_stride), dtype=np.uint8)
        rl = np.zeros(nr, dtype=np.int32)
        for i, (b, q) in enumerate(job.reads):
            rb[i, : len(b)] = b
            rq[i, : len(q)] = q
            rl[i] = len(b)
        h_stride = max(len(h) for h in job.haps)
        hb = np.zeros((nh, h_stride), dtype=np.uint8)
        hl = np.zeros(nh, dtype=np.int32)
        for i, h in enumerate(job.haps):
            hb[i, : len(h)] = h
            hl[i] = len(h)
        pr = np.repeat(np.arange(nr, dtype=np.int32), nh)
        ph = np.tile(np.arange(nh, dtype=np.int32), nr)
        raw = native.pairhmm_raw_native(rb, rq, rl, hb, hl, pr, ph, gop, gcp)

        def rescue(indices, pr=pr, ph=ph):
            return native.pairhmm_raw_native(
                rb, rq, rl, hb, hl,
                pr[indices], ph[indices], gop, gcp, dtype=np.float64,
            )

        job.result = finalize_log10(
            raw, rescue, mode=self.cfg.f64_rescue
        ).reshape(nr, nh)
