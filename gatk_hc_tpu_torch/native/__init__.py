"""ctypes bindings for the C++ host runtime (libhcnative.so).

Built at first use, or with ``python -m gatk_hc_tpu_torch.native.build``.
Every native function has a pure-Python fallback in the package, and the
test suite differential-checks the two.  The library is loaded with
ctypes' default RTLD_LOCAL, so its symbols and tables stay apart from any
other copy of it in the same process.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libhcnative.so")
_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()  # one build and load when threads race


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                from .build import build

                build()  # a no-op unless the library is missing or older
                # than its source
                lib = ctypes.CDLL(_LIB_PATH)
                _configure(lib)
                _push_tables(lib)
                _lib = lib
    return _lib


def _push_tables(lib: ctypes.CDLL) -> None:
    """Overwrite native tables with the numpy-computed ones so every engine
    shares bit-identical numeric context."""
    from ..utils import quality as Q

    c = lambda a, t: np.ascontiguousarray(a).ctypes.data_as(ctypes.POINTER(t))
    lib.hc_load_tables(
        c(Q.PH2PR_F32, ctypes.c_float), c(Q.PH2PR_F64, ctypes.c_double),
        c(Q.MATCH_TO_MATCH_F32, ctypes.c_float),
        c(Q.MATCH_TO_MATCH_F64, ctypes.c_double),
        c(Q.JACOBIAN_F32, ctypes.c_float), c(Q.JACOBIAN_F64, ctypes.c_double),
    )


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)

    lib.hc_sw_align.restype = ctypes.c_int32
    lib.hc_sw_align.argtypes = [
        u8p, ctypes.c_int32,  # ref
        u8p, ctypes.c_int32,  # alt
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # params
        ctypes.c_int32,  # max mismatches for all-match fast path
        ctypes.c_char_p, ctypes.c_int32,  # cigar out buffer
        i32p,  # alignment offset out
    ]

    lib.hc_pairhmm_f32.restype = None
    lib.hc_pairhmm_f32.argtypes = [
        u8p, u8p, i32p, ctypes.c_int32,  # reads, quals, lens, stride
        u8p, i32p, ctypes.c_int32,  # haps, lens, stride
        i32p, i32p, ctypes.c_int64,  # pair indices
        ctypes.c_int32, ctypes.c_int32,  # gop, gcp
        f32p,  # out raw f32 probs
    ]
    lib.hc_pairhmm_f64.restype = None
    lib.hc_pairhmm_f64.argtypes = list(lib.hc_pairhmm_f32.argtypes[:-1]) + [f64p]

    lib.hc_assemble.restype = ctypes.c_int32
    lib.hc_assemble.argtypes = [
        u8p, ctypes.c_int64,  # ref
        u8p, u8p, i64p, ctypes.c_int32,  # read seqs, quals, offsets, n_reads
        i32p,  # config ints
        u8p, ctypes.c_int64,  # out hap bases arena
        i64p,  # out hap offsets (n+1)
        f64p,  # out scores
        ctypes.c_int32,  # max haplotypes
    ]

    lib.hc_assemble_sw.restype = ctypes.c_int32
    lib.hc_assemble_sw.argtypes = [
        u8p, ctypes.c_int64,  # ref
        u8p, u8p, i64p, ctypes.c_int32,  # read seqs, quals, offsets, n_reads
        i32p, i32p,  # assembler config ints, SW config ints
        u8p, ctypes.c_int64,  # out hap bases arena
        i64p,  # out hap offsets (n+1)
        f64p,  # out scores
        ctypes.c_int32,  # max haplotypes
        i32p,  # out per-hap alignment offsets
        u8p, i32p, i64p,  # out cigar ops/lens arenas + offsets (n+1)
        ctypes.c_int64,  # cigar arena capacity (elements)
    ]

    lib.hc_prepare_assemble_sw.restype = ctypes.c_int32
    lib.hc_prepare_assemble_sw.argtypes = [
        i32p, i32p, i32p, u8p,  # pos, flag, mapq, rnext_eq
        i64p, u8p, i32p,  # cigar offsets/ops/lens
        i64p, u8p, u8p,  # seq offsets, seq, qual
        i64p, ctypes.c_int32,  # selected store rows, count
        ctypes.c_int32, ctypes.c_int32,  # min_mapq, min_len
        ctypes.c_int64, ctypes.c_int64,  # window begin/end
        u8p, u8p, i64p,  # out seq/qual blobs + CSR offsets
        i64p, i64p,  # out alignment begin/end
        i32p,  # out kept-read count
        u8p, ctypes.c_int64,  # window ref
        i32p, i32p,  # assembler config ints, SW config ints
        u8p, ctypes.c_int64,  # out hap bases arena
        i64p,  # out hap offsets (n+1)
        f64p,  # out scores
        ctypes.c_int32,  # max haplotypes
        i32p,  # out per-hap alignment offsets
        u8p, i32p, i64p,  # out cigar ops/lens arenas + offsets
        ctypes.c_int64,  # cigar arena capacity
    ]

    lib.hc_fused_run.restype = ctypes.c_int32
    lib.hc_fused_run.argtypes = [i64p]

    lib.hc_prof_read.restype = None
    lib.hc_prof_read.argtypes = [i64p, ctypes.c_int32]

    lib.hc_load_tables.restype = None
    lib.hc_load_tables.argtypes = [f32p, f64p, f32p, f64p, f32p, f64p]
    lib.hc_table_probe.restype = None
    lib.hc_table_probe.argtypes = [f32p, f64p, f32p, f64p, f32p, f64p]

    lib.hc_sam_scan.restype = None
    lib.hc_sam_scan.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p]
    lib.hc_sam_parse.restype = ctypes.c_int64
    lib.hc_sam_parse.argtypes = [
        u8p, ctypes.c_int64,  # SAM text
        u8p, i64p, ctypes.c_int32,  # contig names blob/offsets/count
        i32p, i32p, i32p, u8p, i32p,  # pos, flag, mapq, rnext_eq, rname_id
        i64p, u8p, i32p,  # cigar offsets/ops/lens
        i64p, u8p, u8p,  # seq offsets, seq, qual
    ]
    lib.hc_sam_parse_mt.restype = ctypes.c_int64
    lib.hc_sam_parse_mt.argtypes = [
        u8p, ctypes.c_int64,  # SAM text
        u8p, i64p, ctypes.c_int32,  # contig names blob/offsets/count
        ctypes.c_int32,  # worker threads
        i32p, i32p, i32p, u8p, i32p,  # pos, flag, mapq, rnext_eq, rname_id
        i64p, u8p, i32p,  # cigar offsets/ops/lens
        i64p, u8p, u8p,  # seq offsets, seq, qual
    ]
    lib.hc_sam_scan_ranges.restype = None
    lib.hc_sam_scan_ranges.argtypes = [
        u8p, ctypes.c_int64,  # SAM text
        u8p, i64p, ctypes.c_int32,  # contig names blob/offsets/count
        i64p, i64p,  # keep_lo/keep_hi per contig
        i64p,  # out (n_contigs x 5) rows
    ]
    lib.hc_sam_scan_ranges_mt.restype = None
    lib.hc_sam_scan_ranges_mt.argtypes = list(
        lib.hc_sam_scan_ranges.argtypes[:-1]
    ) + [ctypes.c_int32, i64p]  # worker threads, out rows
    lib.hc_sam_parse_ranges.restype = ctypes.c_int64
    lib.hc_sam_parse_ranges.argtypes = [
        u8p, ctypes.c_int64,  # SAM text (slice)
        u8p, i64p, ctypes.c_int32,  # contig names blob/offsets/count
        i64p, i64p,  # keep_lo/keep_hi per contig
        i32p, i32p, i32p, u8p, i32p,  # pos, flag, mapq, rnext_eq, rname_id
        i64p, u8p, i32p,  # cigar offsets/ops/lens
        i64p, u8p, u8p,  # seq offsets, seq, qual
    ]
    lib.hc_sam_parse_ranges_mt.restype = ctypes.c_int64
    lib.hc_sam_parse_ranges_mt.argtypes = (
        list(lib.hc_sam_parse_ranges.argtypes[:7])
        + [ctypes.c_int32]  # worker threads
        + list(lib.hc_sam_parse_ranges.argtypes[7:])
    )
    vp = ctypes.c_void_p
    lib.hc_pack_dict.restype = ctypes.c_int32
    lib.hc_pack_dict.argtypes = [
        vp, ctypes.c_int32, vp,  # jobs, count, read lengths
        vp, vp,  # out dictionaries, out byte -> index tables
    ]
    lib.hc_pack_rows.restype = ctypes.c_int32
    lib.hc_pack_rows.argtypes = [
        vp, ctypes.c_int32, vp,  # jobs, count, read lengths
        ctypes.c_int32, ctypes.c_int32,  # nr_pad, r_pad
        vp, vp,  # haps end to end, their lengths
        ctypes.c_int32, ctypes.c_int32,  # nh_pad, c_pad
        ctypes.c_int32, vp,  # encoding, its table
        vp, vp, vp, ctypes.c_int64,  # out reads, haps, pairs (or None), total
    ]

    lib.hc_prepare_window.restype = ctypes.c_int32
    lib.hc_prepare_window.argtypes = [
        i32p, i32p, i32p, u8p,  # pos, flag, mapq, rnext_eq
        i64p, u8p, i32p,  # cigar offsets/ops/lens
        i64p, u8p, u8p,  # seq offsets, seq, qual
        i64p, ctypes.c_int32,  # selected store rows, count
        ctypes.c_int32, ctypes.c_int32,  # min_mapq, min_len
        ctypes.c_int64, ctypes.c_int64,  # window begin/end
        u8p, u8p, i64p,  # out seq/qual blobs + CSR offsets
        i64p, i64p,  # out alignment begin/end
    ]


# ---------------------------------------------------------------------------
# Public wrappers


def sw_align_native(ref: str, alt: str, params, max_mismatches: int = 2):
    from ..utils.cigar import parse_cigar

    lib = _load()
    ref_b = np.frombuffer(ref.encode(), dtype=np.uint8)
    alt_b = np.frombuffer(alt.encode(), dtype=np.uint8)
    buf = ctypes.create_string_buffer(2 * max(len(ref), len(alt)) + 16)
    offset = ctypes.c_int32(0)
    rc = lib.hc_sw_align(
        ref_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(ref_b),
        alt_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(alt_b),
        params.w_match, params.w_mismatch, params.w_open, params.w_extend,
        max_mismatches,
        buf, len(buf),
        ctypes.byref(offset),
    )
    if rc != 0:
        raise RuntimeError(f"hc_sw_align failed with rc={rc}")
    return int(offset.value), parse_cigar(buf.value.decode())


def pairhmm_raw_native(
    read_bases: np.ndarray,  # (n_reads, read_stride) uint8, 0-padded
    read_quals: np.ndarray,
    read_lens: np.ndarray,  # (n_reads,) int32
    hap_bases: np.ndarray,  # (n_haps, hap_stride) uint8
    hap_lens: np.ndarray,
    pair_read: np.ndarray,  # (n_pairs,) int32
    pair_hap: np.ndarray,
    gop: int,
    gcp: int,
    dtype=np.float32,
) -> np.ndarray:
    lib = _load()
    n_pairs = len(pair_read)
    out = np.zeros(n_pairs, dtype=dtype)
    fn = lib.hc_pairhmm_f32 if dtype == np.float32 else lib.hc_pairhmm_f64
    cptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    fn(
        cptr(read_bases, ctypes.c_uint8), cptr(read_quals, ctypes.c_uint8),
        cptr(read_lens, ctypes.c_int32), read_bases.shape[1],
        cptr(hap_bases, ctypes.c_uint8), cptr(hap_lens, ctypes.c_int32),
        hap_bases.shape[1],
        cptr(pair_read, ctypes.c_int32), cptr(pair_hap, ctypes.c_int32), n_pairs,
        gop, gcp,
        cptr(out, ctypes.c_float if dtype == np.float32 else ctypes.c_double),
    )
    return out


# hc_pack_rows' encodings
PACK_ENCODINGS = {"bytes": 0, "nib": 1, "planes": 2}


def _check_pack_reads(jobs: np.ndarray, read_lens: np.ndarray) -> None:
    """The job table and read lengths hc_pack_* walk: (n_jobs, 4) int64
    rows whose read counts sum to the lengths given (int64)."""
    if not (jobs.dtype == np.int64 and jobs.ndim == 2 and jobs.shape[1] == 4
            and jobs.flags.c_contiguous and read_lens.dtype == np.int64
            and read_lens.flags.c_contiguous
            and read_lens.size == int(jobs[:, 2].sum())):
        raise ValueError("hc_pack: jobs must be (n, 4) int64 rows whose read "
                         "counts sum to the int64 read lengths given")


def _check_out(a: np.ndarray, dtype, size: int, name: str) -> None:
    if a.dtype != dtype or a.size != size or not a.flags.c_contiguous:
        raise ValueError(f"hc_pack: {name} must be {size} contiguous "
                         f"{np.dtype(dtype).name}")


def pack_dict(jobs: np.ndarray, read_lens: np.ndarray, dicts: np.ndarray,
              luts: np.ndarray) -> bool:
    """The nib dictionaries of a group's reads into ``dicts`` ((42,) i32:
    n_seq, n_qual, 8 seq bytes, 32 qual bytes) and ``luts`` ((512,) u8:
    byte -> index, seq then qual) -> False, writing nothing, when the
    alphabets overflow (seq > 8 or qual > 32 distinct bytes, byte 0
    included).  ``jobs``: (n_jobs, 4) int64 rows [bases address, quals
    address, reads, haps]; ``read_lens``: every read's length (int64)."""
    _check_pack_reads(jobs, read_lens)
    _check_out(dicts, np.int32, 42, "dicts")
    _check_out(luts, np.uint8, 512, "luts")
    return _load().hc_pack_dict(
        jobs.ctypes.data, len(jobs), read_lens.ctypes.data,
        dicts.ctypes.data, luts.ctypes.data) == 0


def pack_rows(jobs: np.ndarray, read_lens: np.ndarray, nr_pad: int,
              r_pad: int, hap_flat: np.ndarray, hap_lens: np.ndarray,
              nh_pad: int, c_pad: int, encoding: str,
              tab: Optional[np.ndarray], out_reads: np.ndarray,
              out_haps: np.ndarray, pairs: Optional[np.ndarray]) -> None:
    """One pass (GIL released) writes a group's padded read and hap rows
    in ``encoding`` (PACK_ENCODINGS; hc_pack_rows says what each writes
    and what ``tab`` holds) into ``out_reads`` and ``out_haps``, and, when
    given, its (2, total) pair indices into ``pairs``.  The pure-numpy
    counterpart is ops/torch_runner.py's ``_unique_rows`` and
    ``_pack_*``."""
    _check_pack_reads(jobs, read_lens)
    dtype, width, tab_want = {"bytes": (np.uint8, 2, None),
                              "nib": (np.uint8, 1, (np.uint8, 512)),
                              "planes": (np.int32, 3, (np.int32, 768))}[
                                  encoding]
    _check_out(out_reads, dtype, width * nr_pad * r_pad, "out_reads")
    _check_out(out_haps, dtype, nh_pad * c_pad, "out_haps")
    if tab_want is not None:
        _check_out(tab, *tab_want, "tab")
    if not (hap_lens.dtype == np.int64 and hap_lens.flags.c_contiguous
            and hap_flat.dtype == np.uint8 and hap_flat.flags.c_contiguous
            and hap_lens.size == int(jobs[:, 3].sum())
            and hap_flat.size == int(hap_lens.sum())):
        raise ValueError("hc_pack_rows: the haps must be u8 end to end, "
                         "their int64 lengths one a hap of the jobs")
    total = int((jobs[:, 2] * jobs[:, 3]).sum())
    if pairs is not None:
        _check_out(pairs, np.int32, 2 * total, "pairs")
    rc = _load().hc_pack_rows(
        jobs.ctypes.data, len(jobs), read_lens.ctypes.data, nr_pad, r_pad,
        hap_flat.ctypes.data, hap_lens.ctypes.data, nh_pad, c_pad,
        PACK_ENCODINGS[encoding],
        None if tab_want is None else tab.ctypes.data,
        out_reads.ctypes.data, out_haps.ctypes.data,
        None if pairs is None else pairs.ctypes.data, total)
    if rc != 0:
        raise ValueError("hc_pack_rows: a read is longer than r_pad, or the "
                         "rows do not fit the padded shape")


PROF_PHASES = (
    "segments_dups", "graph_build", "guards", "path_dfs",
    "score_reconstruct", "sw_align", "window_prep",
)


def profile_read(reset: bool = False):
    """Host-stage profile since process start (or the last reset): seconds
    per assembly phase plus the assembled-region count.  The per-phase
    attribution the reference never had (its rdtsc hooks are compile-time,
    PairWiseSW.h:111-119)."""
    lib = _load()
    out = np.zeros(12, dtype=np.int64)
    lib.hc_prof_read(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(1 if reset else 0),
    )
    result = {name: out[i] / 1e9 for i, name in enumerate(PROF_PHASES)}
    result["regions_assembled"] = int(out[7])
    # count slots (workload-attribution aid for the host wall):
    result["ladder_retries"] = int(out[8])
    result["sw_full_dp"] = int(out[9])
    result["sw_fast_path"] = int(out[10])
    result["sw_full_dp_cells"] = int(out[11])
    return result


def table_probe_native():
    """Return native-computed sample table values for bit-equality tests."""
    lib = _load()
    ph32 = np.zeros(128, dtype=np.float32)
    ph64 = np.zeros(128, dtype=np.float64)
    mm32 = np.zeros(((254 + 1) * (254 + 2)) // 2, dtype=np.float32)
    mm64 = np.zeros_like(mm32, dtype=np.float64)
    jac32 = np.zeros(80001, dtype=np.float32)
    jac64 = np.zeros(80001, dtype=np.float64)
    c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    lib.hc_table_probe(
        c(ph32, ctypes.c_float), c(ph64, ctypes.c_double),
        c(mm32, ctypes.c_float), c(mm64, ctypes.c_double),
        c(jac32, ctypes.c_float), c(jac64, ctypes.c_double),
    )
    return ph32, ph64, mm32, mm64, jac32, jac64


def _raise_assemble_error(fn_name: str, rc: int):
    """rc==-3 (path explosion) is the one per-region condition the caller
    may skip; -4 (SW failure) / -5 (cigar arena overflow) are internal bugs
    that must surface, not be silently dropped as region skips."""
    from ..models.assembler import PathExplosionError

    if rc == -3:
        raise PathExplosionError("assembly path explosion")
    raise RuntimeError(f"{fn_name} failed rc={rc}")


# ---------------------------------------------------------------------------
# Engine factories used by ops/engines.py


def _flatten_reads(reads):
    n = len(reads)
    stride = max((len(r) for r in reads), default=1)
    bases = np.zeros((n, stride), dtype=np.uint8)
    quals = np.zeros((n, stride), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, r in enumerate(reads):
        if hasattr(r, "seq_u8"):  # columnar PreparedRead: zero-copy arrays
            b, q = r.seq_u8, r.qual_u8
        else:
            b = np.frombuffer(r.seq.encode(), dtype=np.uint8)
            q = np.frombuffer(r.qual.encode(), dtype=np.uint8)
        bases[i, : len(b)] = b
        quals[i, : len(q)] = q
        lens[i] = len(b)
    return bases, quals, lens


def _flatten_haps(haps):
    n = len(haps)
    stride = max((len(h.bases) for h in haps), default=1)
    bases = np.zeros((n, stride), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, h in enumerate(haps):
        b = np.frombuffer(h.bases.encode(), dtype=np.uint8)
        bases[i, : len(b)] = b
        lens[i] = len(b)
    return bases, lens


def native_pairhmm_engine(cfg):
    from ..ops.pairhmm_oracle import finalize_log10

    def engine(reads, haplotypes):
        rb, rq, rl = _flatten_reads(reads)
        hb, hl = _flatten_haps(haplotypes)
        n_r, n_h = len(reads), len(haplotypes)
        pair_read = np.repeat(np.arange(n_r, dtype=np.int32), n_h)
        pair_hap = np.tile(np.arange(n_h, dtype=np.int32), n_r)
        probs = pairhmm_raw_native(
            rb, rq, rl, hb, hl, pair_read, pair_hap, cfg.gop_char, cfg.gcp_char
        )

        def rescue(indices):
            return pairhmm_raw_native(
                rb, rq, rl, hb, hl,
                pair_read[indices], pair_hap[indices],
                cfg.gop_char, cfg.gcp_char, np.float64,
            )

        return finalize_log10(
            probs, rescue, mode=cfg.f64_rescue
        ).reshape(n_r, n_h)

    return engine


def _assemble_cfg_ints(config) -> np.ndarray:
    return np.array(
        [
            config.initial_kmer_size,
            config.kmer_size_iteration_increase,
            config.max_kmer_iterations,
            config.max_unique_kmers_to_discard,
            config.prune_factor,
            config.min_base_quality_to_use,
            config.max_num_haplotypes,
        ],
        dtype=np.int32,
    )


def _flatten_read_blobs(reads):
    offsets = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in reads], out=offsets[1:])
    if reads and hasattr(reads[0], "seq_u8"):
        # columnar PreparedReads: concatenate the u8 views directly
        seqs = np.concatenate([r.seq_u8 for r in reads])
        quals = np.concatenate([r.qual_u8 for r in reads])
    else:
        seqs = np.frombuffer(
            "".join(r.seq for r in reads).encode(), dtype=np.uint8
        )
        quals = np.frombuffer(
            "".join(r.qual for r in reads).encode(), dtype=np.uint8
        )
    return seqs, quals, offsets


def _bind(a: np.ndarray, t):
    """One-time ctypes pointer for a reusable buffer (data_as costs ~4us;
    at 17 conversions per region it was ~25s of the 60 Mb host pipeline)."""
    return a.ctypes.data_as(ctypes.POINTER(t))


class _AssembleScratch(threading.local):
    """Per-thread reusable output arenas (the pool-parallel assembler gives
    every worker its own buffers).  max_h and the capacities are tracked
    separately: a larger max_h with a smaller ref_len must still grow the
    per-haplotype arrays (they are indexed up to max_h regardless of arena
    byte size).  ctypes pointers are bound once per (re)allocation."""

    gen = 0  # bumped on any (re)allocation: hc_fused_run ctrl blocks
    # embed raw buffer addresses and re-bind when the generation moves

    def ensure(self, max_h: int, ref_len: int):
        arena_cap = max_h * (ref_len + 64)
        # true per-alignment element bound is n + m + 2 with m <= the arena
        # row budget (ref_len + 64), so 2*ref_len + 128 per haplotype can
        # never overflow (hc_assemble_sw returns -5 as a last-resort guard)
        cigar_cap = max_h * (2 * ref_len + 128)
        if getattr(self, "max_h", 0) < max_h:
            self.gen += 1
            self.max_h = max_h
            self.hap_offsets = np.empty(max_h + 1, dtype=np.int64)
            self.scores = np.empty(max_h, dtype=np.float64)
            self.align_offsets = np.empty(max_h, dtype=np.int32)
            self.cigar_offsets = np.empty(max_h + 1, dtype=np.int64)
            self.p_hap_offsets = _bind(self.hap_offsets, ctypes.c_int64)
            self.p_scores = _bind(self.scores, ctypes.c_double)
            self.p_align_offsets = _bind(self.align_offsets, ctypes.c_int32)
            self.p_cigar_offsets = _bind(self.cigar_offsets, ctypes.c_int64)
        if getattr(self, "arena", None) is None or len(self.arena) < arena_cap:
            self.gen += 1
            self.arena = np.empty(arena_cap, dtype=np.uint8)
            self.p_arena = _bind(self.arena, ctypes.c_uint8)
        if (
            getattr(self, "cigar_ops", None) is None
            or len(self.cigar_ops) < cigar_cap
        ):
            self.gen += 1
            self.cigar_ops = np.empty(cigar_cap, dtype=np.uint8)
            self.cigar_lens = np.empty(cigar_cap, dtype=np.int32)
            self.p_cigar_ops = _bind(self.cigar_ops, ctypes.c_uint8)
            self.p_cigar_lens = _bind(self.cigar_lens, ctypes.c_int32)
        return self


class _WindowScratch(threading.local):
    """Per-thread reusable window output buffers + prebound pointers for
    the fused path (fresh np.empty + data_as per region dominated the
    Python share of prep time).  Consumers must COPY what escapes the
    call (io/columnar.py::window_reads_from_outputs does)."""

    gen = 0  # bumped on any (re)allocation (see _AssembleScratch.gen)

    def ensure(self, cap: int, n: int):
        if getattr(self, "cap", 0) < cap:
            self.gen += 1
            self.cap = max(cap, 1 << 16, 2 * getattr(self, "cap", 0))
            self.out_seq = np.empty(self.cap, np.uint8)
            self.out_qual = np.empty(self.cap, np.uint8)
            self.p_seq = _bind(self.out_seq, ctypes.c_uint8)
            self.p_qual = _bind(self.out_qual, ctypes.c_uint8)
        if getattr(self, "n", 0) < n:
            self.gen += 1
            self.n = max(n, 256, 2 * getattr(self, "n", 0))
            self.out_off = np.empty(self.n + 1, np.int64)
            self.out_ab = np.empty(self.n, np.int64)
            self.out_ae = np.empty(self.n, np.int64)
            self.p_off = _bind(self.out_off, ctypes.c_int64)
            self.p_ab = _bind(self.out_ab, ctypes.c_int64)
            self.p_ae = _bind(self.out_ae, ctypes.c_int64)
        if not hasattr(self, "kept_out"):
            self.kept_out = np.zeros(1, np.int32)
            self.p_kept = _bind(self.kept_out, ctypes.c_int32)
        return self


_ASSEMBLE_SCRATCH = _AssembleScratch()
_WINDOW_SCRATCH = _WindowScratch()


class _FusedCtrls(threading.local):
    """Per-thread {contig: (ctrl block, aux arrays)} for hc_fused_run.  The
    ctrl block embeds THREAD-LOCAL scratch pointers and is mutated per call
    (begin/end slots), so it can never be shared across pool workers."""

    def ensure_map(self):
        if not hasattr(self, "map"):
            self.map = {}
        return self.map


def fused_window_fn(cfg, store, contig_seqs=None, sel_capacity=None):
    """Whole-window native fast path over a ColumnarReadStore:
    ``(contig, begin, end, window_ref) -> (reads, n_downsampled, haps)``.
    ONE single-argument ctypes call per region runs downsample-select +
    filter/clip + assembly + per-haplotype SW (hc_fused_run): every
    argument lives in a per-thread int64 control block bound once per
    contig (the 30-argument hc_prepare_assemble_sw call cost ~50us of
    marshalling per region and the numpy select another ~17us — ~20s over
    a 60Mb WGS walk).  The separate prepare_window/assemble path remains
    the differential oracle.  Reads come back as a columnar WindowReads
    (no per-read objects).  ``contig_seqs`` ({name: full sequence}) is
    required for the ctrl path (window ref = pointer arithmetic into one
    per-contig encode); without it the legacy multi-argument call runs.
    ``sel_capacity`` sizes the downsample-select scratch (default: the
    larger of the window width and 1024 positions); a window wider than it
    raises instead of writing past the scratch."""
    from ..io.columnar import window_reads_from_outputs
    from ..models.haplotype import Haplotype

    lib = _load()
    c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    i64 = ctypes.c_int64
    p = cfg.sw_params
    sw_ints = np.array(
        [p.w_match, p.w_mismatch, p.w_open, p.w_extend,
         cfg.sw_max_mismatches_all_match],
        dtype=np.int32,
    )
    cfg_ints = _assemble_cfg_ints(cfg)
    max_h = cfg.max_num_haplotypes
    p_cfg_ints = c(cfg_ints, ctypes.c_int32)
    p_sw_ints = c(sw_ints, ctypes.c_int32)
    min_mapq = ctypes.c_int32(cfg.min_mapping_quality)
    min_len = ctypes.c_int32(cfg.min_read_length_after_trimming)
    # whole-contig reference bytes, encoded once: window slices become
    # pointer arithmetic instead of a per-region encode + data_as
    contig_bytes: dict = {}
    fn = lib.hc_prepare_assemble_sw
    fused = lib.hc_fused_run
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ds_mode = {"first": 0, "seeded": 1}[cfg.downsample_mode]
    ds_base = (cfg.downsample_seed * 0x10001) & 0xFFFFFFFFFFFFFFFF
    win_width = cfg.region_size + 2 * cfg.padding_size
    ctrls = _FusedCtrls()

    def _contig_ref(contig):
        ref_arr = contig_bytes.get(contig)
        if ref_arr is None and contig_seqs and contig in contig_seqs:
            ref_arr = contig_bytes[contig] = np.frombuffer(
                contig_seqs[contig].encode(), dtype=np.uint8
            )
        return ref_arr

    def _fill_scratch_slots(ctrl, ws, s, aux):
        sel_scratch, nds_out, needed_out = aux
        ctrl[20] = ws.out_seq.ctypes.data
        ctrl[21] = ws.out_qual.ctypes.data
        ctrl[22] = len(ws.out_seq)
        ctrl[23] = ws.out_off.ctypes.data
        ctrl[24] = ws.out_ab.ctypes.data
        ctrl[25] = ws.out_ae.ctypes.data
        ctrl[26] = ws.kept_out.ctypes.data
        ctrl[27] = sel_scratch.ctypes.data
        ctrl[28] = len(sel_scratch)
        ctrl[32] = s.arena.ctypes.data
        ctrl[33] = len(s.arena)
        ctrl[34] = s.hap_offsets.ctypes.data
        ctrl[35] = s.scores.ctypes.data
        ctrl[37] = s.align_offsets.ctypes.data
        ctrl[38] = s.cigar_ops.ctypes.data
        ctrl[39] = s.cigar_lens.ctypes.data
        ctrl[40] = s.cigar_offsets.ctypes.data
        ctrl[41] = len(s.cigar_ops)
        ctrl[42] = nds_out.ctypes.data
        ctrl[43] = needed_out.ctypes.data

    def _make_ctrl(contig, ref_arr):
        idx = store._indexes[contig]
        # the C side reads these as int64; coerce defensively (np.bincount
        # yields intp, which is int64 on every supported platform, but a
        # silent dtype change would corrupt the select).  The coerced
        # arrays are bound by THIS ctrl's keep tuple — never assigned back
        # onto the shared index (a concurrent worker's ctrl could otherwise
        # keep a pointer into an array this thread just replaced).
        idx_arrays = tuple(
            np.ascontiguousarray(getattr(idx, name), dtype=np.int64)
            if (getattr(idx, name).dtype != np.int64
                or not getattr(idx, name).flags.c_contiguous)
            else getattr(idx, name)
            for name in ("rows", "starts", "counts")
        )
        ctrl = np.zeros(44, dtype=np.int64)
        cols = (store.pos, store.flag, store.mapq, store.rnext_eq,
                store.cig_off, store.cig_op, store.cig_len,
                store.seq_off, store.seq, store.qual)
        for k, a in enumerate(cols):
            ctrl[k] = a.ctypes.data
        ctrl[10] = idx_arrays[0].ctypes.data
        ctrl[11] = idx_arrays[1].ctypes.data
        ctrl[12] = idx_arrays[2].ctypes.data
        ctrl[13] = idx.size
        ctrl[14] = ds_mode
        ctrl.view(np.uint64)[15] = ds_base
        ctrl[16] = cfg.min_mapping_quality
        ctrl[17] = cfg.min_read_length_after_trimming
        ctrl[29] = ref_arr.ctypes.data
        ctrl[30] = cfg_ints.ctypes.data
        ctrl[31] = sw_ints.ctypes.data
        ctrl[36] = max_h
        sel_scratch = np.empty(
            max(win_width, 1024) if sel_capacity is None else sel_capacity,
            np.int64,
        )
        nds_out = np.zeros(1, np.int32)
        needed_out = np.zeros(1, np.int64)
        aux = (sel_scratch, nds_out, needed_out)
        ws = _WINDOW_SCRATCH.ensure(1 << 16, win_width)
        s = _ASSEMBLE_SCRATCH.ensure(max_h, win_width)
        _fill_scratch_slots(ctrl, ws, s, aux)
        gens = [ws.gen + s.gen]
        ctrl_p = ctrl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        # keep every pointed-to array alive alongside the block
        keep = (idx, idx_arrays, cols, cfg_ints, sw_ints, ref_arr)
        return (ctrl, ctrl_p, aux, gens, keep)

    def _unmarshal(contig, n):
        ws, s = _WINDOW_SCRATCH, _ASSEMBLE_SCRATCH
        kept = int(ws.kept_out[0])
        reads = window_reads_from_outputs(
            contig, ws.out_seq, ws.out_qual, ws.out_off, ws.out_ab,
            ws.out_ae, kept,
        )
        haplotypes = []
        hap_offs = s.hap_offsets
        cig_offs = s.cigar_offsets
        for i in range(n):
            bases_u8 = s.arena[hap_offs[i] : hap_offs[i + 1]].copy()
            h = Haplotype(bases_u8.tobytes().decode(), s.scores[i])
            h.bases_u8 = bases_u8
            h.alignment_begin_wrt_ref = int(s.align_offsets[i])
            lo, hi = int(cig_offs[i]), int(cig_offs[i + 1])
            ops = s.cigar_ops[lo:hi].tobytes().decode()
            h.cigar = tuple(zip(s.cigar_lens[lo:hi].tolist(), ops))
            haplotypes.append(h)
        return reads, haplotypes

    def run(contig: str, begin: int, end: int, window_ref: str):
        ref_arr = _contig_ref(contig)
        if ref_arr is None:
            return run_fallback(contig, begin, end, window_ref)
        cmap = ctrls.ensure_map()
        entry = cmap.get(contig)
        if entry is None:
            entry = cmap[contig] = _make_ctrl(contig, ref_arr)
        ctrl, ctrl_p, aux, gens, _keep = entry
        # scratch buffers are shared with the other native entry points on
        # this thread; any reallocation there invalidates the embedded
        # addresses -> re-bind when the generation moved
        if _WINDOW_SCRATCH.gen + _ASSEMBLE_SCRATCH.gen != gens[0]:
            ws = _WINDOW_SCRATCH.ensure(1, 1)
            s = _ASSEMBLE_SCRATCH.ensure(max_h, win_width)
            _fill_scratch_slots(ctrl, ws, s, aux)
            gens[0] = ws.gen + s.gen
        ctrl[18] = begin
        ctrl[19] = end
        n = fused(ctrl_p)
        if n == -10:  # out blob scratch too small: grow + rebind + retry
            ws = _WINDOW_SCRATCH.ensure(int(aux[2][0]), win_width)
            s = _ASSEMBLE_SCRATCH.ensure(max_h, win_width)
            _fill_scratch_slots(ctrl, ws, s, aux)
            gens[0] = ws.gen + s.gen
            n = fused(ctrl_p)
        if n == -11:
            raise ValueError(
                f"window {contig}:{begin}-{end} is wider than the "
                f"downsample-select scratch ({len(aux[0])} positions)"
            )
        if n < 0:
            _raise_assemble_error("hc_fused_run", n)
        n_ds = int(aux[1][0])
        if n_ds == 0:
            return [], 0, []
        reads, haplotypes = _unmarshal(contig, n)
        if not reads:
            return [], n_ds, []
        return reads, n_ds, haplotypes

    def run_fallback(contig: str, begin: int, end: int, window_ref: str):
        sel = store._indexes[contig].select(begin, end, cfg)
        if sel.size == 0:
            return [], 0, []
        cap = int((store.seq_off[sel + 1] - store.seq_off[sel]).sum())
        ws = _WINDOW_SCRATCH.ensure(cap, len(sel))
        win_arr = np.frombuffer(window_ref.encode(), dtype=np.uint8)
        ref_ptr = c(win_arr, ctypes.c_uint8)
        ref_len = len(win_arr)
        s = _ASSEMBLE_SCRATCH.ensure(max_h, end - begin)
        n = fn(
            *store._static_ptrs,
            c(sel, i64), ctypes.c_int32(len(sel)),
            min_mapq, min_len,
            i64(begin), i64(end),
            ws.p_seq, ws.p_qual, ws.p_off, ws.p_ab, ws.p_ae,
            ws.p_kept,
            ref_ptr, ref_len,
            p_cfg_ints, p_sw_ints,
            s.p_arena, len(s.arena),
            s.p_hap_offsets, s.p_scores, max_h,
            s.p_align_offsets,
            s.p_cigar_ops, s.p_cigar_lens,
            s.p_cigar_offsets, len(s.cigar_ops),
        )
        if n < 0:
            _raise_assemble_error("hc_prepare_assemble_sw", n)
        reads, haplotypes = _unmarshal(contig, n)
        return reads, int(sel.size), haplotypes

    return run


def native_assemble_fn(cfg):
    from ..models.haplotype import Haplotype
    from ..ops.sw import sw_align

    def assemble(reads, ref, config):
        lib = _load()
        ref_b = np.frombuffer(ref.encode(), dtype=np.uint8)
        seqs, quals, offsets = _flatten_read_blobs(reads)
        cfg_ints = _assemble_cfg_ints(config)
        max_h = config.max_num_haplotypes
        s = _ASSEMBLE_SCRATCH.ensure(max_h, len(ref))
        c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        fused_sw = config.sw_engine == "native"
        if fused_sw:
            p = config.sw_params
            sw_ints = np.array(
                [p.w_match, p.w_mismatch, p.w_open, p.w_extend,
                 config.sw_max_mismatches_all_match],
                dtype=np.int32,
            )
            n = lib.hc_assemble_sw(
                c(ref_b, ctypes.c_uint8), len(ref_b),
                c(seqs, ctypes.c_uint8), c(quals, ctypes.c_uint8),
                c(offsets, ctypes.c_int64), len(reads),
                c(cfg_ints, ctypes.c_int32), c(sw_ints, ctypes.c_int32),
                c(s.arena, ctypes.c_uint8), len(s.arena),
                c(s.hap_offsets, ctypes.c_int64),
                c(s.scores, ctypes.c_double),
                max_h,
                c(s.align_offsets, ctypes.c_int32),
                c(s.cigar_ops, ctypes.c_uint8),
                c(s.cigar_lens, ctypes.c_int32),
                c(s.cigar_offsets, ctypes.c_int64),
                len(s.cigar_ops),
            )
        else:
            n = lib.hc_assemble(
                c(ref_b, ctypes.c_uint8), len(ref_b),
                c(seqs, ctypes.c_uint8), c(quals, ctypes.c_uint8),
                c(offsets, ctypes.c_int64), len(reads),
                c(cfg_ints, ctypes.c_int32),
                c(s.arena, ctypes.c_uint8), len(s.arena),
                c(s.hap_offsets, ctypes.c_int64),
                c(s.scores, ctypes.c_double),
                max_h,
            )
        if n < 0:
            _raise_assemble_error(
                "hc_assemble_sw" if fused_sw else "hc_assemble", n
            )
        haplotypes = []
        for i in range(n):
            bases = (
                s.arena[s.hap_offsets[i] : s.hap_offsets[i + 1]]
                .tobytes()
                .decode()
            )
            h = Haplotype(bases, s.scores[i])
            if fused_sw:
                h.alignment_begin_wrt_ref = int(s.align_offsets[i])
                lo, hi = s.cigar_offsets[i], s.cigar_offsets[i + 1]
                ops = s.cigar_ops[lo:hi].tobytes().decode()
                h.cigar = tuple(
                    (int(s.cigar_lens[lo + k]), ops[k])
                    for k in range(hi - lo)
                )
            else:
                h.alignment_begin_wrt_ref, h.cigar = sw_align(
                    ref, bases, config.sw_params, config.sw_max_mismatches_all_match
                )
            haplotypes.append(h)
        return haplotypes

    return assemble
