"""Typed configuration for the PyTorch/CUDA HaplotypeCaller engine.

The reference implementation scatters its tuning constants across headers as
``static constexpr`` values (see the reference's src/haplotypecaller/
haplotypecaller.hpp:112-113, assembler/assembler.hpp:15-18,
assembler/graph_wrapper.hpp:22-24, pairhmm/pairhmm.hpp:29-36,
genotyper/genotyper.hpp:15-19, smithwaterman/smithwaterman.hpp:21-24).
Here they live in one dataclass so every component reads the same source of
truth and tests can vary them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

# fuse widths the reference package allows (gatk_hc_tpu/config.py)
FUSE_GROUPS = (1, 2, 3, 4, 6, 8, 16)

# Environment overrides of seven defaults below: the reference package's
# (gatk_hc_tpu/config.py), named GATK_HC_TPU_TORCH_* instead of
# GATK_HC_TPU_*, so that one environment can set the two packages apart.
# A bad value raises at import, naming the variable, instead of silently
# keeping the default.


def _env_choice(name: str, default: str, choices: Tuple[str, ...]) -> str:
    value = os.environ.get(name, default)
    if value not in choices:
        raise ValueError(f"{name}={value!r}: expected one of {choices}")
    return value


def _env_float(name: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = float(raw)
    except ValueError as exc:
        raise ValueError(f"{name}={raw!r}: expected a number") from exc
    if not value >= minimum:  # NaN fails too
        raise ValueError(f"{name}={value}: must be >= {minimum}")
    return value


def _env_int_choice(name: str, default: int, choices: Tuple[int, ...]) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError as exc:
        raise ValueError(f"{name}={raw!r}: expected an integer") from exc
    if value not in choices:
        raise ValueError(f"{name}={value}: expected one of {choices}")
    return value


@dataclasses.dataclass(frozen=True)
class SWParameters:
    """Affine-gap Smith-Waterman scoring parameters.

    Mirrors hc::SWAligner::SWParameters (smithwaterman.hpp:12-24).
    """

    w_match: int
    w_mismatch: int
    w_open: int
    w_extend: int


# The four presets from smithwaterman.hpp:21-24. The assembly path uses
# NEW_SW_PARAMETERS (the default argument of IntelSWAligner::align,
# intel_smithwaterman.hpp:31).
ORIGINAL_DEFAULT_SW = SWParameters(3, -1, -4, -3)
STANDARD_NGS_SW = SWParameters(25, -50, -110, -6)
NEW_SW_PARAMETERS = SWParameters(200, -150, -260, -11)
ALIGNMENT_TO_BEST_HAPLOTYPE_SW = SWParameters(10, -15, -30, -5)


@dataclasses.dataclass(frozen=True)
class HCConfig:
    """All pipeline constants, defaulting to the reference's behavior."""

    # --- Region walker (haplotypecaller.hpp:112-113) ---
    region_size: int = 245
    padding_size: int = 85

    # --- Downsampling -----------------------------------------------------
    # The reference picks ONE random read per alignment-start position with a
    # std::random_device-seeded mt19937 (haplotypecaller.hpp:44-50), which is
    # nondeterministic run-to-run.  We support:
    #   "first"  - deterministically keep the first read parsed at each start
    #   "seeded" - mt19937-style choice from a fixed seed (per position)
    downsample_mode: str = "first"
    downsample_seed: int = 0

    # --- Read filters (utils/read_filter.hpp) ---
    min_mapping_quality: int = 20          # read_filter.hpp:10
    min_read_length_after_trimming: int = 10  # read_filter.hpp:29

    # --- Assembler (assembler.hpp:15-18, graph_wrapper.hpp:22-24) ---
    initial_kmer_size: int = 25
    kmer_size_iteration_increase: int = 10
    max_kmer_iterations: int = 9
    max_unique_kmers_to_discard: int = 2000
    max_num_haplotypes: int = 128          # GraphWrapper::DEFAULT_NUM_PATHS
    prune_factor: int = 2                  # GraphWrapper::PRUNE_FACTOR
    min_base_quality_to_use: int = 10 + 33  # ASCII '+'-ish: Q10 + '!' offset

    # --- Smith-Waterman ---
    sw_params: SWParameters = NEW_SW_PARAMETERS
    sw_max_mismatches_all_match: int = 2   # MINIMAL_MISMATCH_TO_TOLERANCE

    # --- PairHMM ---
    # The main (Intel AVX) path derives transition probabilities from the
    # constant GOP='I'/GCP='+' strings using the RAW ASCII byte value as the
    # Phred index into ph2pr (avx-pairhmm-template.h:108-119 does
    # `tc->i[r-1] & 127` on ASCII 'I'==73 with no -33 offset).  This is a
    # deliberate behavioral replication of the reference main path; the
    # scalar oracle path in the reference subtracts the offset instead.
    gop_char: int = ord("I")               # sam.hpp:31
    gcp_char: int = ord("+")               # sam.hpp:32
    max_read_length: int = 200             # sam.hpp:30
    min_accepted_float: float = 1e-28      # pairhmm_common.h:16 (MIN_ACCEPTED)
    # Likelihood normalization + poorly-modeled-read filter
    # (intel_pairhmm.hpp:19-23)
    max_best_alt_likelihood_difference: float = -4.5
    expected_error_rate_per_base: float = 0.02
    log10_quality_per_base: float = -4.0
    max_expected_error_per_read: float = 2.0

    # --- Genotyper (genotyper.hpp:15-19) ---
    allele_extension: int = 2
    max_genotype_quality: int = 99
    min_heterozygosity_quality: int = 50
    max_allele_count: int = 7

    # --- VCF output (haplotypecaller.hpp:132-135) ---
    sample_name: str = "NA12878"

    # --- Device batching ---
    # (read, hap) pairs are padded into a few fixed tile shapes; every group
    # of pairs runs at the tightest (r_pad, c_pad) bucket that holds it.
    read_pad_buckets: Tuple[int, ...] = (96, 160, 224)
    # 448 covers every standard 245+2*85=415bp window's haplotypes (incl.
    # insertion slack) with 12.5% fewer padded DP cells than 512
    hap_pad_buckets: Tuple[int, ...] = (448, 512)

    # --- Engine selection ---
    # "cuda": the hand-written CUDA PairHMM kernel through the batched
    #         runner (ops/runner.py::TorchPairHMMRunner);
    # "diag": the anti-diagonal forward in PyTorch ops, one call per region
    #         (ops/pairhmm_diag.py; the kernels' independent cross-check);
    # "shardmap": each region's pair grid split over a (data, hap) grid of
    #         devices, the same kernels per block
    #         (parallel/sharded_step.py::ShardMapPairHMMRunner);
    # "native": C++ host engine;  "python": slow exact reference oracle.
    # All engines are bit-exact, so the choice never changes the VCF
    # (the CLI's --pairhmm auto resolves to "native" or "cuda" by input
    # size: resolve_auto_pairhmm_engine).
    pairhmm_engine: str = "cuda"
    assembler_engine: str = "native"       # "native" | "python"
    data_engine: str = "auto"              # "auto" | "native" | "python":
    # columnar C++ SAM parse + window prep vs per-record Python objects
    # "host": exact NumPy f64 reductions;  "cuda": the same reductions in
    # float64 through the CUDA genotype kernel, batched over a drained
    # chunk's sites (models/genotyper.py::genotype_regions_device; the
    # reference package's "jax" engine).  Both give the same VCF.
    genotyper_engine: str = "host"
    f64_rescue: str = "sentinel"           # "sentinel" | "exact": underflowed
    # f32 pairs get a provably VCF-neutral stand-in vs the reference's exact
    # float64 recomputation (see ops/pairhmm_oracle.py::RESCUE_SENTINEL_LOG10)
    sw_engine: str = "native"              # "native" | "python"
    # NR of the ppe kernel (1, 2, 4 or 8): the fewest read rows one lane
    # holds (it holds max(NR, ceil(r_pad / 32)), at most 8).  Every value
    # computes bit-identical results; a padded read length that is not a
    # multiple of it drops to the largest that divides it.
    ppe_rows: int = _env_int_choice(
        "GATK_HC_TPU_TORCH_PPE_ROWS", 4, (1, 2, 4, 8)
    )
    # PairHMM kernel of the cuda engine: "ppe" (csrc/pairhmm_ppe.cu, one
    # warp per pair) or "striped" (csrc/pairhmm_striped.cu, stripe_height
    # lanes per pair, each holding K read rows).  Both compute the same
    # result bit for bit; padded read lengths round up to a multiple of
    # stripe_height on the striped path.  The names and defaults are the
    # reference package's, so a reference config carries them across.
    pallas_algo: str = _env_choice(
        "GATK_HC_TPU_TORCH_PALLAS_ALGO", "ppe", ("ppe", "striped")
    )
    stripe_height: int = 32
    # Host-side region pipeline threads (prepare + assemble + job packing
    # run in a pool; ctypes releases the GIL, so this scales with cores —
    # the reference's OpenMP analogue for the HOST stages).  0 = one thread
    # per CPU; 1 = inline single-thread path.
    host_threads: int = 0
    # Bounded-memory data path for whole-genome inputs: parse one contig's
    # reads at a time (one cheap ranged scan of the whole file, then a
    # per-contig slice parse) and free each contig's columns when its last
    # region has been assembled.  Peak RSS is then O(largest contig's
    # reads), not O(whole SAM) — the reference holds every read in RAM
    # (haplotypecaller.hpp:24-42).  Only affects the columnar data engine.
    stream_contigs: bool = False
    # Streaming parse-ahead: while contig N assembles, slice-parse contig
    # N+1's columns on one background thread, so the walk never blocks on
    # a parse after the first contig (the native parse releases the GIL;
    # on multi-core hosts the overlap is full, on one core the file I/O
    # still overlaps).  Costs up to one extra contig's columns in RSS —
    # peak becomes O(2 largest contigs) instead of O(largest); disable for
    # the strict bound.  No effect without stream_contigs.
    parse_ahead: bool = True

    # --- PairHMM dispatch (ops/runner.py) ---
    # The names, defaults and allowed values are the reference package's
    # (gatk_hc_tpu/config.py), so a reference config carries them across.
    # Shipping encoding of the ppe kernel's groups: "planes" ships
    # host-prepared i32 element planes (12 B per read base, no lookups on
    # the card); "packed" ships the raw bytes (2 B per read base) or, with
    # packed_nib, nibble-dictionary bytes (1 B) and a span table, and the
    # ppe kernel applies the lookups as it reads them; "adaptive" times one
    # group on each after the first 32 groups and keeps choosing the
    # measured winner (DispatchPathController).  Every encoding gives the
    # same bits.  The forced modes, packed_nib=False and fuse_auto=False
    # are for tests and diagnostics: no measured workload favours one yet.
    dispatch_mode: str = _env_choice(
        "GATK_HC_TPU_TORCH_DISPATCH", "adaptive",
        ("adaptive", "planes", "packed"),
    )
    # The nib encoding on single-chunk packed groups whose alphabets fit
    # (<= 8 read bytes, <= 32 quality bytes); others ship raw packed.
    packed_nib: bool = _env_choice(
        "GATK_HC_TPU_TORCH_PACKED_NIB", "1", ("0", "1")
    ) == "1"
    # Fuse up to N same-path single-chunk groups of one (r_pad, c_pad)
    # into ONE copy and ONE kernel launch (bit-identical per group); 1 =
    # off.
    fuse_groups: int = _env_int_choice(
        "GATK_HC_TPU_TORCH_FUSE_GROUPS", 4, FUSE_GROUPS
    )
    # True: fuse only while the dispatch controller measures a deeply
    # degraded phase (per-pair cost > 6x its best); False: always fuse
    # when fuse_groups > 1.
    fuse_auto: bool = _env_choice(
        "GATK_HC_TPU_TORCH_FUSE_AUTO", "1", ("0", "1")
    ) == "1"
    # Device-wedge check: when resolving a submitted batch, waiting for its
    # results or waiting for the kernel build passes this many seconds AND
    # a fresh probe of the card cannot finish, the runner raises
    # DeviceWedgedError (the reference fails over to its C++ engine; the
    # port never moves the card's work to the CPU).  0 waits forever.
    device_timeout_s: float = _env_float(
        "GATK_HC_TPU_TORCH_DEVICE_TIMEOUT", 1200.0
    )

    def __post_init__(self) -> None:
        if self.genotyper_engine not in ("host", "cuda"):
            raise ValueError(
                "genotyper_engine must be 'host' or 'cuda', got "
                f"{self.genotyper_engine!r}"
            )
        if self.pallas_algo not in ("ppe", "striped"):
            raise ValueError(
                f"pallas_algo must be 'ppe' or 'striped', got {self.pallas_algo!r}"
            )
        # the heights the striped CUDA kernel is built for
        if self.stripe_height not in (8, 16, 32):
            raise ValueError(
                f"stripe_height must be 8, 16 or 32, got {self.stripe_height}"
            )
        if self.dispatch_mode not in ("adaptive", "planes", "packed"):
            raise ValueError(
                "dispatch_mode must be 'adaptive', 'planes' or 'packed', "
                f"got {self.dispatch_mode!r}"
            )
        if self.fuse_groups not in FUSE_GROUPS:
            raise ValueError(
                f"fuse_groups must be one of {FUSE_GROUPS}, got {self.fuse_groups}"
            )
        for name in ("packed_nib", "fuse_auto"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be a bool")
        if not self.device_timeout_s >= 0:
            raise ValueError(
                f"device_timeout_s must be >= 0, got {self.device_timeout_s}"
            )


DEFAULT_CONFIG = HCConfig()


# --pairhmm auto: below this SAM size the native C++ engine takes less wall
# than the cuda engine — the torch import, CUDA context, kernel load and
# warm-up launches cost more than the card saves on a small input; from it
# up the card wins.  Measured on one NVIDIA H100 80GB HBM3 at 700.00 W, one
# process per run, 3 alternated rounds per size (PERF.md section 6, the
# auto walls; tools/auto_threshold.py), with the native engine never
# importing torch: native won up to a 2 Mb contig at 30x (141.2 MB of
# SAM), cuda from 4 Mb (282.9 MB) up; 256 MiB rounds that down.
# Latency-only choice: every engine is bit-exact, so auto never changes
# the VCF.
AUTO_NATIVE_MAX_SAM_BYTES = 256 * 1024 * 1024


def resolve_auto_pairhmm_engine(sam_bytes: int, device: str = "cuda") -> str:
    """The PairHMM engine of ``--pairhmm auto`` for a SAM of ``sam_bytes``
    on ``device``.  The threshold holds on the card only: on the CPU
    ("cpu") the cuda engine runs its kernel's plain PyTorch version, far
    slower than native, so auto is native there."""
    if device == "cpu" or sam_bytes < AUTO_NATIVE_MAX_SAM_BYTES:
        return "native"
    return "cuda"
