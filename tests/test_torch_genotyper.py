"""The device genotyper of the port (ops/genotyper_cuda.py,
models/genotyper.py::genotype_regions_device, --genotyper cuda) against the
reference package's device genotyper (gatk_hc_tpu/ops/genotyper_jax.py,
genotype_regions_jax) and the host genotyper, on the CPU: the kernel's
plain PyTorch version runs there (the CUDA kernel itself is held against
it on the card by chip_smoke.py).  Inputs are made from numpy seeds.

Tolerances: float64 is bit-exact everywhere (the same operations in the
same order); float32 is held to the reference's own error bound
(_f32_total_bound) against the reference's float32 path, whose XLA program
may contract a multiply into an add."""

import contextlib
import dataclasses
import io
import math
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.models import genotyper as jax_gt
from gatk_hc_tpu.ops.genotyper_jax import genotype_sites_host
from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG, HCConfig
from gatk_hc_tpu_torch.io.sam import SAMRecord
from gatk_hc_tpu_torch.models import genotyper as gt
from gatk_hc_tpu_torch.models.caller import call_batched
from gatk_hc_tpu_torch.models.haplotype import Haplotype
from gatk_hc_tpu_torch.ops import _kernels
from gatk_hc_tpu_torch.ops import genotyper_cuda as gc
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from gatk_hc_tpu_torch.utils import quality
from gatk_hc_tpu_torch.utils.cigar import parse_cigar
from gatk_hc_tpu_torch.utils.interval import Interval
from gatk_hc_tpu_torch.utils.logging import RunCounters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")
SAM = os.path.join(FIXTURES, "chrM.sam")
FASTA = os.path.join(FIXTURES, "chrM.fa")
GOLDEN = os.path.join(FIXTURES, "chrM.golden.vcf")
CUDA_CFG = dataclasses.replace(
    DEFAULT_CONFIG, pairhmm_engine="native", genotyper_engine="cuda")

# (S, R, H): the reference test's tile, tiles past one kernel read chunk
# (READ_CHUNK 128 reads), and a wide hap axis
TILES = [(6, 24, 10), (5, 300, 16), (9, 130, 33)]


def random_tile(seed, S, R, H):
    """tests/test_genotyper.py::TestDeviceGenotyper's tile: likelihoods in
    [-40, 0) with a cloned column (ties), allele counts 2-8, haps mapped
    anywhere in [0, count) (so an allele may have no hap), 80% of reads
    kept, the last two hap slots valid with probability 1/2."""
    rng = np.random.default_rng(seed)
    lik = (rng.random((S, R, H)) * -40.0).astype(np.float64)
    lik[:, :, 3] = lik[:, :, 1]
    ac = rng.integers(2, gc.MAX_ALLELES + 1, S).astype(np.int32)
    h2a = np.stack([rng.integers(0, a, H) for a in ac]).astype(np.int32)
    keep = rng.random((S, R)) < 0.8
    keep[:, 0] = True
    hv = np.ones((S, H), dtype=bool)
    hv[:, -2:] = rng.random((S, 2)) < 0.5
    return lik, h2a, keep, hv, ac


def port_sites(lik, h2a, keep, hv, ac, max_gq=99):
    return tuple(t.numpy() for t in gc.genotype_sites_device(
        lik, h2a, keep, hv, ac, "cpu", max_gq=max_gq))


def bits(a):
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("seed", [42, 7])
@pytest.mark.parametrize("tile", TILES)
def test_plain_f64_bit_equal_to_reference(tile, seed):
    """float64: genotype likelihoods (masked slots included), best and GQ
    bit-equal to the reference's genotype_sites_host."""
    lik, h2a, keep, hv, ac = random_tile(seed, *tile)
    want = [np.asarray(x) for x in genotype_sites_host(lik, h2a, keep, hv, ac)]
    got = port_sites(lik, h2a, keep, hv, ac)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("tile", TILES)
def test_plain_f32_within_reference_bound(tile):
    """float32 (Neumaier-compensated): every finite genotype likelihood
    within the reference's _f32_total_bound of the reference's float32
    result, the non-finite ones (masked slots, sums over an allele with no
    hap) alike; the best genotype equal where the top-2 gap exceeds twice
    the bound (the guard's own stability rule)."""
    lik, h2a, keep, hv, ac = random_tile(11, *tile)
    lik32 = lik.astype(np.float32)
    want = [np.asarray(x) for x in genotype_sites_host(lik32, h2a, keep, hv, ac)]
    got = port_sites(lik32, h2a, keep, hv, ac)
    assert got[0].dtype == np.float32
    bound = jax_gt._f32_total_bound(np.abs(lik).max(axis=(1, 2)) + 0.4,
                                    keep.sum(axis=1))
    np.testing.assert_array_equal(np.isfinite(got[0]), np.isfinite(want[0]))
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    fin = np.isfinite(want[0])
    diff = np.abs(got[0][fin].astype(np.float64)
                  - want[0][fin].astype(np.float64))
    assert (diff <= np.broadcast_to(bound[:, None], fin.shape)[fin]).all()
    gl = want[0].astype(np.float64)
    top2 = np.sort(np.where(np.isnan(gl), np.inf, gl), axis=1)[:, -2:]
    with np.errstate(invalid="ignore"):  # inf - inf: not stable
        stable = (top2[:, 1] - top2[:, 0]) > 2 * bound
    np.testing.assert_array_equal(got[1][stable], want[1][stable])


def test_plain_f64_matches_host_on_bucket_tiles():
    """float64 on tiles as the genotyper pads them (chip_smoke.py's
    generator, small S): every valid slot's likelihood bit-equal to the
    host's per-site reductions, best and GQ to its batched reduction."""
    sys.path.insert(0, REPO)
    import chip_smoke

    rng = np.random.default_rng(20261018)
    for S, R, H in ((16, 128, 16), (4, 512, 32), (2, 2048, 128), (2, 64, 16)):
        lik, h2a, keep, hv, ac = chip_smoke.genotype_tile(rng, S, R, H)
        gl, best, gq = port_sites(lik, h2a, keep, hv, ac)
        host = chip_smoke.host_genotypes(lik, h2a, keep, hv, ac)
        for s, (slots, want_gl, b, q) in enumerate(host):
            np.testing.assert_array_equal(bits(gl[s, slots]), bits(want_gl))
            assert (best[s], gq[s]) == (b, q), (S, R, H, s)


def test_no_kept_reads_site():
    """No kept read: every valid genotype totals 0, the last valid slot
    wins (slot 8 = 1/1 of two alleles), GQ 0; masked slots hold LOWEST in
    f64 and -inf in f32."""
    lik = np.zeros((1, 4, 3))
    h2a = np.array([[0, 1, 0]], np.int32)
    keep = np.zeros((1, 4), bool)
    hv = np.ones((1, 3), bool)
    ac = np.array([2], np.int32)
    for dtype, low in ((np.float64, -np.finfo(np.float64).max),
                       (np.float32, -np.inf)):
        gl, best, gq = port_sites(lik.astype(dtype), h2a, keep, hv, ac)
        assert (int(best[0]), int(gq[0])) == (8, 0)
        assert gl[0, [0, 1, 8]].tolist() == [0.0, 0.0, 0.0]
        assert (gl[0, 2:8] == low).all()


def test_plain_f32_flushes_subnormals():
    """float32 flushes as the kernel's -ftz=true does: a subnormal
    likelihood reads as a zero of its sign (the same outputs, bit for bit,
    as the tile with those zeros), a subnormal result becomes one; f64
    keeps the same values."""
    tiny = float(np.finfo(np.float32).tiny)
    x = torch.tensor([tiny / 3, -tiny / 3, tiny, -tiny, 0.0, -math.inf,
                      math.nan], dtype=torch.float32)
    got = gc._ftz(x).numpy()
    assert bits(got[:5]).tolist() == bits(np.array(
        [0.0, -0.0, tiny, -tiny, 0.0], np.float32)).tolist()
    assert got[5] == -np.inf and np.isnan(got[6])
    lik, h2a, keep, hv, ac = random_tile(5, 7, 140, 12)
    rng = np.random.default_rng(5)
    sub = rng.random(lik.shape) < 0.05
    sign = np.where(rng.random(lik.shape) < 0.5, -1.0, 1.0)
    lik32 = lik.astype(np.float32)
    lik32[sub] = (sign * rng.uniform(1e-45, tiny, lik.shape))[sub]
    zeroed = np.where(sub, sign * 0.0, lik32).astype(np.float32)
    got = port_sites(lik32, h2a, keep, hv, ac)
    want = port_sites(zeroed, h2a, keep, hv, ac)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # f64: the same magnitudes are normal and not flushed
    lik64 = np.where(sub, sign * 1e-300, lik)
    got64 = port_sites(lik64, h2a, keep, hv, ac)
    want64 = [np.asarray(x) for x in genotype_sites_host(
        lik64, h2a, keep, hv, ac)]
    np.testing.assert_array_equal(bits(got64[0]), bits(want64[0]))


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    lik, h2a, keep, hv, ac = (torch.from_numpy(x) for x in random_tile(
        1, 2, 8, 4))
    before = dict(pt.LAUNCHES)
    gl, best, gq = gc.genotype_sites_cuda(lik, h2a, keep, hv, ac)
    assert pt.LAUNCHES == before  # the plain version is no launch
    assert gl.shape == (2, gc.MAX_GENOTYPES) and best.dtype == torch.int32
    with pytest.raises(TypeError, match="float64 or float32"):
        gc.genotype_sites_cuda(lik.to(torch.float16), h2a, keep, hv, ac)
    with pytest.raises(TypeError, match="hap_to_allele"):
        gc.genotype_sites_cuda(lik, h2a.long(), keep, hv, ac)
    with pytest.raises(ValueError, match="read_keep"):
        gc.genotype_sites_cuda(lik, h2a, keep[:, :4].contiguous(), hv, ac)
    with pytest.raises(ValueError, match="contiguous"):
        gc.genotype_sites_cuda(lik.transpose(1, 2).contiguous().transpose(
            1, 2), h2a, keep, hv, ac)


def _c_params(source, name):
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, name
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_kernel_source_matches_python():
    """csrc/genotyper.cu's constants and C signature are the ones the
    wrapper and the plain version use: the genotype slot tables, the
    Jacobian constants, the read chunk, the hap limit, the binding."""
    with open(f"{_kernels.CSRC}/genotyper.cu") as handle:
        source = handle.read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([\d.]+);", source).group(1)

    def table(name):
        body = re.search(rf"{name}\[MAX_GENOTYPES\] = \{{([^}}]*)\}}",
                         source).group(1)
        return [int(x) for x in body.replace("\n", " ").split(",")]

    a1, a2 = gc.genotype_pair_tables()
    assert table("kA1") == a1.tolist() and table("kA2") == a2.tolist()
    assert int(const("MAX_ALLELES")) == gc.MAX_ALLELES
    assert int(const("THREADS")) == gc.READ_CHUNK
    assert int(const("MAX_HAPS")) == gc.MAX_HAPS
    assert float(const("JACOBIAN_TOLERANCE")) == quality.MAX_JACOBIAN_TOLERANCE
    assert float(const("JACOBIAN_INV_STEP")) == quality.JACOBIAN_LOG_TABLE_INV_STEP
    lib = types.SimpleNamespace(genotype_sites=types.SimpleNamespace())
    _kernels._BINDERS["genotyper"](lib)
    params = _c_params(source, "genotype_sites")
    assert len(lib.genotype_sites.argtypes) == len(params)
    assert params[0] == "int f64" and params[-2] == "double log10_2"
    # every source builds with one flag set: no contraction, f32 flushed
    # (the plain f32 version flushes where the kernel does)
    assert {"-fmad=false", "-ftz=true"} <= set(_kernels.NVCC_FLAGS)
    assert "genotyper" in _kernels.KERNELS


# --- the engine end to end (TestJaxGenotyperEngine's ports) ---------------


def test_e2e_golden_chrm(tmp_path):
    out = tmp_path / "gcuda.vcf"
    call_batched(SAM, FASTA, str(out), CUDA_CFG, device="cpu")
    assert out.read_text() == open(GOLDEN).read()


def test_region_parity_with_host_engine():
    """Every region's variant list matches the host engine exactly
    (locations, alleles, GT, GQ)."""
    base = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")
    host = call_batched(SAM, FASTA, None, base)
    dev = call_batched(SAM, FASTA, None, CUDA_CFG, device="cpu")
    assert len(host) == len(dev)
    for rh, rd in zip(host, dev):
        assert [v.to_vcf_row() for v in rh.variants] == [
            v.to_vcf_row() for v in rd.variants
        ]


def test_cli_genotyper_cuda_on_cpu(tmp_path):
    out = tmp_path / "cli.vcf"
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["-I", SAM, "-R", FASTA, "-O", str(out), "--pairhmm",
                       "native", "--genotyper", "cuda", "--device", "cpu",
                       "--stats"])
    assert rc == 0
    assert out.read_text() == open(GOLDEN).read()
    assert '"genotyper": "cuda"' in stdout.getvalue()
    assert "gq_host_verified" not in stdout.getvalue()  # f64: nothing to verify


def _capture_region_inputs(monkeypatch):
    """The region inputs call_batched hands the device genotyper."""
    seen = []
    real = gt.genotype_regions_device

    def spy(region_inputs, cfg, **kwargs):
        seen.extend(region_inputs)
        return real(region_inputs, cfg, **kwargs)

    monkeypatch.setattr(gt, "genotype_regions_device", spy)
    call_batched(SAM, FASTA, None, CUDA_CFG, device="cpu")
    monkeypatch.setattr(gt, "genotype_regions_device", real)
    return seen


@pytest.mark.parametrize("use_f64", [True, False])
def test_regions_device_matches_reference_regions_jax(monkeypatch, use_f64):
    """genotype_regions_device against the reference's genotype_regions_jax
    on the chrM regions the pipeline genotypes: the same variant rows per
    region, in f64 and on the guarded f32 path (both host-identical)."""
    region_inputs = _capture_region_inputs(monkeypatch)
    assert len(region_inputs) > 30
    counters = RunCounters()
    got = gt.genotype_regions_device(region_inputs, CUDA_CFG, device="cpu",
                                     use_f64=use_f64, counters=counters)
    jax_cfg = dataclasses.replace(JAX_DEFAULT_CONFIG, genotyper_engine="jax")
    want = jax_gt.genotype_regions_jax(region_inputs, jax_cfg, use_f64=use_f64)
    assert [[v.to_vcf_row() for v in r] for r in got] == [
        [v.to_vcf_row() for v in r] for r in want]
    assert sum(len(r) for r in got) == 35
    if use_f64:
        assert counters.gq_host_verified == 0


# --- the f32 stability guard (TestF32StabilityGuard's ports) --------------


def make_read(pos, seq):
    return SAMRecord(
        qname="r", flag=99, rname="chrM", pos=pos, mapq=60,
        cigar=parse_cigar(f"{len(seq)}M"), rnext="=", pnext=pos,
        tlen=len(seq), seq=seq, qual="I" * len(seq),
    )


def _region(lik):
    ref = "ACGT" * 25
    pos = 50
    alt = ref[:pos] + ("G" if ref[pos] != "G" else "C") + ref[pos + 1:]
    origin = Interval("chrM", 0, 100)
    h_ref = Haplotype(ref)
    h_ref.cigar = parse_cigar("100M")
    h_alt = Haplotype(alt)
    h_alt.cigar = parse_cigar("100M")
    reads = [make_read(1, ref[:80]) for _ in range(lik.shape[0])]
    return (reads, [h_ref, h_alt], lik, ref, origin, origin)


def test_exact_tie_is_flagged_and_host_identical():
    """Every read scores both alleles -1.0: the three genotype totals tie
    (near-)exactly, the f32 argmax cannot be proven stable, the guard
    flags the site and the host recompute emits the host engine's row
    (later ties win: 1/1)."""
    lik = np.full((12, 2), -1.0, dtype=np.float64)
    region = _region(lik)
    host = gt.assign_genotype_likelihoods(*region, DEFAULT_CONFIG)
    counters = RunCounters()
    dev = gt.genotype_regions_device([region], CUDA_CFG, device="cpu",
                                     use_f64=False, counters=counters)[0]
    assert counters.gq_host_verified >= 1
    assert [v.to_vcf_row() for v in dev] == [v.to_vcf_row() for v in host]
    assert dev and dev[0].gt == (1, 1)


def test_random_regions_host_identical():
    """Random likelihood matrices: the f32 path and the per-region entry
    (assign_genotype_likelihoods with the cuda engine, f64) emit the host
    engine's rows."""
    rng = np.random.default_rng(20260819)
    counters = RunCounters()
    for _ in range(8):
        n = int(rng.integers(4, 40))
        lik = (rng.random((n, 2)) * -12.0).round(3)
        region = _region(lik)
        host = [v.to_vcf_row() for v in gt.assign_genotype_likelihoods(
            *region, DEFAULT_CONFIG)]
        f32 = gt.genotype_regions_device([region], CUDA_CFG, device="cpu",
                                         use_f64=False, counters=counters)[0]
        f64 = gt.assign_genotype_likelihoods(*region, CUDA_CFG, device="cpu")
        assert [v.to_vcf_row() for v in f32] == host
        assert [v.to_vcf_row() for v in f64] == host


def test_chrm_golden_with_f32_device_genotyper(tmp_path, monkeypatch):
    """The whole chrM pipeline with the genotyper forced onto the f32
    path: byte-identical golden VCF."""
    real = gt.genotype_regions_device

    def f32_regions(region_inputs, cfg, **kwargs):
        return real(region_inputs, cfg, **{**kwargs, "use_f64": False})

    monkeypatch.setattr(gt, "genotype_regions_device", f32_regions)
    out = tmp_path / "g32.vcf"
    counters = RunCounters()
    call_batched(SAM, FASTA, str(out), CUDA_CFG, device="cpu",
                 counters=counters)
    assert out.read_text() == open(GOLDEN).read()
    assert counters.variants == 35


def test_f32_total_bound_matches_reference():
    m = np.array([0.5, 40.4, 3000.0])
    n = np.array([1, 30, 2000])
    np.testing.assert_array_equal(gt._f32_total_bound(m, n),
                                  jax_gt._f32_total_bound(m, n))


def test_genotyper_engine_is_validated_and_needs_a_card():
    with pytest.raises(ValueError, match="genotyper_engine"):
        HCConfig(genotyper_engine="jax")
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call_batched(SAM, FASTA, None, CUDA_CFG, region_filter=lambda i: i < 4)
    assert math.isinf(gc.lowest(torch.float32))
    assert gc.lowest(torch.float64) == -np.finfo(np.float64).max
