"""Reads longer than the largest read bucket (224) through the port against
the JAX package: 250 bp reads (2x250 kits) pad to r_pad 256 and 300 bp
reads (MiSeq 2x300) to 304 on the ppe path and to 320 on the striped path
(a multiple of the stripe height), where the ppe kernel runs in stripes
with a carry.  The fixtures come from the port's make_fixture with
--read-length; the device runner runs its kernels' plain versions on CPU
tensors."""

import contextlib
import dataclasses
import io
import json
import random

import numpy as np
import pytest

from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.ops.runner import PairHMMJob as JaxPairHMMJob
from gatk_hc_tpu.parallel import sharded_step as jax_sharded
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.models.caller import call_batched
from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
from gatk_hc_tpu_torch.parallel.sharded_step import ShardMapPairHMMRunner
from gatk_hc_tpu_torch.tools import fuzz_differential as fz
from gatk_hc_tpu_torch.tools import make_fixture
from tests.test_torch_runner import one_torch_thread  # noqa: F401 - autouse
from tests.test_torch_tools import jax_native_vcf, reference_tool

REGIONS = 12  # the first 12 of the 6 kb contig's 25 regions


def sam_records(path):
    with open(path) as handle:
        return [line.rstrip("\n").split("\t") for line in handle
                if not line.startswith("@")]


@pytest.fixture(scope="module")
def long_fixtures(tmp_path_factory):
    """read length -> (sam, fasta, the JAX package's native VCF text over
    the first REGIONS regions): a 6 kb contig at 20x."""
    made = {}
    for read_len in (250, 300):
        d = tmp_path_factory.mktemp(f"reads{read_len}")
        make_fixture.main([str(d), "--length", "6000", "--depth", "20",
                           "--read-length", str(read_len), "--name", "lr"])
        sam, fasta = str(d / "lr.sam"), str(d / "lr.fa")
        ref = jax_native_vcf(sam, fasta, str(d / "ref.vcf"),
                             region_filter=lambda i: i < REGIONS)
        with open(ref) as handle:
            made[read_len] = (sam, fasta, handle.read())
    return made


def test_simulate_reads_151_is_the_reference_tools():
    """At the default length the port's simulator draws the JAX package's
    tools/make_fixture.py reads, line for line."""
    ref_tool = reference_tool("make_fixture")
    rng = random.Random(5)
    ref = make_fixture.make_reference(rng, 3000)
    alt, _, anchors = make_fixture.plant_variants(rng, ref)
    state = rng.getstate()
    want = ref_tool.simulate_reads(random.Random(9), "c", ref, alt, 10,
                                   anchors=anchors)
    for kw in ({}, {"read_len": 151}):
        got = make_fixture.simulate_reads(random.Random(9), "c", ref, alt, 10,
                                          anchors=anchors, **kw)
        assert got == want
    assert rng.getstate() == state


@pytest.mark.parametrize("read_len", [250, 300])
def test_fixture_reads_have_the_length(long_fixtures, read_len):
    """Every read has read_len bases and qualities, a read_len-M CIGAR and
    the TLEN the mate position gives."""
    records = sam_records(long_fixtures[read_len][0])
    assert len(records) == 20 * 6000 // read_len
    for rec in records:
        pos, cigar, pnext, tlen = int(rec[3]), rec[5], int(rec[7]), int(rec[8])
        assert len(rec[9]) == len(rec[10]) == read_len
        assert cigar == f"{read_len}M"
        assert tlen == pnext - pos + read_len


@pytest.mark.parametrize("read_len,algo,dispatch,r_pad,label", [
    (250, "ppe", "adaptive", 256, "planes"),
    (300, "ppe", "adaptive", 304, "planes"),
    (250, "ppe", "packed", 256, "packednib"),
    (300, "ppe", "packed", 304, "packednib"),
    (250, "striped", "adaptive", 256, "striped"),
    (300, "striped", "adaptive", 320, "striped"),
])
def test_long_reads_write_the_reference_vcf(long_fixtures, read_len, algo,
                                            dispatch, r_pad, label):
    """The cuda engine's runner writes the JAX package's VCF text, with its
    groups at the long-read r_pad (ppe 256 / 304, striped 256 / 320)."""
    sam, fasta, want = long_fixtures[read_len]
    cfg = dataclasses.replace(DEFAULT_CONFIG, pallas_algo=algo,
                              dispatch_mode=dispatch)
    runner = TorchPairHMMRunner(cfg, device="cpu")
    out = f"{sam[:-4]}.{algo}.{dispatch}.vcf"
    results = call_batched(sam, fasta, out, cfg, runner=runner,
                           region_filter=lambda i: i < REGIONS)
    with open(out) as handle:
        assert handle.read() == want
    assert sum(len(r.variants) for r in results) > 0
    assert {r for r, _ in runner.bucket_counts} == {r_pad}
    assert runner.dispatch_counts == {label: 1}


def test_shardmap_bucket_limit_is_shared():
    """A 300 bp read is past the largest read bucket: both packages'
    sharded steps raise the same ValueError before any launch."""
    rng = np.random.default_rng(3)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), 300)
    quals = np.full(300, 40, np.uint8)
    hap = rng.choice(np.frombuffer(b"ACGT", np.uint8), 415)
    msg = "value 300 exceeds largest bucket 224"
    port = ShardMapPairHMMRunner(DEFAULT_CONFIG, device="cpu")
    with pytest.raises(ValueError, match=msg):
        port.run([PairHMMJob([(bases, quals)], [hap])])
    ref = jax_sharded.ShardMapPairHMMRunner(
        JAX_DEFAULT_CONFIG, mesh=jax_sharded.make_mesh(2, hap_parallel=1))
    with pytest.raises(ValueError, match=msg):
        ref.run([JaxPairHMMJob([(bases, quals)], [hap])])


def test_fuzzer_default_arms_drop_shardmap_past_the_buckets(tmp_path,
                                                            monkeypatch):
    """Past the largest read bucket the default arms drop shardmap and the
    seed's line says why (run_seed and main); at 151 bp nothing is dropped;
    an explicit shardmap arm at 300 bp fails with the package's own
    ValueError."""
    assert fz.default_arms(151) == (fz.ARMS, {})
    arms, dropped = fz.default_arms(250)
    assert "shardmap" not in arms and set(arms) | {"shardmap"} == set(fz.ARMS)
    assert dropped == {"shardmap": "reads past the largest read bucket "
                                   "raise in both packages"}
    # the defaults, cut to two cheap arms and shardmap
    monkeypatch.setattr(fz, "ARMS", ("native", "stream", "shardmap"))
    row = fz.run_seed(1040, str(tmp_path / "keep"), length=1500, depth=6,
                      device="cpu", read_len=250)
    assert row["ok"] and row["read_length"] == 250
    assert sorted(row["arm_s"]) == ["native", "stream"]
    assert row["dropped"] == dropped
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fz.main(["--device", "cpu", "--length", "1500", "--depth", "6",
                 "--read-length", "250", "--count", "1", "--start", "1040",
                 "--keep-dir", str(tmp_path / "keep")])
    line, summary = [json.loads(x) for x in out.getvalue().splitlines()]
    assert line["dropped"] == dropped and line["read_length"] == 250
    assert summary["arms"] == ["native", "stream"] and summary["fuzz_ok"]
    short = fz.run_seed(1040, str(tmp_path / "keep"), length=1500, depth=6,
                        device="cpu", arms=("native", "stream"))
    assert short["ok"] and "dropped" not in short
    with pytest.raises(ValueError, match="exceeds largest bucket 224"):
        fz.run_seed(1040, str(tmp_path / "keep"), ("native", "shardmap"),
                    length=1500, depth=6, device="cpu", read_len=300)


def test_chip_smoke_records_long_read_units(long_fixtures, monkeypatch):
    """chip_smoke.py's recording of the entry's launch units on a 300 bp
    run (on the CPU the entry runs its plain version): one tally per
    (r_pad, c_pad, source), and the kept first unit of each, run again
    through the plain version, gives the run's own result bit for bit."""
    import torch

    import chip_smoke
    from gatk_hc_tpu_torch.ops import pairhmm_front as pf

    first = {}
    real = pf.ppe_forward_unique

    def spy(path, segments, *args):
        out = real(path, segments, *args)
        first.setdefault((*segments[0].dims[2:], path), out.clone())
        return out

    monkeypatch.setattr(pf, "ppe_forward_unique", spy)
    sam, fasta, _want = long_fixtures[300]
    runner = TorchPairHMMRunner(DEFAULT_CONFIG, device="cpu")
    with chip_smoke.recording_front_units() as record:
        call_batched(sam, fasta, None, DEFAULT_CONFIG, runner=runner,
                     region_filter=lambda i: i < 4)
    assert pf.ppe_forward_unique is spy
    assert record["units"] == {(304, 448, "planes"): 1}
    assert sorted(record["inputs"]) == sorted(first)
    for key, (segs, tab, trans, nr) in record["inputs"].items():
        again = pf.ppe_forward_unique_plain(key[2], segs, tab, trans)
        assert torch.equal(again.view(torch.int32),
                           first[key].view(torch.int32))
        assert nr == DEFAULT_CONFIG.ppe_rows
