"""The port's correctness tools (gatk_hc_tpu_torch/tools: make_fixture,
check_truth, fuzz_differential, host_profile, scale_run) and multi-contig
streaming through the port's cuda runner, held against the JAX package's
tools and caller on the same inputs, on the CPU (the device arms through
the kernels' plain versions)."""

import contextlib
import dataclasses
import io
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.models.caller import call_batched as jax_call_batched
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.io.fasta import read_all_fasta
from gatk_hc_tpu_torch.io.vcf import read_vcf
from gatk_hc_tpu_torch.models.caller import call_batched, iter_windows
from gatk_hc_tpu_torch.ops.runner import TorchPairHMMRunner
from gatk_hc_tpu_torch.tools import check_truth, host_profile, make_fixture
from gatk_hc_tpu_torch.tools import fuzz_differential as fz
from gatk_hc_tpu_torch.tools import scale_run
from tests.test_multicontig import write_two_contig_fixture
from tests.test_torch_runner import one_torch_thread  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
FIXTURES = os.path.join(REPO, "fixtures")
SAM = os.path.join(FIXTURES, "chrM.sam")
FASTA = os.path.join(FIXTURES, "chrM.fa")


def reference_tool(name):
    """A module of the JAX package's tools/ (they import each other by bare
    name, as tests/test_accuracy.py does)."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return __import__(name)


def run_main(main, argv, monkeypatch):
    """A reference tool's main(), which reads sys.argv -> its stdout."""
    monkeypatch.setattr(sys, "argv", ["tool"] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    return out.getvalue()


def native_vcf(sam, fasta, out, **kw):
    cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native", **kw)
    call_batched(sam, fasta, out, cfg)
    return out


def jax_native_vcf(sam, fasta, out, region_filter=None, **kw):
    cfg = dataclasses.replace(JAX_DEFAULT_CONFIG, pairhmm_engine="native",
                              **kw)
    jax_call_batched(sam, fasta, out, cfg, region_filter=region_filter)
    return out


def read_bytes(path):
    with open(path, "rb") as handle:
        return handle.read()


@pytest.mark.parametrize("profile,contigs", [
    ("uniform", 1), ("homopolymer", 1), ("uniform", 3), ("homopolymer", 3),
])
def test_make_fixture_matches_reference(tmp_path, monkeypatch, profile,
                                        contigs):
    """Same seed -> the same SAM, FASTA and truth bytes as the JAX
    package's tools/make_fixture.py (several contigs: one process each)."""
    flags = ["--length", "3000", "--profile", profile, "--contigs",
             str(contigs), "--name", "fx", "--seed", "77"]
    run_main(reference_tool("make_fixture").main,
             [str(tmp_path / "ref")] + flags, monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        make_fixture.main([str(tmp_path / "port")] + flags)
    for name in ("fx.sam", "fx.fa", "fx.truth.txt"):
        assert read_bytes(tmp_path / "port" / name) == read_bytes(
            tmp_path / "ref" / name), name
    assert sorted(os.listdir(tmp_path / "port")) == [
        "fx.fa", "fx.sam", "fx.truth.txt"]


@pytest.mark.parametrize("contigs", [1, 2])
def test_check_truth_matches_reference(tmp_path, monkeypatch, contigs):
    """3-column (one contig) and 4-column (several) truth: the port's
    check() and main() give the reference tool's JSON line."""
    with contextlib.redirect_stdout(io.StringIO()):
        make_fixture.main([str(tmp_path), "--length", str(8000 // contigs),
                           "--contigs", str(contigs), "--name", "ct"])
    vcf = native_vcf(str(tmp_path / "ct.sam"), str(tmp_path / "ct.fa"),
                     str(tmp_path / "ct.vcf"))
    truth = str(tmp_path / "ct.truth.txt")
    columns = {len(line.split("\t")) for line in open(truth)}
    assert columns == {2 + contigs}
    want = run_main(reference_tool("check_truth").main, [vcf, truth],
                    monkeypatch)
    got = check_truth.check(vcf, truth)
    assert json.loads(want) == got
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check_truth.main([vcf, truth])
    assert out.getvalue() == want
    assert got["truth"] > 5 and got["sensitivity"] > 0.5


def test_fuzz_draw_is_the_references():
    """Seed N draws the same genome as the JAX package's fuzzer
    (tools/fuzz_differential.py run_seed's draw, in its order)."""
    for seed in range(1000, 1040):
        rng = random.Random(seed ^ 0x5EED)
        want = [rng.choice((6_000, 12_000, 20_000)), rng.choice((8, 18, 30)),
                rng.choice(("first", "seeded")), rng.choice((1, 1, 2, 3)),
                rng.choice(("uniform", "uniform", "homopolymer"))]
        got = fz.draw(seed)
        assert [got[k] for k in ("length", "depth", "mode", "contigs",
                                 "profile")] == want


@pytest.mark.parametrize("seed", [1040, 1019])
def test_fuzz_run_seed_matches_reference(tmp_path, seed):
    """Two tiny genomes (2 contigs uniform, 1 contig homopolymer) through
    the python, native, stream, cuda (plain ppe on the CPU) and diag arms:
    every VCF identical, equal to the JAX package's native arm on the same
    fixture, which the reference fuzzer's writer reproduces byte for
    byte."""
    arms = ("python", "native", "stream", "cuda", "diag")
    work = tmp_path / "port"
    work.mkdir()
    row = fz.run_seed(seed, str(tmp_path / "keep"), arms, length=3000,
                      depth=8, device="cpu", workdir=str(work))
    assert row["ok"] and not row["differ"], row
    assert row["variants"] > 0
    assert row["contigs"] == fz.draw(seed)["contigs"]
    assert not (tmp_path / "keep").exists()
    vcfs = {arm: read_bytes(work / f"{arm}.vcf") for arm in arms}
    assert len(set(vcfs.values())) == 1
    cuda = row["device"]["cuda"]
    assert cuda["buckets"] and sum(cuda["dispatch"].values()) >= 1
    assert cuda["kernel_launches"] == {}  # plain versions launch nothing

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_sam, ref_fa = reference_tool("fuzz_differential").write_fixture(
        str(ref_dir), seed, 3000, 8, row["contigs"], row["profile"])
    sam = work / f"fuzz{seed}.sam"
    assert read_bytes(ref_sam) == read_bytes(sam)
    assert read_bytes(ref_fa) == read_bytes(work / f"fuzz{seed}.fa")
    out = jax_native_vcf(ref_sam, ref_fa, str(ref_dir / "native.vcf"),
                         downsample_mode=row["mode"])
    assert read_bytes(out) == vcfs["native"]


def test_fuzz_other_device_arms_on_cpu(tmp_path):
    """The striped, streamed multi-threaded, shardmap (2x2 grid of CPU
    slots) and device-genotyper arms on a tiny 3-contig homopolymer
    genome: each VCF identical to native's; each arm reports its bucket
    shapes."""
    arms = ("native", "cuda_striped", "cuda_stream_mt", "shardmap",
            "genotyper_cuda")
    runners = fz.ArmRunners("cpu")
    row = fz.run_seed(1110, str(tmp_path / "keep"), arms, length=1500,
                      depth=8, device="cpu", runners=runners)
    assert row["ok"], row
    assert row["contigs"] == 3 and row["profile"] == "homopolymer"
    for arm in arms[1:]:
        assert row["device"][arm]["buckets"], arm
    assert row["device"]["cuda_striped"]["dispatch"] == {"striped": 1}
    grid = runners.get("shardmap").mesh
    assert dict(grid.shape) == {"data": 2, "hap": 2}
    # the runners live on: a second seed reuses them
    again = fz.run_seed(1110, str(tmp_path / "keep"), arms[:2], length=1500,
                        depth=8, device="cpu", runners=runners)
    assert again["ok"] and again["device"]["cuda_striped"]["dispatch"] == {
        "striped": 1}


def test_fuzz_main_keeps_a_divergence(tmp_path, monkeypatch):
    """main() prints one line per seed and the summary; an arm whose VCF
    differs stops the run with exit 1 and leaves the fixture and every
    arm's VCF in --keep-dir."""
    argv = ["--device", "cpu", "--length", "1500", "--depth", "4",
            "--arms", "native,stream", "--count", "2", "--start", "1040",
            "--keep-dir", str(tmp_path / "keep")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fz.main(argv)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["seed"] for r in lines[:2]] == [1040, 1041]
    assert lines[-1]["fuzz_ok"] and lines[-1]["seeds"] == 2

    real = fz.call_batched

    def broken(sam, fa, out_path, cfg, **kw):
        results = real(sam, fa, out_path, cfg, **kw)
        if cfg.stream_contigs:
            with open(out_path, "a") as handle:
                handle.write("fuzz0\t1\t.\tA\tC\t50\t.\t.\tGT\t0/1\n")
        return results

    monkeypatch.setattr(fz, "call_batched", broken)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as stop:
        fz.main(argv)
    assert stop.value.code == 1
    assert json.loads(out.getvalue().splitlines()[-1])["FAILED_SEED"] == 1040
    kept = sorted(os.listdir(tmp_path / "keep" / "seed1040"))
    assert kept == ["fuzz1040.fa", "fuzz1040.sam", "native.vcf",
                    "stream.vcf"]


def test_fuzz_device_arms_raise_without_card(tmp_path, monkeypatch):
    """--device cuda without a card: a device arm raises (no fallback to
    the CPU), whether its runner is built in a thread or at once."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arm in ("cuda", "diag", "shardmap"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fz.run_seed(1022, str(tmp_path / "keep"), ("native", arm),
                        length=1000, depth=4, device="cuda")
    with pytest.raises(SystemExit):  # argparse: unknown arm
        with contextlib.redirect_stderr(io.StringIO()):
            fz.main(["--arms", "native,jax"])


def _three_contigs(tmp_path):
    sam, fa = fz.write_fixture(str(tmp_path), 1116, 2000, 12, 3,
                               "homopolymer")
    return sam, fa


@pytest.mark.parametrize("case", ["two_contigs", "skip_middle_contig"])
def test_stream_contigs_through_cuda_runner(tmp_path, case):
    """stream_contigs through TorchPairHMMRunner(device="cpu") with 4 host
    threads: byte-identical to the JAX package's call_batched with native
    PairHMM, on tests/test_multicontig.py's two-contig fixture and on
    three contigs with every region of the middle one filtered out (its
    prefetched columns cancelled, no job of it in flight)."""
    region_filter = None
    if case == "two_contigs":
        sam, fa, _contigs = write_two_contig_fixture(tmp_path,
                                                     random.Random(99))
    else:
        sam, fa = _three_contigs(tmp_path)
        per = sum(1 for _ in iter_windows(
            "c", len(read_all_fasta(fa)[0].seq), DEFAULT_CONFIG))
        region_filter = lambda i: not per <= i < 2 * per  # noqa: E731
    cfg = dataclasses.replace(DEFAULT_CONFIG, stream_contigs=True,
                              host_threads=4)
    runner = TorchPairHMMRunner(cfg, device="cpu")
    out = str(tmp_path / "port.vcf")
    results = call_batched(sam, fa, out, cfg, runner=runner,
                           region_filter=region_filter, device="cpu")
    want = jax_native_vcf(sam, fa, str(tmp_path / "ref.vcf"),
                          region_filter=region_filter)
    assert read_bytes(out) == read_bytes(want)
    _, rows = read_vcf(out)
    chroms = {r.chrom for r in rows}
    if case == "two_contigs":
        assert chroms == {"ctgA", "ctgB"}
    else:
        assert chroms <= {"fuzz0", "fuzz2"} and "fuzz0" in chroms
    assert sum(runner.dispatch_counts.values()) >= 1
    assert sum(len(r.variants) for r in results) == len(rows)


def test_host_profile_matches_reference(monkeypatch):
    """chrM with the stub runner: the reference tool's regions,
    reads_parsed and stage keys; repeat and stream rows too."""
    want = json.loads(run_main(reference_tool("host_profile").main,
                               [SAM, FASTA], monkeypatch).splitlines()[-1])
    rows = host_profile.profile(SAM, FASTA, repeat=2)
    streamed = host_profile.profile(SAM, FASTA, threads=4, stream=True)[0]
    for got in rows + [streamed]:
        assert got["regions"] == want["regions"] == 68
        assert got["reads_parsed"] == want["reads_parsed"] == 3291
        assert set(got["stages"]) == set(want["stages"])
        assert set(got["host_profile"]) == set(want["host_profile"])
        assert got["host_profile"]["regions_assembled"] == 68
        assert set(got) == set(want)
    assert [r["rep"] for r in rows] == [0, 1]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        host_profile.main([SAM, FASTA, "--genotyper", "cuda", "--device",
                           "cpu"])
    assert json.loads(out.getvalue())["regions"] == 68


def _indel_window(ref, pos, kind, payload, run):
    """Positions where a planted indel may legally be called: from the
    leftmost equivalent placement to the run end (the caller left-aligns
    an indel within its homopolymer run)."""
    if kind == "ins":
        base = str(payload)[0]
    else:
        base = ref[pos + 1] if pos + 1 < len(ref) else ref[pos]
    start = pos + 1
    while start > 0 and ref[start - 1] == base:
        start -= 1
    start = min(start, pos)
    return set(range(start - 1, pos + run + 3)), start


def _score(ref, truth, rows, indel_window):
    """(sensitivity, per-kind sensitivity, near-truth precision) of the
    VCF rows against the planted truth, as tests/test_accuracy.py scores
    them."""
    called = {r.pos for r in rows}
    hits, near_truth, by_kind = 0, set(), {}
    for pos, kind, payload in truth:
        run = make_fixture._run_length(ref, pos)
        if kind == "snp":
            window = {pos, pos + 1, pos + 2}
            near_truth.update(range(pos - 2, pos + 6))
        else:
            window, start = indel_window(ref, pos, kind, payload, run)
            near_truth.update(range(start - 2, pos + run + 6))
        hit = bool(called & window)
        hits += hit
        total, good = by_kind.get(kind, (0, 0))
        by_kind[kind] = (total + 1, good + hit)
    far = sum(1 for r in rows if r.pos not in near_truth)
    return (hits / len(truth), {k: g / t for k, (t, g) in by_kind.items()},
            1.0 - far / max(len(rows), 1))


@pytest.mark.parametrize("profile", ["uniform", "homopolymer"])
def test_accuracy_equals_reference(tmp_path, monkeypatch, profile):
    """A 20 kb contig at 30x (tests/test_accuracy.py's simulator and seed,
    cut from 100 kb): the port's sensitivity, per-kind sensitivity and
    near-truth precision equal the JAX package's on the same fixture
    (native PairHMM both), and check_truth agrees with the reference's."""
    from gatk_hc_tpu.io.vcf import read_vcf as jax_read_vcf
    from tests.test_accuracy import _indel_window as jax_indel_window

    rng = random.Random(777)
    ref = make_fixture.make_reference(rng, 20_000, profile=profile)
    alt, truth, anchors = make_fixture.plant_variants(rng, ref,
                                                      profile=profile)
    lines = make_fixture.simulate_reads(rng, "sim", ref, alt, depth=30,
                                        anchors=anchors)
    fa = tmp_path / "sim.fa"
    make_fixture.write_fasta(str(fa), [make_fixture.FastaRecord(
        "sim", "accuracy fixture", ref)])
    sam = tmp_path / "sim.sam"
    with open(sam, "w") as handle:
        handle.write(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim\tLN:{len(ref)}\n")
        handle.write("".join(line + "\n" for line in lines))
    out = native_vcf(str(sam), str(fa), str(tmp_path / "port.vcf"),
                     assembler_engine="native")
    want = jax_native_vcf(str(sam), str(fa), str(tmp_path / "ref.vcf"),
                          assembler_engine="native")
    got = _score(ref, truth, read_vcf(out)[1], _indel_window)
    assert got == _score(ref, truth, jax_read_vcf(want)[1], jax_indel_window)
    assert len(truth) > 30 and got[0] > 0.9, got

    truth_file = tmp_path / "sim.truth.txt"
    truth_file.write_text("".join(f"{p}\t{k}\t{x}\n" for p, k, x in truth))
    text = run_main(reference_tool("check_truth").main,
                    [want, str(truth_file)], monkeypatch)
    assert check_truth.check(out, str(truth_file)) == json.loads(text)


def test_scale_run_on_cpu(tmp_path):
    """tools/scale_run.py at a tiny size on the CPU: two contigs
    streamed through cuda (plain versions) and native in their own
    processes, identical VCFs, the stats of each and check_truth."""
    out = tmp_path / "scale.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = scale_run.main(["--length", "2500", "--contigs", "2",
                             "--device", "cpu", "--out", str(out),
                             "--dir", str(tmp_path / "work")])
    row = json.loads(out.read_text())
    assert rc == 0 and row["identical"]
    assert row["cuda"]["engine"] == "cuda" and row["native"]["engine"] == (
        "native")
    regions = 2 * sum(1 for _ in iter_windows("c", 2500, DEFAULT_CONFIG))
    assert row["cuda"]["regions"] == row["native"]["regions"] == regions
    assert row["cuda"]["device_stages_ms"]["device"] == "cpu"
    assert row["check_truth"]["truth"] > 0 and row["nvidia_smi"] is None


def test_tools_import_without_jax():
    """The port's tools import and run with jax, the JAX package and the
    reference's bench.py and tools/ blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'gatk_hc_tpu', 'bench', 'tools'):\n"
        "    sys.modules[name] = None\n"
        "from gatk_hc_tpu_torch.tools import (_timing, bench, check_truth,"
        " fuzz_differential, genotyper_bench, host_profile, kernel_bench,"
        " make_fixture, scale_run, scaling_bench, sustained_sweep)\n"
        f"check_truth.main([{os.path.join(FIXTURES, 'chrM.golden.vcf')!r},"
        f" {os.path.join(FIXTURES, 'chrM.truth.txt')!r}])\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["sensitivity"] == 1.0
