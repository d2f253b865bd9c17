"""The shard cell's yardstick on the CPU: the shard generator against its
model and the port's truth measure, and the driver's verdict on a tiny
shard through the runner's plain PyTorch kernels, sound and with each
fault the cell can have: two regions' results swapped, one job's
likelihoods moved by 0.01 log10, one VCF record dropped, and, in both
the program's and the C++ engine's VCF alike, every other region
skipped or records written far from any planted variant."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT
from hcbench import run, shard_gen

# loaded as the harness loads a driver: by path, outside sys.modules
caller_shard = run.load_module("drivers", "caller_shard")
SEED = 2 ** 31 + 11


def cell(shard_bp=6000):
    config = run.load_json("configs", "shard30x_2x151")
    traffic = run.load_json("traffic", "human")
    config["shard_bp"] = shard_bp
    return config, traffic


def sam_rows(shard):
    with open(shard.sam) as handle:
        return [line.rstrip("\n").split("\t") for line in handle
                if not line.startswith("@")]


def fasta_seq(shard):
    with open(shard.fasta) as handle:
        return "".join(line.strip() for line in handle
                       if not line.startswith(">"))


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    config, traffic = cell(200_000)
    return shard_gen.make_shard(config, traffic, SEED,
                                str(tmp_path_factory.mktemp("big")))


def test_the_same_seed_gives_the_same_bytes(tmp_path):
    config, traffic = cell(20_000)
    files = {}
    for name, seed in (("a", SEED), ("b", SEED), ("c", SEED + 1)):
        d = tmp_path / name
        d.mkdir()
        shard_gen.make_shard(config, traffic, seed, str(d))
        files[name] = [open(d / f, "rb").read() for f in
                       ("shard.fa", "shard.sam", "shard.truth.txt")]
    assert files["a"] == files["b"]
    assert all(x != y for x, y in zip(files["a"], files["c"]))


def test_the_shard_follows_the_model(big):
    config, traffic = cell(200_000)
    ref = fasta_seq(big)
    assert len(ref) == 200_000 and set(ref) == set("ACGT")
    rows = sam_rows(big)
    assert len(rows) == big.reads == 30 * 200_000 // 151
    pos = np.array([int(r[3]) for r in rows])
    assert (np.diff(pos) >= 0).all() and pos.min() >= 1
    assert {r[1] for r in rows} == {"99", "163"}
    assert {(r[2], r[4], r[5], r[6]) for r in rows} == {
        ("shard", "60", "151M", "=")}
    quals = np.frombuffer("".join(r[10] for r in rows).encode(),
                          np.uint8) - 33
    bases = np.frombuffer("".join(r[9] for r in rows).encode(), np.uint8)
    low = quals < 28
    assert quals.min() >= 5 and quals.max() <= 40
    assert not ((quals > 20) & low).any()
    # base errors: ~0.001 of the bases, each given Phred 5-20
    assert 0.0008 < low.mean() < 0.0012
    # a read matches the reference at its position, errors aside, unless
    # it comes from the donor's haplotype (half the reads) and spans one of
    # its variants (~152 of every ~500 bp): ~85% of the reads
    ref_b = np.frombuffer(ref.encode(), np.uint8)
    exact = sum(
        bool((bases[k * 151:(k + 1) * 151][~low[k * 151:(k + 1) * 151]]
              == ref_b[p - 1:p + 150][~low[k * 151:(k + 1) * 151]]).all())
        for k, p in enumerate(pos[:2000]))
    assert 0.78 < exact / 2000 < 0.92
    at = np.array([p for p, _, _ in big.truth])
    kinds = [k for _, k, _ in big.truth]
    assert at[0] == 500 and at[-1] < 200_000 - 500
    assert (np.diff(at) >= 300).all() and (np.diff(at) <= 700).all()
    assert 0.5 < kinds.count("snp") / len(kinds) < 0.7
    for p, kind, payload in big.truth:
        if kind == "snp":
            assert payload != ref[p] and payload in "ACGT"
        else:
            assert 1 <= (len(payload) if kind == "ins" else int(payload)) <= 4


def test_the_generator_imports_nothing_of_the_port():
    code = ("import sys; from hcbench import shard_gen; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith(('gatk_hc_tpu', 'torch', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_sensitivity_is_check_truths(big, tmp_path):
    from gatk_hc_tpu_torch.tools import check_truth

    rows = sam_rows(big)
    # a VCF with a record at most planted variants, one far from any
    called = [p + 1 for p, _, _ in big.truth[::3]] + [
        p + 3 for p, _, _ in big.truth[1::3]] + [100]
    text = "##fileformat=VCFv4.2\n" + "".join(
        f"shard\t{p}\t.\tA\tC\t50\tPASS\t.\tGT:GQ\t0/1:50\n"
        for p in sorted(called))
    vcf = tmp_path / "c.vcf"
    vcf.write_text(text)
    truth = tmp_path / "t.txt"
    truth.write_text("".join(f"{p}\t{k}\t{v}\n" for p, k, v in big.truth))
    ours = shard_gen.sensitivity(text, big.truth)
    theirs = check_truth.check(str(vcf), str(truth))
    assert rows and theirs["truth"] == ours["truth"]
    assert theirs["called_rows"] == ours["called_rows"]
    for key in ("sensitivity", "calls_within_5bp_of_truth"):
        assert theirs[key] == round(ours[key], 4)
    assert theirs["per_type"] == {k: round(v, 4)
                                  for k, v in ours["per_type"].items()}


@pytest.mark.parametrize("share,far,bad", [
    (0.995, 0, 0), (0.985, 0, 6), (1.0, 1, 0), (1.0, 5, 5)])
def test_the_truth_limits(big, share, far, bad):
    """Against the 0.99 limits on 401 planted variants: each region with
    a planted variant missed counts once the share called is below its
    limit, each with a record far from all once the share near is."""
    config, _ = cell(200_000)
    hit = big.truth[:round(share * len(big.truth))]
    rows = [p + 1 for p, _, _ in hit] + [
        p + 60 for p, _, _ in big.truth[:far * 3:3]]
    text = "".join(f"shard\t{p}\t.\tA\tC\t50\tPASS\t.\tGT\t0/1\n"
                   for p in sorted(rows))
    calls = len(rows)
    out, regions = caller_shard.truth_check(text, big.truth,
                                            config["check"], 245)
    assert out["sensitivity"] == pytest.approx(len(hit) / len(big.truth))
    assert out["far"] == far and out["missed"] == len(big.truth) - len(hit)
    assert out["calls_within_5bp_of_truth"] == pytest.approx(
        1 - far / calls)
    assert regions == out["regions_past_limit"] == bad


def verdict(config, traffic):
    record = caller_shard.run(config, traffic, SEED, 0.5, False, ["cpu"])
    return run.judge(record)[0], record


@pytest.fixture
def install(monkeypatch):
    """Replace the runner the build thread makes (ops/runner.py takes a
    TorchPairHMMRunner set on it)."""
    from gatk_hc_tpu_torch.ops import runner as runner_mod
    from gatk_hc_tpu_torch.ops import torch_runner

    def put(fault):
        class Faulty(torch_runner.TorchPairHMMRunner):
            def submit(self, jobs):
                handle = super().submit(jobs)
                self.__dict__.setdefault("jobs_of", {})[id(handle)] = jobs
                return handle

            def drain(self, batches):
                super().drain(batches)
                for b in batches:
                    fault(self.jobs_of.pop(id(b)))

        monkeypatch.setattr(runner_mod, "TorchPairHMMRunner", Faulty,
                            raising=False)

    return put


def test_a_sound_run_is_correct():
    correct, record = verdict(*cell())
    assert correct, record["check"]
    assert record["attempted"] > 8 and record["missing"] == 0
    check = record["check"]
    assert check["regions"] == record["program"]["passes"][0]["jobs"]
    assert check["vcf_regions_differing"] == 0
    assert check["truth"]["sensitivity"] > 0.9
    assert record["work"]["cells"] > 0 and record["spans_ms"]["assemble"] > 0


def test_two_regions_results_swapped(install):
    swapped = []

    def swap(jobs):
        shapes = {}
        for job in jobs:
            other = shapes.setdefault(job.result.shape, job)
            if other is not job:
                job.result, other.result = other.result, job.result
                swapped.append(job)
                return

    install(swap)
    correct, record = verdict(*cell())
    assert swapped and not correct
    assert record["check"]["regions_past_limit"] >= 2


def test_one_jobs_likelihoods_moved(install):
    def move(jobs):
        jobs[0].result = jobs[0].result + 0.01

    install(move)
    correct, record = verdict(*cell())
    assert not correct and record["missing"] == 0
    assert record["check"]["max_log10_gap"] == pytest.approx(0.01, rel=1e-2)


def test_one_vcf_record_dropped(monkeypatch):
    one_pass = caller_shard.one_pass

    def dropping(*args):
        p = one_pass(*args)
        with open(p.vcf) as handle:
            lines = handle.readlines()
        with open(p.vcf, "w") as handle:
            handle.writelines(lines[:-1])
        return p

    monkeypatch.setattr(caller_shard, "one_pass", dropping)
    correct, record = verdict(*cell())
    assert not correct
    # a region a pass, and the record's planted variant missed in (d)
    check = record["check"]
    assert check["vcf_regions_differing"] == check["passes_checked"] >= 2
    assert record["missing"] == check["passes_checked"] + check["truth"][
        "regions_past_limit"]
    assert record["check"]["vcf_records_differing"][0].startswith(
        "warm.vcf -shard\t")


def both_engines(monkeypatch, fault):
    """Give every ``call_batched`` the driver makes, the program's passes
    and the C++ engine's VCF alike, ``fault(kwargs, vcf)``."""
    port = caller_shard.port

    def faulty():
        p = port()
        call_batched = p.call_batched

        def call(sam, fasta, vcf, **kwargs):
            fault(kwargs, None)
            results = call_batched(sam, fasta, vcf, **kwargs)
            fault(kwargs, vcf)
            return results

        p.call_batched = call
        return p

    monkeypatch.setattr(caller_shard, "port", faulty)


def test_every_other_region_skipped_in_both(monkeypatch):
    def skip(kwargs, vcf):
        if vcf is None:
            kwargs["region_filter"] = lambda index: index % 2 == 0

    both_engines(monkeypatch, skip)
    correct, record = verdict(*cell())
    check = record["check"]
    assert not correct and check["vcf_regions_differing"] == 0
    assert check["max_log10_gap"] <= check["limit"]
    assert check["truth"]["sensitivity"] < 0.8
    assert record["missing"] == check["truth"]["regions_past_limit"] >= 3


def test_records_far_from_the_truth_in_both(monkeypatch):
    def spurious(kwargs, vcf):
        if vcf is None:
            return
        with open(vcf) as handle:
            lines = handle.readlines()
        out = []
        for k, line in enumerate(lines):
            out.append(line)
            if not line.startswith("#") and k % 4 == 0:
                f = line.split("\t")
                out.append("\t".join([f[0], str(int(f[1]) + 60)] + f[2:]))
        with open(vcf, "w") as handle:
            handle.writelines(out)

    both_engines(monkeypatch, spurious)
    correct, record = verdict(*cell())
    check = record["check"]
    assert not correct and check["vcf_regions_differing"] == 0
    assert check["truth"]["sensitivity"] >= 0.99
    assert check["truth"]["calls_within_5bp_of_truth"] < 0.9
    assert record["missing"] == check["truth"]["far"] >= 2


@pytest.mark.parametrize("stage", ["parse", "assemble", "pairhmm_wait",
                                   "genotype"])
def test_the_caller_readers(stage):
    key = {"pairhmm_wait": "pairhmm"}.get(stage, stage)
    record = {"work": {"cells": 4e9},
              "spans_ms": {"parse": 10.0, "assemble": 80.0, "pairhmm": 6.0,
                           "genotype": 12.0}}
    reader = run.load_module("metrics", f"caller.{stage}_ms_per_gcell")
    assert reader.read(record) == pytest.approx(
        record["spans_ms"][key] / 4.0)
    assert reader.read({"work": {"cells": 4e9}, "spans_ms": {}}) is None
    assert reader.read({"work": {"cells": 0}, "spans_ms": {key: 1.0}}) is None
    assert os.path.exists(os.path.join(
        ROOT, "hcbench", "metrics", f"caller.{stage}_ms_per_gcell.py"))


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_shard_run(traced):
    """The command on the card: one short run, plain and traced."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "-m", "hcbench.run", "--workload", "shard151.human",
         "--seed", str(SEED), "--seconds", "3", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    spec = run.load_spec(ROOT)
    want = {m["name"] for m in run.metrics_of(spec, "shard151.human",
                                               bool(traced))}
    assert set(result["metrics"]) == want
    check = result["program"]["check"]
    assert check["vcf_regions_differing"] == check["unanswered_jobs"] == 0
    if traced:
        assert {f"hc.caller.{s}" for s in ("parse", "assemble", "pairhmm",
                                           "genotype", "io")} <= set(
            result["program"]["trace_spans"])
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
