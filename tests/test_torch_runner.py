"""TorchPairHMMRunner on the CPU (the kernel's plain version) against the
reference package's NativePairHMMRunner, bit for bit: the cases of
tests/test_pallas.py::TestRunner."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.ops.runner import NativePairHMMRunner as JaxNativeRunner
from gatk_hc_tpu.ops.runner import PairHMMJob as JaxJob
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
from tests.test_pairhmm import make_pair, to_bytes

TINY_CFG = dataclasses.replace(
    DEFAULT_CONFIG, read_pad_buckets=(32,), hap_pad_buckets=(128,)
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the plain versions (many small ops), in every
    port test file that runs the runner on the CPU (they import this
    fixture): with several test processes on one host, OpenMP teams spin on
    each other and a run that takes seconds alone takes minutes.  The
    runner's dispatch worker inherits it."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny_runner(pair_budget=256):
    runner = TorchPairHMMRunner(TINY_CFG, device="cpu", pair_budget=pair_budget)
    runner.READ_BUCKETS = (8, 16)
    runner.HAP_BUCKETS = (8, 16)
    return runner


def make_job(rng, n_reads, n_haps):
    reads, haps = [], []
    for _ in range(n_reads):
        read, quals, _ = make_pair(rng, rng.randint(10, 30), 60, 1)
        reads.append((to_bytes(read), to_bytes(quals)))
    for _ in range(n_haps):
        _, _, hap = make_pair(rng, 10, rng.randint(40, 100), 0)
        haps.append(to_bytes(hap))
    return PairHMMJob(reads, haps)


def reference_results(jobs, f64_rescue="sentinel"):
    """The reference package's C++ engine on the same jobs."""
    cfg = dataclasses.replace(JAX_DEFAULT_CONFIG, f64_rescue=f64_rescue)
    ref = [JaxJob(job.reads, job.haps) for job in jobs]
    JaxNativeRunner(cfg).run(ref)
    return [r.result for r in ref]


@pytest.fixture
def rng():
    return random.Random(1234)


def test_single_job_bitexact(rng):
    job = make_job(rng, 3, 2)
    tiny_runner().run([job])
    assert job.result.shape == (3, 2)
    np.testing.assert_array_equal(job.result, reference_results([job])[0])


@pytest.mark.parametrize("f64_rescue", ["sentinel", "exact"])
def test_underflow_rescue_matches_reference(f64_rescue):
    """Unrelated reads underflow MIN_ACCEPTED; both rescue modes finalize
    them exactly as the reference does."""
    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = [
        (acgt[rng.integers(0, 4, 60)], np.full(60, 73, np.uint8))
        for _ in range(3)
    ]
    haps = [acgt[rng.integers(0, 4, 90)] for _ in range(2)]
    job = PairHMMJob(reads, haps)
    cfg = dataclasses.replace(TINY_CFG, f64_rescue=f64_rescue,
                              read_pad_buckets=(64,))
    TorchPairHMMRunner(cfg, device="cpu").run([job])
    want = reference_results([job], f64_rescue)[0]
    assert (want < -64).all()  # every pair was rescued
    np.testing.assert_array_equal(job.result, want)


def test_multi_job_grouping(rng):
    jobs = [make_job(rng, 2, 2), make_job(rng, 3, 1), make_job(rng, 1, 4)]
    runner = tiny_runner()
    runner.run(jobs)
    want = reference_results(jobs)
    for job, ref in zip(jobs, want):
        np.testing.assert_array_equal(job.result, ref)
        # independent of grouping: a solo run of each job gives the same
        solo = PairHMMJob(job.reads, job.haps)
        tiny_runner().run([solo])
        np.testing.assert_array_equal(job.result, solo.result)


def test_group_planning_budgets(rng):
    runner = tiny_runner()
    runner.pair_budget = 8  # logic-only
    jobs = [make_job(rng, 2, 2) for _ in range(4)]  # 4 pairs each
    groups = runner._plan_groups(jobs)
    assert all(
        sum(len(jobs[g].reads) * len(jobs[g].haps) for g in grp) <= 8
        for grp in groups
    )
    assert sorted(g for grp in groups for g in grp) == [0, 1, 2, 3]
    runner = tiny_runner()
    runner.READ_BUCKETS = (4,)  # unique-read budget cuts groups too
    groups = runner._plan_groups([make_job(rng, 3, 1) for _ in range(3)])
    assert [len(g) for g in groups] == [1, 1, 1]


def test_oversized_job_multiple_dispatches(rng):
    runner = tiny_runner(pair_budget=128)
    runner.READ_BUCKETS = (16,)
    runner.HAP_BUCKETS = (16,)
    job = make_job(rng, 12, 11)  # 132 pairs > budget 128 -> 2 launches
    runner.run([job])
    assert runner.dispatch_counts["planes"] == 2
    assert job.result.shape == (12, 11)
    np.testing.assert_array_equal(job.result, reference_results([job])[0])


def test_empty_job():
    job = PairHMMJob([], [])
    tiny_runner().run([job])
    assert job.result.shape == (0, 0)


def test_submit_drain_and_stage_times(rng):
    """Two submits in flight before one drain, as call_batched does; every
    group gets a time for each stage."""
    runner = tiny_runner()
    a = [make_job(rng, 2, 3)]
    b = [make_job(rng, 4, 2), make_job(rng, 1, 1)]
    tokens = [runner.submit(a), runner.submit(b)]
    assert all(job.result is None for job in a + b)
    runner.drain(tokens)
    for job, ref in zip(a + b, reference_results(a + b)):
        np.testing.assert_array_equal(job.result, ref)
    med = runner.stage_medians()
    assert med["groups"] == 2 and med["device"] == "cpu"
    # the ppe kernel reads the unique rows itself: no stage between H2D
    # and kernel
    assert {"pack", "h2d", "kernel", "finalize"} <= set(med)
    assert "gather" not in med
