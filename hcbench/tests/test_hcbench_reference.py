"""The plain reference, its comparison rule and its control."""

import math

import numpy as np
import pytest
import torch

from hcbench import gen, reference



def scalar_forward(read, qual, hap, scale):
    """The recurrence cell by cell in Python floats (float64)."""
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = reference.transitions()
    R, C = len(read), len(hap)
    M = [[0.0] * (C + 1) for _ in range(R + 1)]
    X = [[0.0] * (C + 1) for _ in range(R + 1)]
    Y = [[0.0] * (C + 1) for _ in range(R + 1)]
    for c in range(C + 1):
        Y[0][c] = scale / C
    for r in range(1, R + 1):
        q = 10.0 ** (-(qual[r - 1] & 127) / 10.0)
        for c in range(1, C + 1):
            a, b = read[r - 1], hap[c - 1]
            match = a == b or a == ord("N") or b == ord("N")
            e = 1.0 - q if match else q / 3.0
            M[r][c] = e * ((M[r - 1][c - 1] * p_mm + X[r - 1][c - 1] * p_gapm)
                           + Y[r - 1][c - 1] * p_gapm)
            X[r][c] = M[r - 1][c] * p_mx + X[r - 1][c] * p_xx
            Y[r][c] = M[r][c - 1] * p_my + Y[r][c - 1] * p_yy
    return sum(M[R][1:]) + sum(X[R][1:])


def random_jobs(seed, n_jobs=3):
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n_jobs):
        haps = [gen.ACGT[rng.integers(0, 4, rng.integers(9, 16))]
                for _ in range(rng.integers(1, 4))]
        lens = rng.integers(3, 9, rng.integers(1, 4))
        seq = gen.ACGT[rng.integers(0, 4, lens.sum())]
        seq[rng.integers(0, seq.size)] = ord("N")
        qual = rng.integers(40, 74, lens.sum()).astype(np.uint8)
        off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        jobs.append((seq, qual, off, haps))
    return jobs


def test_forward_is_the_recurrence():
    jobs = random_jobs(3)
    pairs = reference.PairSet(jobs)
    got = pairs.forward(torch.float64, reference.SCALE_F64, "cpu")
    want = []
    for seq, qual, off, haps in jobs:
        for i in range(off.size - 1):
            for hap in haps:
                want.append(scalar_forward(
                    seq[off[i]:off[i + 1]].tolist(),
                    qual[off[i]:off[i + 1]].tolist(), hap.tolist(),
                    reference.SCALE_F64))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_gap_rule():
    t = reference.THRESHOLD_LOG10
    answers = np.array([-10.0, reference.SENTINEL, reference.SENTINEL,
                        np.nan, -10.5])
    truth = np.array([-10.0 - 1e-6, t - 5.0, t + 0.25, -3.0, -10.0])
    gap = reference.gaps(answers, truth)
    np.testing.assert_allclose(gap[:3], [1e-6, 0.0, 0.25], atol=1e-12)
    assert gap[3] == math.inf
    assert gap[4] == pytest.approx(0.5)


def test_finalize_sentinel():
    out = reference.finalize(np.array([reference.MIN_ACCEPTED * 0.5,
                                       reference.SCALE_F32]))
    assert out[0] == reference.SENTINEL and out[1] == pytest.approx(0.0)


def program_answers(pool):
    """The port's runner on the CPU (the kernels' plain versions)."""
    from gatk_hc_tpu_torch.config import HCConfig
    from gatk_hc_tpu_torch.io.columnar import ReadPairs
    from gatk_hc_tpu_torch.ops.runner import PairHMMJob
    from gatk_hc_tpu_torch.ops.torch_runner import TorchPairHMMRunner

    jobs = [PairHMMJob(ReadPairs(s, q, o), h) for s, q, o, h in pool]
    TorchPairHMMRunner(HCConfig(), device="cpu").run(jobs)
    return np.concatenate([j.result.ravel() for j in jobs])


def test_reference_agrees_with_the_port_on_the_cpu(cell):
    config, traffic = cell
    pool = gen.make_pool(config, traffic, 77)[:8]
    pairs = reference.PairSet(pool)
    out = reference.check(pairs, program_answers(pool),
                          config["check"]["max_log10_gap"], "cpu",
                          [(o.size - 1) * len(h) for _, _, o, h in pool])
    assert out["pairs"] == len(pairs)
    assert out["sentinels"] > 0  # the sentinel rule is exercised
    assert out["max_log10_gap"] < 1e-4
    assert out["regions_past_limit"] == 0


def test_the_control_fails_the_limit(cell):
    """The reference in bfloat16 in the program's place reads past the
    limit (at this size too)."""
    config, traffic = cell
    pool = gen.make_pool(config, traffic, 78)
    pairs = reference.PairSet(pool)
    out = reference.check(pairs, reference.control_answers(pairs, "cpu"),
                          config["check"]["max_log10_gap"], "cpu")
    assert out["max_log10_gap"] > 3 * config["check"]["max_log10_gap"]


def test_rejects_bytes_it_does_not_model():
    seq = np.frombuffer(b"ACGX", np.uint8).copy()
    job = (seq, np.full(4, 60, np.uint8), np.array([0, 4]),
           [np.frombuffer(b"ACGTACGT", np.uint8)])
    with pytest.raises(ValueError):
        reference.PairSet([job])
