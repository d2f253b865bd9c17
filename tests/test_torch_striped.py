"""The port's striped PairHMM path on the CPU (the kernel's plain version,
which is what a CPU tensor runs) against the reference package: the FTZ
oracle and the port's ppe version bit for bit, the Pallas striped kernel in
interpret mode within stated bounds, the raw-byte glue exactly, and the
striped runner and CLI against the reference package's results."""

import contextlib
import dataclasses
import io
import json
import os
import random

import numpy as np
import pytest
import torch

from gatk_hc_tpu import cli as jax_cli
from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.ops import pairhmm_oracle as jax_oracle
from gatk_hc_tpu.ops import pairhmm_pallas as pallas
from gatk_hc_tpu.ops.runner import NativePairHMMRunner as JaxNativeRunner
from gatk_hc_tpu.ops.runner import PairHMMJob as JaxJob
from gatk_hc_tpu.utils.quality import BASE_TABLE, INITIAL_CONSTANT_F32, PH2PR_F32
from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG, HCConfig
from gatk_hc_tpu_torch.ops import pairhmm_striped as ps
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
from tests.test_pairhmm import make_pair, to_bytes
from tests.test_torch_pairhmm import ACGTN, TRANS, oracle, pair_major

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")

# The Pallas striped program is not exact in interpret mode: XLA:CPU
# contracts mul+add into FMA.  On the JAX tests' inputs at B = 256 (R 16,
# C 64) it equals the FTZ oracle on 62.9% of pairs (H = 8 and 16), at most
# 9.64e-7 relative off elsewhere, while the port equals the oracle bit for
# bit on every pair.  So the port is held to the oracle exactly and to the
# JAX program within rtol 1e-6 and an identical share just under the one
# measured on each input set (the share depends on the inputs: 0.629
# here, 0.574 for the dispatch test's, 0.531 for the unique test's).
PALLAS_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain(args, H):
    rc, omq, q3, rl, hc, hl, iy = (_t(a) for a in args)
    return ps.striped_forward_plain(rc, omq, q3, hc, rl, hl, iy, TRANS, H).numpy()


def _bits(a):
    return np.asarray(a).view(np.int32)


def edge_pairs(rng, H, R, C):
    """ASCII pairs whose read lengths sit at the stripe edges (1, H - 1, H,
    H + 1, R - 1, R), with N bases on both sides, reads drawn from their
    haplotype with substitutions, and unrelated pairs (which underflow
    once the reads are long)."""
    lengths = sorted({n for n in (1, H - 1, H, H + 1, R - 1, R) if 1 <= n <= R})
    out = []
    for k, r in enumerate(lengths * 6):
        c = int(rng.integers(max(r, 8), C + 1))
        hap = ACGTN[rng.integers(0, 4, c)]
        hap[rng.random(c) < 0.03] = ord("N")
        if k % 3 == 2:
            read = ACGTN[rng.integers(0, 5, r)]
        else:
            s = int(rng.integers(0, c - r + 1))
            read = hap[s : s + r].copy()
            read[rng.random(r) < 0.05] = ACGTN[rng.integers(0, 4)]
            read[rng.random(r) < 0.03] = ord("N")
        qual = (rng.integers(2, 41, r) + 33).astype(np.uint8)
        out.append((read, qual, hap))
    return out


@pytest.mark.parametrize("n_stripes", [1, 3])
@pytest.mark.parametrize("H", [8, 16, 32])
def test_plain_equals_oracle_and_ppe_bitwise(H, n_stripes):
    """One stripe (r_pad = H) and three; rlen at the stripe edges; rlen 0
    and rlen > r_pad give 0."""
    R, C = H * n_stripes, H * n_stripes + 24
    rng = np.random.default_rng(100 * H + n_stripes)
    pairs = edge_pairs(rng, H, R, C)
    args = pair_major(pairs, R, C)
    got = _plain(args, H)
    want = oracle(pairs)
    assert (want > 0).any()
    if R >= 32:
        assert (want == 0).any()  # underflowed pairs
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ppe = pt.forward_batch(*args, TRANS, R, C, algo="ppe").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ppe))
    rc, omq, q3, rl, hc, hl, iy = args
    rl = rl.copy()
    rl[0], rl[1] = 0, R + 1
    out = _plain((rc, omq, q3, rl, hc, hl, iy), H)
    assert out[0] == 0 and out[1] == 0
    np.testing.assert_array_equal(_bits(out[2:]), _bits(want[2:]))


def test_plain_accepts_any_dividing_stripe():
    rng = np.random.default_rng(4)
    pairs = edge_pairs(rng, 6, 12, 30)
    args = pair_major(pairs, 12, 30)
    np.testing.assert_array_equal(_bits(_plain(args, 6)), _bits(oracle(pairs)))
    with pytest.raises(ValueError, match="divide"):
        _plain(args, 5)


@pytest.fixture(scope="module")
def pallas_case():
    """tests/test_pallas.py::TestPairPerElementKernel's inputs at B = 256,
    and the FTZ oracle on every pair."""
    nprng = np.random.default_rng(1234)
    B, R, C = 256, 16, 64
    rc = nprng.integers(0, 5, (B, R)).astype(np.int32)  # incl N=4
    q = nprng.integers(1, 40, (B, R))
    omq = (1.0 - PH2PR_F32[q + 33]).astype(np.float32)
    q3 = (PH2PR_F32[q + 33] / np.float32(3.0)).astype(np.float32)
    rl = nprng.integers(5, R + 1, B).astype(np.int32)
    hc = nprng.integers(0, 5, (B, C)).astype(np.int32)
    hl = nprng.integers(20, C + 1, B).astype(np.int32)
    iy = (np.float32(2.0**120) / hl.astype(np.float32)).astype(np.float32)
    acgtn = np.frombuffer(b"ACTGN", np.uint8)  # code -> byte
    want = np.array([
        np.float32(jax_oracle.pairhmm_prob(
            acgtn[rc[k, : rl[k]]], (q[k, : rl[k]] + 33).astype(np.uint8),
            acgtn[hc[k, : hl[k]]], ftz=True,
        ))
        for k in range(B)
    ], np.float32)
    return (rc, omq, q3, rl, hc, hl, iy), R, C, want


def _hold_to_pallas(got, ref, floor):
    np.testing.assert_allclose(got, ref, rtol=PALLAS_RTOL, atol=0)
    assert np.mean(got == ref) > floor


@pytest.mark.parametrize("H", [8, 16])
def test_matches_pallas_striped_interpret(H, pallas_case):
    import jax.numpy as jnp

    args, R, C, want = pallas_case
    ref = np.asarray(pallas._pallas_forward(
        *(jnp.asarray(a) for a in args), TRANS, R, C, H, True, algo="striped",
    ))
    got = _plain(args, H)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    _hold_to_pallas(got, ref, 0.62)


def test_forward_batch_algos_match_pallas_batch(pallas_case):
    """forward_batch is pairhmm_pallas_batch's counterpart: algo "striped"
    is held to it (interpret mode routes "auto" to striped there); "ppe"
    and "auto" (ppe at every shape in the port) give the same bits."""
    import jax.numpy as jnp

    args, R, C, want = pallas_case
    ref = np.asarray(pallas.pairhmm_pallas_batch(
        *(jnp.asarray(a) for a in args), TRANS, r_pad=R, c_pad=C, stripe=8,
        interpret=True,
    ))
    striped = pt.forward_batch(*args, TRANS, R, C, stripe=8, algo="striped")
    _hold_to_pallas(striped.numpy(), ref, 0.62)
    for algo in ("ppe", "auto"):
        got = pt.forward_batch(*args, TRANS, R, C, 4, algo=algo).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(striped.numpy()))
    np.testing.assert_array_equal(_bits(striped.numpy()), _bits(want))
    with pytest.raises(ValueError, match="algo"):
        pt.forward_batch(*args, TRANS, R, C, algo="wavefront")


def _raw_group(rng, nr_pad, nh_pad, r_pad, c_pad, any_byte=True):
    """A group's raw shipping buffers, as the runner packs them: every byte
    value in reads / quals / haps (else ACGTN bases and Phred 2-40 quals),
    lengths, INITIAL / haplen."""
    if any_byte:
        read_u8 = rng.integers(0, 256, nr_pad * r_pad).astype(np.uint8)
        qual_u8 = rng.integers(0, 256, nr_pad * r_pad).astype(np.uint8)
        hap_u8 = rng.integers(0, 256, nh_pad * c_pad).astype(np.uint8)
    else:
        read_u8 = ACGTN[rng.integers(0, 5, nr_pad * r_pad)]
        qual_u8 = (rng.integers(2, 41, nr_pad * r_pad) + 33).astype(np.uint8)
        hap_u8 = ACGTN[rng.integers(0, 5, nh_pad * c_pad)]
    rlens = rng.integers(1, r_pad + 1, nr_pad).astype(np.int32)
    hlens = rng.integers(r_pad, c_pad + 1, nh_pad).astype(np.int32)
    iy = (INITIAL_CONSTANT_F32 / hlens.astype(np.float32)).astype(np.float32)
    u8buf = np.concatenate([read_u8, qual_u8, hap_u8])
    i32buf = np.concatenate([rlens, hlens, iy.view(np.int32)])
    return u8buf, i32buf


def _jax_tables():
    """The reference runner's device tables for the striped path
    (gatk_hc_tpu/ops/runner.py:344-347)."""
    return (
        BASE_TABLE.astype(np.int32),
        (np.float32(1.0) - PH2PR_F32).astype(np.float32),
        (PH2PR_F32 / np.float32(3.0)).astype(np.float32),
    )


def _assert_exact(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_striped_tables_equal_reference_runner_tables():
    _assert_exact(ps.striped_tables(BASE_TABLE, PH2PR_F32), _jax_tables())


def test_unpack_and_prepare_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    shape = (16, 8, 24, 64)  # nr_pad, nh_pad, r_pad, c_pad
    u8buf, i32buf = _raw_group(rng, *shape)
    tabs = ps.striped_tables(BASE_TABLE, PH2PR_F32)
    want = pallas._unpack_u8(
        jnp.asarray(u8buf), jnp.asarray(i32buf), *(jnp.asarray(t) for t in tabs),
        *shape,
    )
    got = ps.unpack_u8(_t(u8buf), _t(i32buf), *(_t(t) for t in tabs), *shape)
    _assert_exact([g.numpy() for g in got], want)
    jitted = pallas.prepare_tables_striped(
        jnp.asarray(u8buf), jnp.asarray(i32buf), *(jnp.asarray(t) for t in tabs),
        nr_pad=shape[0], nh_pad=shape[1], r_pad=shape[2], c_pad=shape[3],
    )
    got = ps.prepare_tables_striped(_t(u8buf), _t(i32buf), *(_t(t) for t in tabs),
                                    *shape)
    _assert_exact([g.numpy() for g in got], jitted)


def test_dispatch_pairs_striped_matches_jax():
    """The per-chunk pair gather equals jnp.take exactly; the dispatch
    equals the port's ppe forward on the same pairs bit for bit and is
    held to the reference dispatch (interpret mode) within the bounds."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    nr_pad, nh_pad, r_pad, c_pad, B = 16, 8, 16, 64, 256
    u8buf, i32buf = _raw_group(rng, nr_pad, nh_pad, r_pad, c_pad, any_byte=False)
    tabs = ps.striped_tables(BASE_TABLE, PH2PR_F32)
    pairs = np.stack([
        rng.integers(0, nr_pad, B), rng.integers(0, nh_pad, B)
    ]).astype(np.int32)
    tables = ps.prepare_tables_striped(
        _t(u8buf), _t(i32buf), *(_t(t) for t in tabs), nr_pad, nh_pad, r_pad, c_pad
    )
    gathered = ps.gather_pairs_striped(*tables, _t(pairs))
    pr, ph = pairs
    want = [np.asarray(jnp.take(jnp.asarray(t.numpy()), jnp.asarray(idx), axis=0))
            for t, idx in zip(tables, (pr, pr, pr, ph, pr, ph, ph))]
    want = [want[k] for k in (0, 1, 2, 3)] + want[4:]
    _assert_exact([g.numpy() for g in gathered], want)
    got = ps.dispatch_pairs_striped(*tables, _t(pairs), TRANS, r_pad, c_pad, 8)
    ppe = pt.forward_batch(*[g.numpy() for g in gathered[:3]], gathered[4].numpy(),
                           gathered[3].numpy(), gathered[5].numpy(),
                           gathered[6].numpy(), TRANS, r_pad, c_pad, 4, algo="ppe")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ppe.numpy()))
    jtables = pallas.prepare_tables_striped(
        jnp.asarray(u8buf), jnp.asarray(i32buf), *(jnp.asarray(t) for t in tabs),
        nr_pad=nr_pad, nh_pad=nh_pad, r_pad=r_pad, c_pad=c_pad,
    )
    ref = np.asarray(pallas.dispatch_pairs_striped(
        *jtables, jnp.asarray(pairs), TRANS, r_pad=r_pad, c_pad=c_pad,
        stripe=8, interpret=True,
    ))
    _hold_to_pallas(got.numpy(), ref, 0.56)


def test_pairhmm_unique_matches_jax():
    """Unique ASCII reads and haplotypes, pairs expanded on the device:
    bit-exact to the oracle, held to pairhmm_pallas_unique."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    nr, nh, r_pad, c_pad, B = 24, 10, 16, 64, 256
    reads, quals, haps = [], [], []
    for _ in range(nh):
        c = int(rng.integers(40, c_pad + 1))
        hap = ACGTN[rng.integers(0, 4, c)]
        hap[rng.random(c) < 0.03] = ord("N")
        haps.append(hap)
    for k in range(nr):
        r = int(rng.integers(8, r_pad + 1))
        hap = haps[k % nh]
        s = int(rng.integers(0, len(hap) - r + 1))
        read = hap[s : s + r].copy()
        read[rng.random(r) < 0.05] = ACGTN[rng.integers(0, 5)]
        reads.append(read)
        quals.append((rng.integers(2, 41, r) + 33).astype(np.uint8))
    read_u8 = np.zeros((nr, r_pad), np.uint8)
    qual_u8 = np.zeros((nr, r_pad), np.uint8)
    hap_u8 = np.zeros((nh, c_pad), np.uint8)
    for k in range(nr):
        read_u8[k, : len(reads[k])] = reads[k]
        qual_u8[k, : len(quals[k])] = quals[k]
    for k in range(nh):
        hap_u8[k, : len(haps[k])] = haps[k]
    rlens = np.array([len(r) for r in reads], np.int32)
    hlens = np.array([len(h) for h in haps], np.int32)
    iy = (INITIAL_CONSTANT_F32 / hlens.astype(np.float32)).astype(np.float32)
    pr = rng.integers(0, nr, B).astype(np.int32)
    ph = rng.integers(0, nh, B).astype(np.int32)
    tabs = ps.striped_tables(BASE_TABLE, PH2PR_F32)
    inputs = (read_u8, qual_u8, rlens, hap_u8, hlens, iy, pr, ph) + tabs
    got = ps.pairhmm_unique(*(_t(a) for a in inputs), TRANS, r_pad, c_pad).numpy()
    want = oracle([(reads[a], quals[a], haps[b]) for a, b in zip(pr, ph)])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref = np.asarray(pallas.pairhmm_pallas_unique(
        *(jnp.asarray(a) for a in inputs), TRANS, r_pad=r_pad, c_pad=c_pad,
        stripe=8, interpret=True,
    ))
    _hold_to_pallas(got, ref, 0.52)


def test_wrapper_checks_inputs():
    B, R, C = 4, 8, 16
    rc = torch.zeros((B, R), dtype=torch.int32)
    f = torch.zeros((B, R), dtype=torch.float32)
    hc = torch.zeros((B, C), dtype=torch.int32)
    lens = torch.ones(B, dtype=torch.int32)
    iy = torch.ones(B, dtype=torch.float32)
    with pytest.raises(TypeError):
        ps.striped_forward(rc, f, f, hc, lens, lens, lens, TRANS, 8)  # init_y
    with pytest.raises(ValueError):
        ps.striped_forward(rc, f, f, hc[:3], lens, lens, iy, TRANS, 8)
    with pytest.raises(ValueError):
        ps.striped_forward(rc, f, f.t().contiguous().t(), hc, lens, lens, iy,
                           TRANS, 8)
    with pytest.raises(ValueError):
        ps.striped_forward(rc[:, :6].contiguous(), f, f, hc, lens, lens, iy,
                           TRANS, 8)
    before = dict(pt.LAUNCHES)
    out = ps.striped_forward(rc, f, f, hc, lens, lens, iy, TRANS, 8)  # CPU: plain
    assert out.shape == (B,) and pt.LAUNCHES == before


def test_config_validates_striped_keys():
    assert (DEFAULT_CONFIG.pallas_algo, DEFAULT_CONFIG.stripe_height) == ("ppe", 32)
    assert DEFAULT_CONFIG.stripe_height == JAX_DEFAULT_CONFIG.stripe_height
    assert DEFAULT_CONFIG.pallas_algo == JAX_DEFAULT_CONFIG.pallas_algo
    with pytest.raises(ValueError, match="pallas_algo"):
        HCConfig(pallas_algo="auto")
    with pytest.raises(ValueError, match="stripe_height"):
        dataclasses.replace(DEFAULT_CONFIG, stripe_height=12)


# ---------------------------------------------------------------------------
# The striped runner and CLI.

STRIPED_CFG = dataclasses.replace(
    DEFAULT_CONFIG, read_pad_buckets=(20,), hap_pad_buckets=(128,),
    pallas_algo="striped", stripe_height=8,
)


def make_job(rng, n_reads, n_haps):
    reads, haps = [], []
    for _ in range(n_reads):
        read, quals, _ = make_pair(rng, rng.randint(10, 30), 60, 1)
        reads.append((to_bytes(read), to_bytes(quals)))
    for _ in range(n_haps):
        _, _, hap = make_pair(rng, 10, rng.randint(40, 100), 0)
        haps.append(to_bytes(hap))
    return PairHMMJob(reads, haps)


def small_runner(cfg, pair_budget=256):
    runner = TorchPairHMMRunner(cfg, device="cpu", pair_budget=pair_budget)
    runner.READ_BUCKETS = (16,)
    runner.HAP_BUCKETS = (16,)
    return runner


def reference_results(jobs):
    ref = [JaxJob(job.reads, job.haps) for job in jobs]
    JaxNativeRunner(JAX_DEFAULT_CONFIG).run(ref)
    return [r.result for r in ref]


def test_striped_runner_matches_ppe_runner_and_reference():
    """A multi-chunk group (132 pairs over a 128-pair budget) and a few
    small jobs: the striped runner's results equal the ppe runner's and the
    reference package's C++ runner's, bit for bit."""
    rng = random.Random(1234)
    jobs = [make_job(rng, 12, 11), make_job(rng, 2, 3), make_job(rng, 3, 1)]
    runner = small_runner(STRIPED_CFG, pair_budget=128)
    runner.run(jobs)
    assert runner.dispatch_counts == {"striped": 3}  # 2 chunks + 1 group
    ppe_jobs = [PairHMMJob(j.reads, j.haps) for j in jobs]
    small_runner(dataclasses.replace(STRIPED_CFG, pallas_algo="ppe"),
                 pair_budget=128).run(ppe_jobs)
    for job, ppe, ref in zip(jobs, ppe_jobs, reference_results(jobs)):
        np.testing.assert_array_equal(job.result, ppe.result)
        np.testing.assert_array_equal(job.result, ref)
    med = runner.stage_medians()
    # the entry reads the shipped rows itself: no stage between H2D and
    # kernel
    assert {"pack", "h2d", "kernel", "finalize"} <= set(med)
    assert "gather" not in med and "gather" not in med["sum_ms"]


def test_striped_runner_rounds_rows_to_the_stripe():
    """r_pad rounds up to a multiple of the stripe height: bucket 20 -> 24
    at stripe 8, reads past the buckets -> the next multiple of 16 at
    stripe 16, where the ppe runner rounds to 8."""
    rng = random.Random(5)
    short = PairHMMJob([(to_bytes("ACGTACGTACGTACGTAC"), to_bytes("I" * 18))],
                       [to_bytes("ACGTACGTACGTACGTACGTACGT")])
    long_ = make_job(rng, 3, 2)
    cases = [(STRIPED_CFG, short, 24), (STRIPED_CFG, long_, None),
             (dataclasses.replace(STRIPED_CFG, stripe_height=16), short, 32)]
    for cfg, job, want in cases:
        runner = small_runner(cfg)
        r_pad, _ = runner._pads_for_group([job], [0])
        assert r_pad % cfg.stripe_height == 0
        if want is not None:
            assert r_pad == want
        runner.run([job])
        np.testing.assert_array_equal(job.result, reference_results([job])[0])
    ppe_runner = small_runner(dataclasses.replace(STRIPED_CFG, pallas_algo="ppe"))
    assert ppe_runner._pads_for_group([short], [0])[0] == 24
    assert ppe_runner._pads_for_group(
        [PairHMMJob([(to_bytes("A" * 26), to_bytes("I" * 26))],
                    [to_bytes("A" * 30)])], [0])[0] == 32


def test_cli_striped_on_cpu_matches_reference(tmp_path):
    """--pallas-algo striped --device cpu on chrM:0-1500 writes the
    reference package's VCF text, and --stats shows striped dispatches."""
    sam, fasta = os.path.join(FIXTURES, "chrM.sam"), os.path.join(FIXTURES, "chrM.fa")
    ref = tmp_path / "ref.vcf"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_cli.main(["-I", sam, "-R", fasta, "-O", str(ref),
                             "--pairhmm", "native", "-L", "chrM:0-1500"]) == 0
    out = tmp_path / "port.vcf"
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["-I", sam, "-R", fasta, "-O", str(out), "--device", "cpu",
                       "-L", "chrM:0-1500", "--pallas-algo", "striped", "--stats"])
    assert rc == 0
    assert out.read_text() == ref.read_text()
    stats = json.loads(stdout.getvalue().splitlines()[0])
    assert stats["dispatch_profile"] == {"striped": stats["device_stages_ms"]["groups"]}
    assert stats["variants"] > 0
