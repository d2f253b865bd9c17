"""The port's dispatch layer against the reference package: the packed and
nib glue in front of the ppe kernel (ops/pairhmm_packed.py, the plain half
of the kernel's unique-rows entry, ops/pairhmm_front.py), the nib
encoding, the path controller, and every
shipping path of TorchPairHMMRunner (planes, packed, packed-split, nib,
alphabet overflow, fused k >= 2, fuse_auto, adaptive) — results bit-equal
to the reference's NativePairHMMRunner, dispatch_profile labels equal to
the reference PallasPairHMMRunner's on the same jobs and config."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.ops import pairhmm_pallas as ref_pallas
from gatk_hc_tpu.ops import runner as ref_runner
from gatk_hc_tpu.utils.quality import BASE_TABLE, INITIAL_CONSTANT_F32, PH2PR_F32
from gatk_hc_tpu_torch import convert
from gatk_hc_tpu_torch.ops import pairhmm_front as pf
from gatk_hc_tpu_torch.ops import pairhmm_packed as pk
from gatk_hc_tpu_torch.ops import runner as port_runner
from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
from tests.test_pairhmm import make_pair, to_bytes
from tests.test_torch_runner import (  # noqa: F401 - autouse fixture
    make_job, one_torch_thread, reference_results,
)

PPE_TABLE = ref_pallas.ppe_element_table(BASE_TABLE, PH2PR_F32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def ref_gathers(ru, hu, rl, hl, iy, pr, ph):
    """The gathers of pairhmm_pallas.dispatch_pairs_ppe, in the port's
    pair-minor layout."""
    pr, ph = jnp.asarray(pr), jnp.asarray(ph)
    rows = np.asarray(jnp.take(ru, pr, axis=1)).transpose(2, 0, 1)
    hap = np.asarray(jnp.take(hu, ph, axis=0)).T
    return (rows, hap, np.asarray(jnp.take(rl, pr)),
            np.asarray(jnp.take(hl, ph)), np.asarray(jnp.take(iy, ph)))


def assert_outputs_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))


def group_bytes(nprng, nr, nh, r_pad, c_pad, qual_hi=66):
    """Random unique tables with 0-padded row tails, as the runner packs."""
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    rl = nprng.integers(1, r_pad + 1, nr).astype(np.int32)
    hl = nprng.integers(1, c_pad + 1, nh).astype(np.int32)
    read = acgtn[nprng.integers(0, 5, (nr, r_pad))]
    qual = nprng.integers(35, qual_hi, (nr, r_pad)).astype(np.uint8)
    hap = acgtn[nprng.integers(0, 4, (nh, c_pad))]
    read[np.arange(r_pad) >= rl[:, None]] = 0
    qual[np.arange(r_pad) >= rl[:, None]] = 0
    hap[np.arange(c_pad) >= hl[:, None]] = 0
    init_y = (INITIAL_CONSTANT_F32 / hl.astype(np.float32)).astype(np.float32)
    i32 = np.concatenate([rl, hl, init_y.view(np.int32)])
    return read, qual, hap, i32


# ---------------------------------------------------------------------------
# The glue, bit for bit (padding rows, all 256 byte values, offsets).


def test_prepare_tables_ppe_matches_reference():
    """Every byte value in every segment, including the zero padding."""
    nprng = np.random.default_rng(11)
    nr, nh, r_pad, c_pad = 8, 4, 16, 32
    u8 = nprng.integers(0, 256, 2 * nr * r_pad + nh * c_pad).astype(np.uint8)
    u8[:5] = 0
    i32 = nprng.integers(1, 200, nr + 2 * nh).astype(np.int32)
    want = ref_pallas.prepare_tables_ppe(
        jnp.asarray(u8), jnp.asarray(i32), jnp.asarray(PPE_TABLE),
        nr_pad=nr, nh_pad=nh, r_pad=r_pad, c_pad=c_pad,
    )
    got = pk.unpack_u8_ppe(t(u8), t(i32), t(PPE_TABLE), nr, nh, r_pad, c_pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(np.asarray(w)))


SPAN_CASES = {
    # (spans, n_pairs): padding rows, a zero-count row sharing a start,
    # nh = 0 with nr > 0, a tail past the total, n_pairs below the total
    "padded": ([(0, 0, 3, 2), (3, 2, 1, 5), (4, 7, 2, 2)], 32),
    "zero_rows": ([(0, 0, 2, 3), (2, 3, 0, 4), (2, 3, 5, 0), (2, 3, 3, 3)], 40),
    "exact": ([(0, 0, 4, 4), (4, 4, 4, 4)], 32),
    "short": ([(0, 0, 6, 6), (6, 6, 2, 2)], 17),
    "one_row": ([(5, 9, 1, 1)], 8),
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_expand_pairs_from_spans_matches_reference(case):
    rows, n_pairs = SPAN_CASES[case]
    spans = np.zeros((max(8, len(rows)), 4), np.int32)
    spans[: len(rows)] = rows
    want = ref_pallas._expand_pairs_from_spans(jnp.asarray(spans), n_pairs)
    got = pk.expand_pairs_from_spans(t(spans), n_pairs)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ref_nib_encode(read, qual):
    ref = ref_runner.PallasPairHMMRunner(JAX_DEFAULT_CONFIG, interpret=True)
    return ref._nib_encode(read.ravel(), qual.ravel())


@pytest.mark.parametrize("qual_hi", [66, 90])  # <= 32 and > 32 qual bytes
def test_nib_encode_matches_reference(qual_hi):
    nprng = np.random.default_rng(qual_hi)
    read, qual, _hap, _i32 = group_bytes(nprng, 16, 2, 24, 32, qual_hi)
    port = TorchPairHMMRunner(convert.config_from_reference(
        dataclasses.asdict(JAX_DEFAULT_CONFIG)), device="cpu")
    got = port._nib_encode(read.ravel(), qual.ravel())
    want = _ref_nib_encode(read, qual)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_nib_encode_seq_overflow_matches_reference():
    nprng = np.random.default_rng(3)
    read, qual, _hap, _i32 = group_bytes(nprng, 8, 2, 16, 32)
    read[0, :9] = np.frombuffer(b"ACGTNRYKM", np.uint8)  # 9 + pad byte
    port = TorchPairHMMRunner(convert.config_from_reference(
        dataclasses.asdict(JAX_DEFAULT_CONFIG)), device="cpu")
    assert _ref_nib_encode(read, qual) is None
    assert port._nib_encode(read.ravel(), qual.ravel()) is None


@pytest.mark.parametrize("off", [0, 5])
def test_prologue_packed_plain_matches_reference(off):
    """The packed glue = prepare_tables_ppe + the gathers, for pairs off ..
    off + B - 1 of a group's wider pair arrays (a chunk's segment)."""
    nprng = np.random.default_rng(20 + off)
    nr, nh, r_pad, c_pad, B = 8, 4, 16, 32, 37
    read, qual, hap, i32 = group_bytes(nprng, nr, nh, r_pad, c_pad)
    u8 = np.concatenate([read.ravel(), qual.ravel(), hap.ravel()])
    pr = nprng.integers(0, nr, B).astype(np.int32)
    ph = nprng.integers(0, nh, B).astype(np.int32)
    tables = ref_pallas.prepare_tables_ppe(
        jnp.asarray(u8), jnp.asarray(i32), jnp.asarray(PPE_TABLE),
        nr_pad=nr, nh_pad=nh, r_pad=r_pad, c_pad=c_pad,
    )
    want = ref_gathers(*tables, pr, ph)
    assert_outputs_equal(pk.prologue_packed_plain(
        t(u8), t(i32), t(pr), t(ph), t(PPE_TABLE), nr, nh, r_pad, c_pad),
        want)
    total = B + off + 3  # pairs around the chunk point elsewhere
    pairs = np.full((2, total), -7, np.int32)
    pairs[:, off : off + B] = pr, ph
    seg = pf.Segment((t(u8), t(i32), t(pairs.ravel())), (nr, nh, r_pad, c_pad),
                     total, off, B)
    assert_outputs_equal(pf.segment_inputs("packed", seg, t(PPE_TABLE)), want)


@pytest.mark.parametrize("case", ["padded", "zero_rows", "short"])
def test_prologue_nib_plain_matches_reference(case):
    """The nib glue = _unpack_nib_ppe + _expand_pairs_from_spans + the
    gathers, from bytes the reference runner's _nib_encode made."""
    rows, n_pairs = SPAN_CASES[case]
    nprng = np.random.default_rng(len(case))
    nr, nh, r_pad, c_pad = 16, 16, 16, 32
    read, qual, hap, i32 = group_bytes(nprng, nr, nh, r_pad, c_pad)
    nib, minitab = _ref_nib_encode(read, qual)
    u8 = np.concatenate([nib.ravel(), hap.ravel()])
    spans = np.zeros((8, 4), np.int32)
    spans[: len(rows)] = rows
    tables = ref_pallas._unpack_nib_ppe(
        jnp.asarray(u8), jnp.asarray(i32), jnp.asarray(minitab),
        jnp.asarray(PPE_TABLE), nr, nh, r_pad, c_pad,
    )
    pr, ph = ref_pallas._expand_pairs_from_spans(jnp.asarray(spans), n_pairs)
    want = ref_gathers(*tables, pr, ph)
    got = pk.prologue_nib_plain(t(u8), t(i32), t(minitab), t(PPE_TABLE),
                                t(spans), n_pairs, nr, nh, r_pad, c_pad)
    assert_outputs_equal(got, want)
    # and the nib planes are the raw encodings' planes, padding included
    mask, omq, q3 = ref_pallas.plane_tables(BASE_TABLE, PH2PR_F32)
    ru = pk.unpack_nib_ppe(t(u8), t(i32), t(minitab), t(PPE_TABLE), nr, nh,
                           r_pad, c_pad)[0].numpy()
    np.testing.assert_array_equal(ru[0], mask[read])
    np.testing.assert_array_equal(ru[1], omq[qual])
    np.testing.assert_array_equal(ru[2], q3[qual])


def test_prologue_rejects_bad_inputs():
    """The packed entry of ppe_forward_unique: a short byte buffer, pairs
    past the group's and int64 pair indices."""
    u8 = torch.zeros(2 * 8 * 16 + 4 * 32, dtype=torch.uint8)
    i32 = torch.ones(16, dtype=torch.int32)
    tab = t(PPE_TABLE)
    pairs = torch.zeros(8, dtype=torch.int32)
    dims = (8, 4, 16, 32)
    trans = (0.5,) * 6

    def run(*views, start=0, n=None):
        seg = pf.Segment(views, dims, 4, start, n)
        return pf.ppe_forward_unique("packed", [seg], tab, trans)

    with pytest.raises(ValueError, match="shorter"):
        run(u8[:10], i32, pairs)
    with pytest.raises(ValueError, match="exceed"):
        run(u8, i32, pairs, start=1, n=4)
    with pytest.raises(TypeError):
        run(u8, i32, pairs.long())


# ---------------------------------------------------------------------------
# The path controller, against the reference's on the same sequences.


def _controller_trace(cls, seed, min_groups, recal_every, forced):
    rng = random.Random(seed)
    ctl = cls(forced=forced, min_groups=min_groups, recal_every=recal_every)
    trace = []
    for _ in range(120):
        path, cal = ctl.choose()
        if cal or rng.random() < 0.1:
            # a phase that drifts and sometimes collapses
            scale = 10.0 if rng.random() < 0.2 else 1.0
            ctl.record(path, scale * rng.uniform(1e-7, 3e-6))
        trace.append((path, cal, ctl.degraded(), ctl.deeply_degraded()))
    return trace


@pytest.mark.parametrize("seed,min_groups,recal_every,forced", [
    (1, 32, 32, None), (2, 1, 4, None), (3, 1, 8, None), (4, 5, 2, None),
    (5, 1, 1, None), (6, 1, 4, "planes"), (7, 1, 4, "packed"),
])
def test_controller_matches_reference(seed, min_groups, recal_every, forced):
    got = _controller_trace(port_runner.DispatchPathController, seed,
                            min_groups, recal_every, forced)
    want = _controller_trace(ref_runner.DispatchPathController, seed,
                             min_groups, recal_every, forced)
    assert got == want


# ---------------------------------------------------------------------------
# Runner paths: results against the reference's C++ engine, labels against
# the reference Pallas runner on the same jobs and config.

BASE = dataclasses.replace(
    JAX_DEFAULT_CONFIG, read_pad_buckets=(32,), hap_pad_buckets=(128,),
)


def port_runner_for(ref_cfg):
    """The port's runner on the converted config, grouping as the
    reference runner does at a 1024-pair budget."""
    runner = TorchPairHMMRunner(
        convert.config_from_reference(dataclasses.asdict(ref_cfg)),
        device="cpu", pair_budget=1024,
    )
    runner.READ_BUCKETS = ref_runner.PallasPairHMMRunner.READ_BUCKETS
    runner.HAP_BUCKETS = ref_runner.PallasPairHMMRunner.HAP_BUCKETS
    return runner


def reference_pallas(ref_cfg):
    ref = ref_runner.PallasPairHMMRunner(ref_cfg, pair_budget=1024,
                                         interpret=True)
    ref._allow_ppe_interpret = True
    return ref


def reference_labels(ref_cfg, jobs, monkeypatch):
    """dispatch_profile of the reference runner on copies of ``jobs``, its
    device programs stubbed (zeros of the right length): the labels come
    from its dispatch logic alone, in a fraction of interpret time."""
    ref = reference_pallas(ref_cfg)
    z = lambda n: jnp.zeros(n, jnp.float32)  # noqa: E731
    ref._planes_callable = lambda nr, nh, r, c, n: lambda *a: z(n)
    ref._fused_callable = lambda k, nr, nh, r, c, n: lambda *a: z(k * n)
    ref._packed_callable = lambda nr, nh, r, c, n: lambda *a: z(n)
    ref._packed_fused_callable = lambda k, nr, nh, r, c, n: lambda *a: z(k * n)
    ref._packed_nib_callable = lambda nr, nh, r, c, n, s: lambda *a: z(n)
    ref._packed_nib_fused_callable = (
        lambda k, nr, nh, r, c, n, s: lambda *a: z(k * n))
    monkeypatch.setattr(ref_pallas, "prepare_tables_ppe",
                        lambda *a, **k: (None,) * 5)
    monkeypatch.setattr(ref_pallas, "dispatch_pairs_ppe",
                        lambda *a, **k: z(a[5].shape[-1]))
    ref.run([ref_runner.PairHMMJob(j.reads, j.haps) for j in jobs])
    return ref.dispatch_counts


def overflow_job(rng):
    """Reads whose 60+ distinct quality bytes overflow the nib dictionary."""
    reads = []
    for i in range(8):
        read, _, _hap = make_pair(rng, 24, 60, 1)
        quals = "".join(chr(33 + ((i * 24 + k) % 60)) for k in range(len(read)))
        reads.append((to_bytes(read), to_bytes(quals)))
    _, _, hap = make_pair(rng, 10, 60, 0)
    return PairHMMJob(reads, [to_bytes(hap)])


def ragged_jobs(rng):  # multi-span groups with ragged nr / nh
    return [make_job(rng, 3 + (i % 4), 2 + (i % 3)) for i in range(10)]


def fuse_jobs(rng, n=12):  # 12 jobs x 128 pairs: groups of 8 + 4 jobs
    return [make_job(rng, 8, 16) for _ in range(n)]


def long_hap_jobs(rng):
    """Four groups at two (r_pad, c_pad) signatures, interleaved (haps past
    the 128 bucket in the second and fourth): jobs of one read and 128
    haps, so four fill a group's 512-hap budget."""
    jobs = []
    for block in range(4):
        lo, hi = (130, 200) if block % 2 else (40, 100)
        for _ in range(4):
            read, quals, _h = make_pair(rng, rng.randint(10, 30), 60, 1)
            haps = [to_bytes(make_pair(rng, 10, rng.randint(lo, hi), 0)[2])
                    for _ in range(128)]
            jobs.append(PairHMMJob([(to_bytes(read), to_bytes(quals))], haps))
    return jobs


CASES = {
    # name: (reference config overrides, jobs, expected port labels)
    "planes": (dict(dispatch_mode="planes", fuse_groups=1), ragged_jobs,
               {"planes"}),
    "packed": (dict(dispatch_mode="packed", packed_nib=False, fuse_groups=1),
               ragged_jobs, {"packed"}),
    "packed_split": (dict(dispatch_mode="packed", packed_nib=False),
                     lambda rng: [make_job(rng, 40, 30)], {"packed-split"}),
    "nib": (dict(dispatch_mode="packed", fuse_groups=1), ragged_jobs,
            {"packednib"}),
    "nib_split_goes_raw": (dict(dispatch_mode="packed"),
                           lambda rng: [make_job(rng, 40, 30)],
                           {"packed-split"}),
    "nib_overflow_goes_packed": (
        dict(dispatch_mode="packed", fuse_groups=1),
        lambda rng: [overflow_job(rng)], {"packed"}),
    "fused_planes": (dict(dispatch_mode="planes", fuse_groups=4,
                          fuse_auto=False), fuse_jobs, {"fused2"}),
    "fused_planes_tail": (dict(dispatch_mode="planes", fuse_groups=3,
                               fuse_auto=False),
                          lambda rng: fuse_jobs(rng, 9), {"fused2"}),
    "fused_packed": (dict(dispatch_mode="packed", packed_nib=False,
                          fuse_groups=4, fuse_auto=False), fuse_jobs,
                     {"packedfused2"}),
    "fused_nib": (dict(dispatch_mode="packed", fuse_groups=4,
                       fuse_auto=False), fuse_jobs, {"packednibfused2"}),
    "fused_two_shapes": (dict(dispatch_mode="packed", fuse_groups=4,
                              fuse_auto=False), long_hap_jobs,
                         {"packednibfused2"}),
    "fuse_auto_not_degraded": (dict(fuse_groups=4, fuse_auto=True),
                               fuse_jobs, {"planes"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_path_matches_reference(case, monkeypatch):
    overrides, make_jobs, labels = CASES[case]
    ref_cfg = dataclasses.replace(BASE, **overrides)
    jobs = make_jobs(random.Random(sorted(CASES).index(case)))
    runner = port_runner_for(ref_cfg)
    runner.run(jobs)
    assert set(runner.dispatch_counts) == labels
    for job, want in zip(jobs, reference_results(jobs)):
        np.testing.assert_array_equal(job.result, want)
    assert runner.dispatch_counts == reference_labels(ref_cfg, jobs,
                                                      monkeypatch)


@pytest.mark.parametrize("best_ever,fuses", [(1e-7, True), (1e-7 * 10 / 3, False)])
def test_fuse_auto_follows_deep_degradation(best_ever, fuses, monkeypatch):
    """TestFuseAuto: a measured 10x collapse (past the 6x threshold)
    engages fusion, a 3x one does not; the same on the reference."""
    ref_cfg = dataclasses.replace(BASE, fuse_groups=4, fuse_auto=True)
    jobs = fuse_jobs(random.Random(9))
    runner = port_runner_for(ref_cfg)
    runner._path_ctl.record("planes", 1e-6)
    runner._path_ctl._best_ever = best_ever
    assert runner._path_ctl.degraded()
    assert runner._path_ctl.deeply_degraded() == fuses
    runner.run(jobs)
    assert any(k.startswith("fused") for k in runner.dispatch_counts) == fuses
    for job, want in zip(jobs, reference_results(jobs)):
        np.testing.assert_array_equal(job.result, want)
    ref = reference_pallas(ref_cfg)
    ref._path_ctl.record("planes", 1e-6)
    ref._path_ctl._best_ever = best_ever
    assert ref._path_ctl.deeply_degraded() == fuses


def test_adaptive_calibrates_both_paths():
    """dispatch_mode adaptive past min_groups: one synchronous timed group
    per path, then the measured winner; every group bit-equal."""
    ref_cfg = dataclasses.replace(BASE, fuse_groups=1)
    jobs = [make_job(random.Random(17), 4, 4) for _ in range(12)]
    runner = port_runner_for(ref_cfg)
    runner.pair_budget = 16  # one job per group: 12 groups
    runner._path_ctl = port_runner.DispatchPathController(
        min_groups=2, recal_every=4)
    runner.run(jobs)
    assert set(runner._path_ctl.measured) == {"planes", "packed"}
    assert runner.dispatch_counts.get("planes", 0) >= 1
    assert runner.dispatch_counts.get("packednib", 0) >= 1
    assert sum(runner.dispatch_counts.values()) == 12
    for job, want in zip(jobs, reference_results(jobs)):
        np.testing.assert_array_equal(job.result, want)


# ---------------------------------------------------------------------------
# Two cases against the reference Pallas runner itself (interpret mode):
# results and labels both.

SMALL = dataclasses.replace(
    JAX_DEFAULT_CONFIG, read_pad_buckets=(8,), hap_pad_buckets=(32,),
    stripe_height=8,
)


def small_job(rng, nr, nh):
    reads, haps = [], []
    for _ in range(nr):
        read, quals, _ = make_pair(rng, rng.randint(5, 8), 24, 1)
        reads.append((to_bytes(read), to_bytes(quals)))
    for _ in range(nh):
        _, _, hap = make_pair(rng, 4, rng.randint(16, 32), 0)
        haps.append(to_bytes(hap))
    return PairHMMJob(reads, haps)


@pytest.mark.parametrize("overrides,label", [
    (dict(dispatch_mode="packed", fuse_groups=1), "packednib"),
    (dict(dispatch_mode="planes", fuse_groups=4, fuse_auto=False), "fused2"),
])
def test_matches_reference_pallas_runner(overrides, label):
    """Labels equal; results bit-equal to the reference's C++ engine and
    within 1e-6 relative (one or two f32 ulps of log10) of the reference
    Pallas runner's: its interpret mode on the CPU is not bit-exact
    itself (it differs from the C++ engine in a few pairs; its own tests
    hold only the bulk bit-identical)."""
    ref_cfg = dataclasses.replace(SMALL, **overrides)
    rng = random.Random(23)
    n = 12 if label == "fused2" else 5
    jobs = [small_job(rng, 8, 16) for _ in range(n)]
    ref_jobs = [ref_runner.PairHMMJob(j.reads, j.haps) for j in jobs]
    ref = reference_pallas(ref_cfg)
    ref.run(ref_jobs)
    runner = port_runner_for(ref_cfg)
    runner.run(jobs)
    assert label in runner.dispatch_counts
    assert runner.dispatch_counts == ref.dispatch_counts
    same = 0
    for job, want, native in zip(jobs, ref_jobs, reference_results(jobs)):
        np.testing.assert_array_equal(job.result, native)
        np.testing.assert_allclose(job.result, want.result, rtol=1e-6, atol=0)
        same += int((job.result == want.result).sum())
    assert same >= 0.99 * sum(j.result.size for j in jobs)
