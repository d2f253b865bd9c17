"""The ppe kernel's unique-rows entry (ops/pairhmm_front.py, csrc/
pairhmm_ppe.cu::pairhmm_ppe_forward_unique) on the CPU.

The entry runs on the card only, so what it reads is modelled here in
numpy from the segment table the wrapper hands the C entry: each warp's
segment lookup, its (read, hap) pair from the pair indices or by binary
search of the nib span starts, lane j's K read rows per stripe and the
hap staging slots, every load an address into the shipped buffer.  The
model is held bit for bit against the plain glue's pair-minor inputs for
1, 2 and 3 fused groups, a chunk of a group, zero-count and padded span
rows, at every default bucket and at reads longer than 256 rows.  The
wrapper's CPU route is held bit for bit against the port's oracle and
against the reference package's unpack + dispatch_pairs_ppe inputs
through ppe_forward_plain, and within 1e-6 relative (log10) of the
reference's Pallas dispatch functions in interpret mode, fused forms
included."""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatk_hc_tpu.ops import pairhmm_pallas as ref_pallas
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.ops import pairhmm_front as pf
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from gatk_hc_tpu_torch.ops.pairhmm_oracle import pairhmm_prob
from gatk_hc_tpu_torch.ops.runner import (
    PairHMMJob, TorchPairHMMRunner, join_payloads, segments_of,
)
from tests.test_torch_runner import one_torch_thread  # noqa: F401 - autouse

LANES = 32
HAP_PAD = 32  # csrc/pairhmm_ppe.cu: zero slots around the staged hap
ACGTN = np.frombuffer(b"ACGTN", np.uint8)
TRANS = pt.transition_constants(DEFAULT_CONFIG.gop_char,
                                DEFAULT_CONFIG.gcp_char)
PATHS = ("planes", "packed", "nib")


# ---------------------------------------------------------------------------
# Groups as the runner packs them.


def make_jobs(nprng, shapes, r_pad, c_pad):
    """PairHMMJobs of (nr, nh) each: haps of random length up to c_pad,
    reads up to r_pad drawn from the job's first hap with substitutions
    and N bases (one in four unrelated), qualities Q10-40 (31 values, so
    the nib dictionary holds them)."""
    jobs = []
    for nr, nh in shapes:
        haps = [ACGTN[nprng.integers(0, 4, int(nprng.integers(1, c_pad + 1)))]
                for _ in range(nh)]
        reads = []
        for k in range(nr):
            n = int(nprng.integers(1, r_pad + 1))
            src = haps[0]
            if k % 4 == 3 or n > len(src):
                read = ACGTN[nprng.integers(0, 5, n)]
            else:
                s = int(nprng.integers(0, len(src) - n + 1))
                read = src[s : s + n].copy()
                read[nprng.random(n) < 0.03] = ACGTN[nprng.integers(0, 4)]
                read[nprng.random(n) < 0.02] = ord("N")
            qual = (nprng.integers(10, 41, n) + 33).astype(np.uint8)
            reads.append((read, qual))
        jobs.append(PairHMMJob(reads, haps))
    return jobs


def small_runner():
    runner = TorchPairHMMRunner(DEFAULT_CONFIG, device="cpu")
    runner.READ_BUCKETS = (8, 16, 32)
    runner.HAP_BUCKETS = (8, 16, 32)
    return runner


def pack(runner, path, jobs, r_pad, c_pad):
    """One group of ``jobs`` packed in ``path``'s encoding."""
    u = runner._unique_rows(jobs, list(range(len(jobs))), r_pad, c_pad)
    t0 = time.perf_counter()
    if path == "planes":
        return runner._pack_planes(u, t0)
    if path == "packed":
        return runner._pack_bytes(u, t0)
    nib = runner._nib_encode(u.read_u8, u.qual_u8)
    assert nib is not None
    return runner._pack_nib(u, *nib, t0)


def ascii_pairs(jobs):
    """(read, qual, hap) of every pair of a group, in pair order."""
    return [(read, qual, hap) for job in jobs for read, qual in job.reads
            for hap in job.haps]


# ---------------------------------------------------------------------------
# The model of what the kernel reads.


class Memory:
    """Host tensors addressed as the kernel addresses device memory."""

    def __init__(self, tensors):
        self.spans = [(t.data_ptr(), t.numel() * t.element_size(),
                       t.view(torch.uint8).reshape(-1).numpy())
                      for t in tensors]

    def _at(self, addr):
        for base, size, mem in self.spans:
            if base <= addr < base + size:
                return mem, addr - base
        raise AssertionError(f"address {addr:#x} is in no shipped array")

    def u8(self, addr, idx):
        mem, off = self._at(addr)
        return mem[off + np.asarray(idx, np.int64)].astype(np.int64)

    def i32(self, addr, idx):
        mem, off = self._at(addr)
        at = off + 4 * np.asarray(idx, np.int64)
        assert (at % 4 == 0).all()
        return mem.view(np.int32)[at // 4].astype(np.int64)


def model_front(path, rows, mem, table_addr, r_pad, c_pad, k):
    """What each warp of pairhmm_ppe_forward_unique loads, from its segment
    table ``rows`` (pairhmm_front.segment_rows) -> pair-minor (rows
    (r_pad, 3, B), hap (c_pad, B), rlen, clen, init_y bits), zeros where
    the kernel loads nothing (rows at or past rlen, columns at or past
    clen, everything of a pair whose rlen is outside 1..r_pad)."""
    B = int(rows[:, 1].sum())
    S = LANES * k
    carry = r_pad > S
    lanes = np.arange(LANES)
    out_rows = np.zeros((r_pad, 3, B), np.int64)
    out_hap = np.zeros((c_pad, B), np.int64)
    lens = np.zeros((3, B), np.int64)
    for b in range(B):
        s = 0  # the warp's segment: a scan of the table
        while s + 1 < len(rows) and b >= rows[s + 1, 0]:
            s += 1
        (first, _n, src, a_lens, a_rows, a_haps, a_pairs, stride, a_mini,
         a_spans, a_starts, nr_pad, nh_pad, n_spans) = (int(v) for v in rows[s])
        i = src + b - first
        if path == "nib":  # searchsorted(starts, i, "right") - 1, clipped
            lo, hi = 0, n_spans
            while lo < hi:
                mid = (lo + hi) >> 1
                if mem.i32(a_starts, mid) <= i:
                    lo = mid + 1
                else:
                    hi = mid
            j = max(0, min(n_spans - 1, lo - 1))
            pr = ph = 0
            if i < mem.i32(a_starts, n_spans):
                nh = max(int(mem.i32(a_spans, 4 * j + 3)), 1)
                local = i - int(mem.i32(a_starts, j))
                pr = int(mem.i32(a_spans, 4 * j)) + local // nh
                ph = int(mem.i32(a_spans, 4 * j + 1)) + local % nh
        else:
            pr = int(mem.i32(a_pairs, i))
            ph = int(mem.i32(a_pairs, stride + i))
        rl = int(mem.i32(a_lens, pr))
        cl = max(0, min(int(mem.i32(a_lens, nr_pad + ph)), c_pad))
        lens[:, b] = rl, mem.i32(a_lens, nr_pad + ph), \
            mem.i32(a_lens, nr_pad + nh_pad + ph)
        if not 1 <= rl <= r_pad:
            continue
        nrr = nr_pad * r_pad
        # hap staging: lane j fills slots j, j + 32, ...; slot HAP_PAD + c
        # holds column c (0-based) when c < clen
        slots = np.arange(c_pad + 2 * HAP_PAD)
        for lane in lanes:
            mine = slots[lane::LANES]
            col = mine - HAP_PAD
            col = col[(col >= 0) & (col < cl)]
            if path == "planes":
                vals = mem.i32(a_haps, ph * c_pad + col)
            else:
                vals = mem.i32(table_addr, mem.u8(a_haps, ph * c_pad + col))
            out_hap[col, b] = vals
        # lane j's K rows of each stripe, loaded where r < rlen
        n_stripes = -(-rl // S) if carry else 1
        for st in range(n_stripes):
            r = st * S + lanes[:, None] * k + np.arange(k)[None, :]
            r = r[r < rl]
            if path == "planes":
                planes = [mem.i32(a_rows, p * nrr + pr * r_pad + r)
                          for p in range(3)]
            elif path == "packed":
                base = mem.u8(a_rows, pr * r_pad + r)
                qual = mem.u8(a_rows, nrr + pr * r_pad + r)
                planes = [mem.i32(table_addr, base),
                          mem.i32(table_addr, 256 + qual),
                          mem.i32(table_addr, 512 + qual)]
            else:
                byte = mem.u8(a_rows, pr * r_pad + r)
                planes = [mem.i32(a_mini, byte >> 5),
                          mem.i32(a_mini, 8 + (byte & 31)),
                          mem.i32(a_mini, 40 + (byte & 31))]
            for p in range(3):
                out_rows[r, p, b] = planes[p]
    return out_rows, out_hap, lens


def assert_model_matches_glue(path, segments, table, mem_tensors):
    r_pad, c_pad = segments[0].dims[2:]
    k = pt.rows_per_lane(pt.select_rows(4, r_pad), r_pad)
    pf.check(path, segments, table)
    rows = pf.segment_rows(path, segments)
    mem = Memory([*mem_tensors, table])
    got_rows, got_hap, got_lens = model_front(
        path, rows, mem, table.data_ptr(), r_pad, c_pad, k)
    parts = [pf.segment_inputs(path, s, table) for s in segments]
    want = [torch.cat([p[j] for p in parts], -1).view(torch.int32).numpy()
            .astype(np.int64) for j in range(5)]
    np.testing.assert_array_equal(got_lens, np.stack(want[2:]))
    rl, cl = want[2], np.clip(want[3], 0, c_pad)
    loaded = (np.arange(r_pad)[:, None] < rl[None, :]) & (rl >= 1) & (rl <= r_pad)
    np.testing.assert_array_equal(
        got_rows, np.where(loaded[:, None, :], want[0], 0))
    staged = (np.arange(c_pad)[:, None] < cl[None, :]) & (rl >= 1) & (rl <= r_pad)
    np.testing.assert_array_equal(got_hap, np.where(staged, want[1], 0))
    assert loaded.any() and staged.any()


# name: (groups fused, r_pad, c_pad, (start, n) of a chunk of the group)
MODEL_CASES = {
    "k1_96x448": (1, 96, 448, None),
    "k2_96x512": (2, 96, 512, None),
    "k3_160x448": (3, 160, 448, None),
    "k1_160x512": (1, 160, 512, None),
    "k2_224x448": (2, 224, 448, None),
    "k3_224x512": (3, 224, 512, None),
    "chunk_160x448": (1, 160, 448, (5, 9)),
    "carry_288x448": (1, 288, 448, None),
}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_index_model_matches_glue(path, case):
    """Segment lookup, pair resolution, lane rows and hap staging of every
    source == the plain glue's pair-minor inputs, for fused launches, a
    chunk (pair offset 5), every default bucket and a carried stripe."""
    k_groups, r_pad, c_pad, chunk = MODEL_CASES[case]
    nprng = np.random.default_rng(sorted(MODEL_CASES).index(case)
                                  + 100 * PATHS.index(path))
    runner = small_runner()
    shapes = [(4, 5)] if chunk else [(2, 2), (3, 1), (1, 3)]
    payloads = [
        pack(runner, path, make_jobs(nprng, shapes[: g + 1], r_pad, c_pad),
             r_pad, c_pad)
        for g in range(k_groups)
    ]
    buf = join_payloads(payloads, False)
    segments = segments_of(payloads, buf.ship(torch.device("cpu")))
    if chunk is not None:
        segments = [dataclasses.replace(segments[0], start=chunk[0],
                                        n=chunk[1])]
    assert_model_matches_glue(path, segments, runner._ppe_tab, [buf.host])


# (span rows, pairs expanded): a zero-count row sharing a start, nh = 0
# with nr > 0, a tail past the total, fewer pairs than the total
SPAN_CASES = {
    "padded": ([(0, 0, 3, 2), (3, 2, 1, 5), (4, 7, 2, 2)], 32),
    "zero_rows": ([(0, 0, 2, 3), (2, 3, 0, 4), (2, 3, 5, 0), (2, 3, 3, 3)], 40),
    "short": ([(0, 0, 6, 6), (6, 6, 2, 2)], 17),
    "chunk": ([(0, 0, 4, 4), (4, 4, 4, 4)], 32),
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_index_model_nib_spans(case):
    """The nib span search over host starts (nib_starts) with zero-count
    and padded rows, past-the-total pairs and a chunk (pairs 7..31)."""
    spans_rows, n_pairs = SPAN_CASES[case]
    nprng = np.random.default_rng(len(case))
    runner = small_runner()
    r_pad, c_pad = 96, 448
    jobs = make_jobs(nprng, [(16, 16)], r_pad, c_pad)
    u = runner._unique_rows(jobs, [0], r_pad, c_pad)
    nib, minitab = runner._nib_encode(u.read_u8, u.qual_u8)
    spans = np.zeros((8, 4), np.int32)
    spans[: len(spans_rows)] = spans_rows
    starts = pf.nib_starts(spans)
    counts = spans[:, 2].astype(np.int64) * spans[:, 3]
    np.testing.assert_array_equal(starts[:-1], np.cumsum(counts) - counts)
    assert starts[-1] == counts.sum()
    lens = np.zeros(u.dims[0] + 2 * u.dims[1], np.int32)
    u.lens_into(lens)
    views = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        np.concatenate([nib, u.hap_u8]), lens, minitab, spans.ravel(), starts))
    start = 7 if case == "chunk" else 0
    seg = pf.Segment(views, u.dims, n_pairs, start)
    assert_model_matches_glue("nib", [seg], runner._ppe_tab, views)


# ---------------------------------------------------------------------------
# The wrapper's CPU route against the oracle and the reference package.

R_PAD, C_PAD, REF_B = 16, 32, 1024  # the reference's ppe takes B % 1024 == 0


def ref_tables(path, views, dims, table):
    nr, nh, r_pad, c_pad = dims
    j = lambda v: jnp.asarray(v.numpy())  # noqa: E731
    if path == "planes":
        return ref_pallas._unpack_planes(j(views[0]), nr, nh, r_pad, c_pad)
    if path == "packed":
        return ref_pallas.prepare_tables_ppe(
            j(views[0]), j(views[1]), jnp.asarray(table.numpy()), nr_pad=nr,
            nh_pad=nh, r_pad=r_pad, c_pad=c_pad)
    return ref_pallas._unpack_nib_ppe(j(views[0]), j(views[1]), j(views[2]),
                                      jnp.asarray(table.numpy()), nr, nh,
                                      r_pad, c_pad)


def ref_pairs(path, views, total, n):
    """The reference's (pair reads, pair haps) for n pairs: the shipped
    indices padded with pair (0, 0), or _expand_pairs_from_spans."""
    if path == "nib":
        pr, ph = ref_pallas._expand_pairs_from_spans(
            jnp.asarray(views[3].numpy().reshape(-1, 4)), n)
        return np.asarray(pr), np.asarray(ph)
    pairs = np.zeros((2, n), np.int32)
    pairs[:, :total] = views[-1].numpy().reshape(2, total)
    return pairs[0], pairs[1]


def ref_interpret(path, groups, table, dims):
    """The reference's one-launch dispatch of the groups (a list of
    (views, total)) in interpret mode, fused when there are several ->
    each group's first ``total`` raw results."""
    nr, nh, r_pad, c_pad = dims
    static = dict(nr_pad=nr, nh_pad=nh, r_pad=r_pad, c_pad=c_pad, ppe_rows=4,
                  interpret=True)
    tab = jnp.asarray(table.numpy())

    def stack(k):
        return jnp.asarray(np.stack([v[k].numpy() for v, _ in groups]))

    pairs = jnp.asarray(np.stack([
        np.stack(ref_pairs(path, v, total, REF_B)) for v, total in groups]))
    fused = len(groups) > 1
    if path == "planes":
        fn = (ref_pallas.pairhmm_pallas_planes_fused if fused
              else ref_pallas.pairhmm_pallas_planes)
        out = fn(stack(0) if fused else stack(0)[0],
                 pairs if fused else pairs[0], TRANS, **static)
    elif path == "packed":
        fn = (ref_pallas.pairhmm_pallas_packed_fused if fused
              else ref_pallas.pairhmm_pallas_packed)
        out = fn(*(stack(0), stack(1)) if fused else (stack(0)[0], stack(1)[0]),
                 tab, pairs if fused else pairs[0], TRANS, **static)
    else:
        spans = stack(3).reshape(len(groups), -1, 4)
        if fused:
            out = ref_pallas.pairhmm_pallas_packed_nib_fused(
                stack(0), stack(1), stack(2), tab, spans, TRANS,
                n_pairs=REF_B, **static)
        else:
            out = ref_pallas.pairhmm_pallas_packed_nib(
                stack(0)[0], stack(1)[0], stack(2)[0], tab, spans[0], TRANS,
                n_pairs=REF_B, **static)
    out = np.asarray(out).reshape(len(groups), REF_B)
    return [out[g, :total] for g, (_v, total) in enumerate(groups)]


def log10_close(got, want):
    """Within 1e-6 relative in log10 (one or two f32 ulps of log10), the
    bound tests/test_torch_dispatch.py holds the reference's interpret
    mode to; underflowed pairs underflow in both."""
    assert np.array_equal(got == 0, want == 0)
    nz = got != 0
    np.testing.assert_allclose(np.log10(got[nz].astype(np.float64)),
                               np.log10(want[nz].astype(np.float64)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("path", PATHS)
def test_unique_route_matches_oracle_and_reference(path):
    """Two groups, alone and fused: raw f32 bit-equal to the port's oracle
    and to the reference's unpack + gathers through ppe_forward_plain, and
    within 1e-6 (log10) of its Pallas dispatch in interpret mode."""
    nprng = np.random.default_rng(7 + PATHS.index(path))
    runner = small_runner()
    job_sets = [make_jobs(nprng, [(4, 3), (2, 5), (3, 2)], R_PAD, C_PAD)
                for _ in range(2)]
    payloads = [pack(runner, path, jobs, R_PAD, C_PAD) for jobs in job_sets]
    dims = payloads[0].dims
    assert payloads[1].dims == dims
    table = runner._ppe_tab
    alone = [pf.ppe_forward_unique(path, segments_of([p], p.buf.ship(
        torch.device("cpu"))), table, TRANS).numpy() for p in payloads]
    buf = join_payloads(payloads, False)
    fused = pf.ppe_forward_unique(
        path, segments_of(payloads, buf.ship(torch.device("cpu"))), table,
        TRANS).numpy()
    np.testing.assert_array_equal(fused.view(np.int32),
                                  np.concatenate(alone).view(np.int32))
    groups = []
    for p, jobs, got in zip(payloads, job_sets, alone):
        views = p.buf.ship(torch.device("cpu"))
        want = np.array([np.float32(pairhmm_prob(
            r, q, h, DEFAULT_CONFIG.gop_char, DEFAULT_CONFIG.gcp_char,
            np.float32, ftz=True)) for r, q, h in ascii_pairs(jobs)],
            np.float32)
        assert (want > 0).all()  # short reads: none underflows
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        pr, ph = ref_pairs(path, views, p.total, p.total)
        ru, hu, rl, hl, iy = ref_tables(path, views, dims, table)
        inputs = (np.asarray(jnp.take(ru, pr, axis=1)).transpose(2, 0, 1),
                  np.asarray(jnp.take(hu, ph, axis=0)).T,
                  np.asarray(rl)[pr], np.asarray(hl)[ph], np.asarray(iy)[ph])
        ref_plain = pt.ppe_forward_plain(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs),
            TRANS).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref_plain.view(np.int32))
        groups.append((views, p.total))
    log10_close(alone[0], ref_interpret(path, groups[:1], table, dims)[0])
    for got, ref in zip(alone, ref_interpret(path, groups, table, dims)):
        log10_close(got, ref)


def test_segment_limits_match_c_source():
    """The wrapper's segment table has the C entry's width and limit, and
    the widest fused launch the config allows fits in it."""
    import re

    from gatk_hc_tpu_torch.config import FUSE_GROUPS
    from gatk_hc_tpu_torch.ops import _kernels

    with open(f"{_kernels.CSRC}/pairhmm_ppe.cu") as handle:
        source = handle.read()
    for name, value in (("MAX_SEGMENTS", pf.MAX_SEGMENTS),
                        ("SEG_FIELDS", pf.SEG_FIELDS)):
        m = re.search(rf"constexpr int {name} = (\d+);", source)
        assert m and int(m.group(1)) == value
    for name, code in pf.SOURCES.items():
        assert re.search(rf"\b{name.upper()} = {code}\b", source)
    assert max(FUSE_GROUPS) <= pf.MAX_SEGMENTS


# ---------------------------------------------------------------------------
# Bad inputs.


def _packed_segment(**change):
    u8 = torch.zeros(2 * 8 * 16 + 4 * 32, dtype=torch.uint8)
    lens = torch.ones(16, dtype=torch.int32)
    pairs = torch.zeros(8, dtype=torch.int32)
    seg = pf.Segment((u8, lens, pairs), (8, 4, 16, 32), 4)
    return dataclasses.replace(seg, **change)


BAD = {
    # name: (path, segments, table, error, message)
    "unknown_path": ("striped", [_packed_segment()], None, ValueError,
                     "unknown path"),
    "no_segment": ("packed", [], None, ValueError, "at least one"),
    "table_size": ("packed", [_packed_segment()], torch.zeros(256, dtype=torch.int32),
                   ValueError, "768"),
    "two_shapes": ("packed", [_packed_segment(),
                              _packed_segment(dims=(8, 4, 16, 16))], None,
                   ValueError, "share"),
    "views": ("packed", [_packed_segment(views=_packed_segment().views[:2])],
              None, ValueError, "takes 3 views"),
    "u8_dtype": ("packed", [_packed_segment(views=(
        torch.zeros(2 * 8 * 16 + 4 * 32, dtype=torch.int32),
        *_packed_segment().views[1:]))], None, TypeError, "u8 must be"),
    "short_pairs": ("packed", [_packed_segment(total=5)], None, ValueError,
                    "pairs is shorter"),
    "negative_start": ("packed", [_packed_segment(start=-1, n=2)], None,
                       ValueError, "exceed"),
    "nib_spans": ("nib", [pf.Segment((
        torch.zeros(8 * 16 + 4 * 32, dtype=torch.uint8),
        torch.ones(16, dtype=torch.int32), torch.zeros(72, dtype=torch.int32),
        torch.zeros(6, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)),
        (8, 4, 16, 32), 4)], None, ValueError, r"\(S, 4\)"),
    "nib_starts": ("nib", [pf.Segment((
        torch.zeros(8 * 16 + 4 * 32, dtype=torch.uint8),
        torch.ones(16, dtype=torch.int32), torch.zeros(72, dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)),
        (8, 4, 16, 32), 4)], None, ValueError, "starts is shorter"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_rejects_bad_inputs(case):
    path, segments, table, error, message = BAD[case]
    if table is None:
        table = torch.from_numpy(small_runner()._ppe_tab.numpy())
    with pytest.raises(error, match=message):
        pf.ppe_forward_unique(path, segments, table, TRANS)
