"""The striped kernel's unique-rows entry (ops/pairhmm_striped.py::
striped_forward_unique, csrc/pairhmm_striped.cu::
pairhmm_striped_forward_unique) on the CPU.

The entry runs on the card only, so what it reads is modelled here in
numpy from the segment row the wrapper hands the C entry: each H-lane
segment's (read, hap) pair, the stripes its warp runs
(the most any of the warp's 32 / H pairs needs), lane i's K rows of each
stripe and the hap staging slots, every load an address into the shipped
buffer or the 768-entry table.  The model is held bit for bit against the
plain glue's pair-major inputs at H 8, 16 and 32 under the K rule, one
stripe and several (the carry instances), for a whole group, a chunk that
starts mid-group and two groups, each in its own launch.  The wrapper's CPU route is held bit
for bit against the FTZ oracle and against the reference package's
prepare_tables_striped + pair gathers (jnp.take) through the striped
plain version, and to its Pallas dispatch_pairs_striped in interpret mode
within the bounds tests/test_torch_striped.py states (XLA:CPU contracts
mul+add into FMA there, so that program is not exact)."""

import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from gatk_hc_tpu.ops import pairhmm_oracle as jax_oracle
from gatk_hc_tpu.ops import pairhmm_pallas as ref_pallas
from gatk_hc_tpu.utils.quality import BASE_TABLE, PH2PR_F32
from gatk_hc_tpu_torch.ops import _kernels
from gatk_hc_tpu_torch.ops import pairhmm_front as pf
from gatk_hc_tpu_torch.ops import pairhmm_striped as ps
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from gatk_hc_tpu_torch.ops.runner import join_payloads, segments_of
from tests.test_torch_ppe_front import (
    TRANS, Memory, ascii_pairs, make_jobs, pack, small_runner,
)
from tests.test_torch_runner import one_torch_thread  # noqa: F401 - autouse
from tests.test_torch_striped import _hold_to_pallas

LANES = 32
HAP_PAD = 32  # csrc/pairhmm_striped.cu: zero slots around the staged hap
CPU = torch.device("cpu")


def code_mask(code):
    code = np.asarray(code, np.int64)
    return np.where(code == 4, 15, 1 << np.clip(code, 0, 4))


# ---------------------------------------------------------------------------
# The model of what the kernel reads.


def model_striped(rows, mem, table_addr, r_pad, c_pad, H, k):
    """What each H-lane segment of pairhmm_striped_forward_unique loads,
    from its one segment row ``rows`` (pairhmm_front.segment_rows, packed)
    -> (read masks, 1 - q bits, q / 3 bits (B, r_pad), hap masks (B,
    c_pad), [rlen, clen, init_y bits] (3, B), row loads per (B, r_pad)),
    zeros where the kernel loads nothing.  A warp holds 32 / H consecutive
    pairs and runs the most stripes any of them needs (the kernel's
    __reduce_max_sync); a pair loads only in its own stripes, rows below
    rlen.  At H 32 a pair whose rlen is outside 1..r_pad returns before it
    stages its hap."""
    (first, B, src, a_lens, a_rows, a_haps, a_pairs, stride, _mini, _spans,
     _starts, nr_pad, nh_pad, _n_spans) = (int(v) for (v,) in rows.T)
    assert first == 0
    S = H * k
    carry = r_pad > S
    out = np.zeros((3, B, r_pad), np.int64)
    hap = np.zeros((B, c_pad), np.int64)
    lens = np.zeros((3, B), np.int64)
    loads = np.zeros((B, r_pad), np.int64)
    pairs = []
    for b in range(B):
        i = src + b
        pr = int(mem.i32(a_pairs, i))
        ph = int(mem.i32(a_pairs, stride + i))
        assert 0 <= pr < nr_pad and 0 <= ph < nh_pad  # else the kernel traps
        rl = int(mem.i32(a_lens, pr))
        lens[:, b] = rl, mem.i32(a_lens, nr_pad + ph), \
            mem.i32(a_lens, nr_pad + nh_pad + ph)
        cl = max(0, min(int(lens[1, b]), c_pad))
        ok = 1 <= rl <= r_pad
        n = (-(-rl // S) if carry else 1) if ok else 0
        pairs.append((pr, ph, rl, cl, ok, n))
    lanes = np.arange(H)
    for w0 in range(0, B, LANES // H):
        warp = range(w0, min(w0 + LANES // H, B))
        n_warp = max(pairs[b][5] for b in warp)
        for b in warp:
            pr, ph, rl, cl, ok, n = pairs[b]
            if H == LANES and not ok:
                continue
            # hap staging: lane i fills slots i, i + H, ...; slot HAP_PAD + c
            # holds column c (0-based) when c < clen
            slots = np.arange(c_pad + 2 * HAP_PAD)
            for lane in lanes:
                col = slots[lane::H] - HAP_PAD
                col = col[(col >= 0) & (col < cl)]
                hap[b, col] = mem.i32(table_addr,
                                      mem.u8(a_haps, ph * c_pad + col))
            for st in range(n_warp):
                if st >= n:  # not live: the lanes load nothing
                    continue
                r = st * S + lanes[:, None] * k + np.arange(k)[None, :]
                r = r[r < rl]
                base = mem.u8(a_rows, pr * r_pad + r)
                qual = mem.u8(a_rows, nr_pad * r_pad + pr * r_pad + r)
                out[0, b, r] = mem.i32(table_addr, base)
                out[1, b, r] = mem.i32(table_addr, 256 + qual)
                out[2, b, r] = mem.i32(table_addr, 512 + qual)
                np.add.at(loads[b], r, 1)
    return out, hap, lens, loads


def instance(H, r_pad):
    """(K, CARRY) the entry launches at (H, r_pad), checked against the C
    source's instance rule (with_instance: K in 1..KMAX(H), CARRY only
    above KMAX / 2) and against covering r_pad."""
    k = ps.striped_rows_per_lane(H, r_pad)
    kmax = ps.MAX_ROWS_PER_LANE[H]
    carry = r_pad > H * k
    assert 1 <= k <= kmax and (not carry or 2 * k > kmax)
    assert ps.striped_stripes(H, k, r_pad) * H * k >= r_pad
    return k, carry


def group_segments(nprng, n_groups, r_pad, c_pad, chunk=None):
    """``n_groups`` groups packed raw by the runner's own host code and
    shipped (CPU), as segments; ``chunk`` (start, n) cuts the first group
    to a chunk that starts mid-group.  -> (segments, the shipped views,
    the table, the groups' ASCII pairs)."""
    runner = small_runner()
    job_sets = [make_jobs(nprng, [(4, 3), (2, 5), (3, 2)], r_pad, c_pad)
                for _ in range(n_groups)]
    # the second read (pairs 3..5) spans the pad: every stripe is live
    job_sets[0][0].reads[1] = (
        np.frombuffer(b"ACGTN", np.uint8)[nprng.integers(0, 5, r_pad)],
        (nprng.integers(10, 41, r_pad) + 33).astype(np.uint8))
    payloads = [pack(runner, "packed", jobs, r_pad, c_pad)
                for jobs in job_sets]
    views = join_payloads(payloads, False).ship(CPU)
    segments = segments_of(payloads, views)
    if chunk is not None:
        segments = [dataclasses.replace(segments[0], start=chunk[0],
                                        n=chunk[1])]
    pairs = [ascii_pairs(jobs) for jobs in job_sets]
    return segments, views, runner._ppe_tab, pairs


# name: (groups, r_pad by H (None: the carry shape of that H), c_pad, chunk)
CARRY_R = {8: 240, 16: 336, 32: 288}  # two stripes at each H's K rule
MODEL_CASES = {
    "group_96x64": (1, 96, 64, None),
    "two_groups_160x64": (2, 160, 64, None),
    "chunk_96x64": (1, 96, 64, (5, 11)),
    "carry_group": (1, None, 48, None),
    "carry_chunk": (1, None, 48, (3, 20)),
}


@pytest.mark.parametrize("H", ps.KERNEL_STRIPES)
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_lane_model_matches_glue(H, case):
    """Every row a lane loads and every hap slot a segment stages equals
    the plain glue's pair-major planes, through the table; each row below
    rlen is loaded exactly once and none at or past it.  Each group (or
    chunk) is its own launch."""
    n_groups, r_pad, c_pad, chunk = MODEL_CASES[case]
    r_pad = r_pad or CARRY_R[H]
    k, carry = instance(H, r_pad)
    assert carry == case.startswith("carry")
    nprng = np.random.default_rng(100 * H + sorted(MODEL_CASES).index(case))
    segments, views, table, _pairs = group_segments(nprng, n_groups, r_pad,
                                                    c_pad, chunk)
    assert len(segments) == n_groups
    mem = Memory([*views, table])
    models = []
    for seg in segments:
        ps.check_unique([seg], table, H)
        models.append(model_striped(pf.segment_rows("packed", [seg]), mem,
                                    table.data_ptr(), r_pad, c_pad, H, k))
    got_rows, got_hap, got_lens, loads = (
        np.concatenate([m[j] for m in models], axis=(1 if j in (0, 2) else 0))
        for j in range(4))
    tables = ps.element_tables(table)
    parts = [ps.segment_inputs_striped(seg, tables) for seg in segments]
    rc, omq, q3, hc, rl, cl, iy = (
        torch.cat([p[j] for p in parts]).numpy() for j in range(7))
    np.testing.assert_array_equal(
        got_lens, np.stack([rl, cl, iy.view(np.int32)]))
    ok = (rl >= 1) & (rl <= r_pad)
    assert carry == bool((rl > H * k).any())  # reads past one stripe
    loaded = (np.arange(r_pad)[None, :] < rl[:, None]) & ok[:, None]
    np.testing.assert_array_equal(loads, loaded.astype(np.int64))
    want = [code_mask(rc), omq.view(np.int32), q3.view(np.int32)]
    for got, plane in zip(got_rows, want):
        np.testing.assert_array_equal(got, np.where(loaded, plane, 0))
    staged = np.arange(c_pad)[None, :] < np.clip(cl, 0, c_pad)[:, None]
    if H == LANES:
        staged &= ok[:, None]
    np.testing.assert_array_equal(got_hap, np.where(staged, code_mask(hc), 0))
    assert loaded.any() and staged.any()
    if chunk is not None:
        assert got_lens.shape[1] == chunk[1]


# ---------------------------------------------------------------------------
# The shared table.


def test_element_table_equals_striped_tables():
    """The ppe kernel's 768-entry table, which the entry reads bytes
    through, holds the striped tables bit for bit for all 256 bytes: mask
    = code_mask(base code), 1 - q and q / 3 at qual & 127; the port's and
    the reference's tables are one; element_tables reads the striped
    tables back exactly."""
    table = pt.ppe_element_table(BASE_TABLE, PH2PR_F32)
    np.testing.assert_array_equal(
        table, ref_pallas.ppe_element_table(BASE_TABLE, PH2PR_F32))
    base, omq, q3 = ps.striped_tables(BASE_TABLE, PH2PR_F32)
    byte = np.arange(256)
    np.testing.assert_array_equal(table[:256], code_mask(base))
    np.testing.assert_array_equal(table[256:512], omq[byte & 127].view(np.int32))
    np.testing.assert_array_equal(table[512:768], q3[byte & 127].view(np.int32))
    got = ps.element_tables(torch.from_numpy(table))
    for g, w in zip(got, (base, omq, q3)):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint8), w.view(np.uint8))
    bad = table.copy()
    bad[65] = 3  # no base's mask
    with pytest.raises(ValueError, match="base masks"):
        ps.element_tables(torch.from_numpy(bad))


# ---------------------------------------------------------------------------
# The CPU route against the reference.


def _reference(views, total, dims, pairs, stripe):
    """The reference's striped glue on one group's shipped arrays: its
    prepare_tables_striped (jnp), the pair gathers of
    dispatch_pairs_striped (jnp.take) and its dispatch in interpret mode
    -> (pair-major inputs, the Pallas result)."""
    import jax.numpy as jnp

    u8, lens, _ = (v.numpy() for v in views)
    tabs = [jnp.asarray(t) for t in ps.striped_tables(BASE_TABLE, PH2PR_F32)]
    nr_pad, nh_pad, r_pad, c_pad = dims
    tables = ref_pallas.prepare_tables_striped(
        jnp.asarray(u8), jnp.asarray(lens), *tabs, nr_pad=nr_pad,
        nh_pad=nh_pad, r_pad=r_pad, c_pad=c_pad)
    pr, ph = jnp.asarray(pairs[0]), jnp.asarray(pairs[1])
    inputs = [np.asarray(jnp.take(t, idx, axis=0)) for t, idx in
              zip(tables, (pr, pr, pr, ph, pr, ph, ph))]
    # the reference's chunks are multiples of 128 pairs: pad with pair
    # (0, 0), as its runner does, and keep the chunk's own
    B = pairs.shape[1]
    padded = np.zeros((2, -(-B // 128) * 128), np.int32)
    padded[:, :B] = pairs
    ref = np.asarray(ref_pallas.dispatch_pairs_striped(
        *tables, jnp.asarray(padded), TRANS, r_pad=r_pad, c_pad=c_pad,
        stripe=stripe, interpret=True))[:B]
    return inputs, ref


@pytest.mark.parametrize("chunk", [None, (6, 17)])
def test_unique_route_matches_oracle_and_reference(chunk):
    """A group at (16, 64), H 8, whole and as a chunk: the entry's CPU
    route is bit-equal to the FTZ oracle, to the reference's glue inputs
    (exact) through the striped plain version, and held to the reference's
    Pallas dispatch in interpret mode (rtol 1e-6 and an identical share
    above 0.5, as tests/test_torch_striped.py holds it)."""
    r_pad, c_pad, H = 16, 64, 8
    nprng = np.random.default_rng(31 if chunk is None else 32)
    segments, views, table, (pairs,) = group_segments(nprng, 1, r_pad, c_pad,
                                                      chunk)
    seg = segments[0]
    a, b = seg.start, seg.start + seg.count
    before = dict(pt.LAUNCHES)
    got = ps.striped_forward_unique(segments, table, TRANS, H).numpy()
    assert pt.LAUNCHES == before  # the plain version is no launch
    want = np.array([np.float32(jax_oracle.pairhmm_prob(r, q, h, ftz=True))
                     for r, q, h in pairs[a:b]], np.float32)
    assert (want > 0).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    idx = views[2].view(2, seg.total)[:, a:b].numpy()
    inputs, ref = _reference(views, seg.total, seg.dims, idx, H)
    mine = ps.segment_inputs_striped(seg, ps.element_tables(table))
    for g, w in zip(mine, inputs):
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      w.view(np.uint8))
    ref_plain = ps.striped_forward_plain(
        *(torch.from_numpy(np.array(x)) for x in inputs), TRANS,
        H).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref_plain.view(np.int32))
    _hold_to_pallas(got, ref, 0.5)


def test_segments_concatenate_and_stripes_agree():
    """Two groups shipped together, each in its own launch (the entry
    takes one segment: two in one launch raise), concatenated, equal the
    FTZ oracle; H 8 and 16 give the same bits (the kernel's function
    does not depend on H)."""
    nprng = np.random.default_rng(41)
    r_pad, c_pad = 48, 40
    segments, _views, table, pairs = group_segments(nprng, 2, r_pad, c_pad)
    with pytest.raises(ValueError, match="one segment"):
        ps.striped_forward_unique(segments, table, TRANS, 8)
    both = np.concatenate([
        ps.striped_forward_unique([s], table, TRANS, 8).numpy()
        for s in segments])
    got = np.concatenate([
        ps.striped_forward_unique([s], table, TRANS, 16).numpy()
        for s in segments])
    np.testing.assert_array_equal(got.view(np.int32), both.view(np.int32))
    want = np.array([np.float32(jax_oracle.pairhmm_prob(r, q, h, ftz=True))
                     for p in pairs for r, q, h in p], np.float32)
    np.testing.assert_array_equal(both.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# The runner's striped path.


def test_runner_launches_the_entry_once_per_chunk(monkeypatch):
    """The striped runner hands each chunk of a group to the entry as one
    segment that starts at the chunk's first pair (a 132-pair group over
    a 128-pair budget: segments at 0 and 128), with the slot's 768-entry
    table and the stripe height; no gather stage is timed."""
    from tests.test_torch_striped import STRIPED_CFG, make_job, reference_results
    from tests.test_torch_striped import small_runner as striped_runner
    import random

    calls = []
    launch = ps.striped_forward_unique

    def recording(segments, table, trans, stripe=32):
        calls.append(([(s.start, s.count, s.total) for s in segments],
                      table.numel(), stripe))
        return launch(segments, table, trans, stripe)

    monkeypatch.setattr(ps, "striped_forward_unique", recording)
    rng = random.Random(1234)
    jobs = [make_job(rng, 12, 11), make_job(rng, 2, 3)]
    runner = striped_runner(STRIPED_CFG, pair_budget=128)
    runner.run(jobs)
    assert calls == [([(0, 128, 132)], 768, 8), ([(128, 4, 132)], 768, 8),
                     ([(0, 6, 6)], 768, 8)]
    assert runner.dispatch_counts == {"striped": 3}
    for job, ref in zip(jobs, reference_results(jobs)):
        np.testing.assert_array_equal(job.result, ref)
    assert "gather" not in runner.stage_medians()["sum_ms"]


def test_chip_smoke_records_striped_units(monkeypatch):
    """chip_smoke.py's recording of the striped entry's launch units (on
    the CPU the entry runs its plain version): one kept unit per launch,
    in launch order, each a clone of the chunk's segment with the table,
    the transitions, the stripe height and the wrapper's host ms; run
    again through the plain version, each gives the run's own result bit
    for bit, and the wrapper is restored after."""
    import random

    import chip_smoke
    from tests.test_torch_striped import STRIPED_CFG, make_job
    from tests.test_torch_striped import small_runner as striped_runner

    outs = []
    real = ps.striped_forward_unique

    def spy(segments, table, trans, stripe=32):
        out = real(segments, table, trans, stripe)
        outs.append(out.clone())
        return out

    monkeypatch.setattr(ps, "striped_forward_unique", spy)
    rng = random.Random(4321)
    jobs = [make_job(rng, 12, 11), make_job(rng, 2, 3)]
    runner = striped_runner(STRIPED_CFG, pair_budget=128)
    with chip_smoke.recording_striped_units() as units:
        runner.run(jobs)
    assert ps.striped_forward_unique is spy
    assert [[(s.start, s.count, s.total) for s in u[0]] for u in units] == [
        [(0, 128, 132)], [(128, 4, 132)], [(0, 6, 6)]]
    assert len(outs) == len(units)
    for (segs, tab, trans, stripe, host_ms), out in zip(units, outs):
        assert stripe == STRIPED_CFG.stripe_height and host_ms >= 0
        assert tab.numel() == 768
        again = ps.striped_forward_unique_plain(segs, tab, trans, stripe)
        assert torch.equal(again.view(torch.int32), out.view(torch.int32))


# ---------------------------------------------------------------------------
# Bad inputs and the binding.


def _segment(**change):
    u8 = torch.zeros(2 * 8 * 16 + 4 * 32, dtype=torch.uint8)
    lens = torch.ones(16, dtype=torch.int32)
    pairs = torch.zeros(8, dtype=torch.int32)
    seg = pf.Segment((u8, lens, pairs), (8, 4, 16, 32), 4)
    return dataclasses.replace(seg, **change)


def _pairs(values):
    return _segment(views=(*_segment().views[:2],
                           torch.tensor(values, dtype=torch.int32)))


BAD = {
    # name: (segments, stripe, table, error, message)
    "no_segment": ([], 8, None, ValueError, "at least one"),
    "table_dtype": ([_segment()], 8, torch.zeros(768, dtype=torch.int64),
                    ValueError, "768"),
    "two_shapes": ([_segment(), _segment(dims=(8, 4, 16, 16))], 8, None,
                   ValueError, "share"),
    "two_segments": ([_segment(), _segment()], 8, None, ValueError,
                     "one segment"),
    "nib_views": ([_segment(views=_segment().views[:2])], 8, None,
                  ValueError, "takes 3 views"),
    "pairs_dtype": ([_segment(views=(*_segment().views[:2],
                                     torch.zeros(8, dtype=torch.int64)))],
                    8, None, TypeError, "pairs must be"),
    "short_u8": ([_segment(views=(torch.zeros(40, dtype=torch.uint8),
                                  *_segment().views[1:]))], 8, None,
                 ValueError, "u8 is shorter"),
    "past_total": ([_segment(start=2, n=3)], 8, None, ValueError, "exceed"),
    "stripe_divides": ([_segment()], 12, None, ValueError, "divide"),
    "read_index": ([_pairs([0, 8, 0, 0, 0, 0, 0, 0])], 8, None, ValueError,
                   "pair indices"),
    "hap_index": ([_pairs([0, 0, 0, 0, 0, 0, 4, 0])], 8, None, ValueError,
                  "pair indices"),
    "negative_index": ([_pairs([0, 0, -1, 0, 0, 0, 0, 0])], 8, None,
                       ValueError, "pair indices"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_rejects_bad_inputs(case):
    segments, stripe, table, error, message = BAD[case]
    if table is None:
        table = small_runner()._ppe_tab
    with pytest.raises(error, match=message):
        ps.striped_forward_unique(segments, table, TRANS, stripe)


def _c_params(source, name):
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, name
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_binding_matches_c_signature():
    """The binding passes what the C entry takes (one segment row, the
    table, out, r_pad, c_pad, stripe, k, six floats, the stream; c_void_p
    for every pointer), the source's segment row width is the ppe entry's,
    and the entry's launch-shape query is bound as the pair-major one."""
    with open(f"{_kernels.CSRC}/pairhmm_striped.cu") as handle:
        source = handle.read()
    name = "pairhmm_striped_forward_unique"
    lib = types.SimpleNamespace(
        pairhmm_striped_forward=types.SimpleNamespace(),
        pairhmm_striped_forward_unique=types.SimpleNamespace(),
        pairhmm_striped_launch_shape=types.SimpleNamespace(),
        pairhmm_striped_unique_launch_shape=types.SimpleNamespace(),
    )
    _kernels._BINDERS["pairhmm_striped"](lib)
    params = _c_params(source, name)
    argtypes = getattr(lib, name).argtypes
    assert len(argtypes) == len(params) == 14
    for param, argtype in zip(params, argtypes):
        ctype = {"int": "c_int", "float": "c_float"}.get(param.split()[0],
                                                        "c_void_p")
        assert argtype.__name__ == ctype, (param, argtype)
    assert params[:3] == ["const void* seg", "const void* table", "void* out"]
    assert params[3:7] == ["int r_pad", "int c_pad", "int stripe", "int k"]
    assert params[-1] == "void* stream"
    m = re.search(r"constexpr int SEG_FIELDS = (\d+);", source)
    assert m and int(m.group(1)) == pf.SEG_FIELDS
    # the entry's own launch-shape query takes what the pair-major one takes
    shape = "pairhmm_striped_unique_launch_shape"
    assert _c_params(source, shape) == _c_params(
        source, "pairhmm_striped_launch_shape")
    assert [t.__name__ for t in getattr(lib, shape).argtypes] == [
        "c_int"] * 4 + ["c_void_p"]
    assert "striped_front_packed" in _kernels.LAUNCHES
