"""The warp-per-pair ppe kernel's schedule, on the CPU.

csrc/pairhmm_ppe.cu runs on the card only, so its schedule is modelled
here in numpy, step for step: stripes of 32 K rows, wavefront steps, 32
lanes of K rows each, "up" from lane j-1's bottom row of the step before
(``__shfl_up_sync``), lane 0's row 0 or carried row, the carry written by
lane 31, and the capture of row rlen's place in every lane with the lane
that holds row rlen reporting.  The model is held bit for bit against the
plain PyTorch version and the FTZ oracle at tiny sizes, with several
stripes, rlen at the lane and stripe edges, rlen 0, rlen > r_pad,
clen > c_pad and N bases; the rows-per-lane rule and the C interface's
arguments are checked against the wrapper and its binding."""

import re
import types

import numpy as np
import pytest
import torch

from gatk_hc_tpu_torch.ops import _kernels
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from tests.test_torch_pairhmm import ACGTN, TRANS, oracle, pair_major

LANES = 32
HAP_PAD = 32  # csrc/pairhmm_ppe.cu: zero slots around the staged hap
F32 = np.float32


def _f(x):
    """Flush subnormal f32 results to zero (the kernel's -ftz=true)."""
    return np.where(np.abs(x) < pt.MIN_NORMAL, F32(0), x).astype(F32)


def warp_model(rows, hap, rlen, clen, init_y, trans, k):
    """The kernel's schedule in numpy, one pair (warp) at a time, the 32
    lanes of a step as one vector (they read only the step before).  Same
    inputs as ``ppe_forward_plain`` (numpy, pair-minor) -> (B,) f32."""
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = (F32(t) for t in trans)
    r_pad, _, B = rows.shape
    c_pad = hap.shape[0]
    S = LANES * k
    lanes = np.arange(LANES)
    out = np.zeros(B, F32)
    for b in range(B):
        rl, iy = int(rlen[b]), F32(init_y[b])
        cl = max(0, min(int(clen[b]), c_pad))
        if not 1 <= rl <= r_pad:
            continue  # captures no row: 0
        hap_s = np.zeros(c_pad + 2 * HAP_PAD, np.int32)
        hap_s[HAP_PAD : HAP_PAD + cl] = hap[:cl, b]
        n = -(-rl // S)
        jr, qc = divmod(rl - 1 - (n - 1) * S, k)
        carry = np.zeros((3, c_pad + 1), F32)  # M, X, Y by column
        for s in range(n):
            r = s * S + lanes[:, None] * k + np.arange(k)[None, :]  # (32, k)
            live = r < rl
            rc = np.minimum(r, r_pad - 1)
            rs = np.where(live, rows[rc, 0, b], 0)
            omq = np.where(live, rows[rc, 1, b].view(F32), F32(0))
            q3 = np.where(live, rows[rc, 2, b].view(F32), F32(0))
            more = s + 1 < n
            steps = cl + (LANES - 1 if more else jr)
            md, xd, yd, ml, yl = (np.zeros((LANES, k), F32) for _ in range(5))
            if s == 0:
                yd[0, 0] = iy  # Y(0, 0): row 1's diagonal at column 1
            mo = xo = yo = np.zeros(LANES, F32)
            acc_m = acc_x = np.zeros(LANES, F32)
            for t in range(1, steps + 1):
                hw = hap_s[HAP_PAD - 1 - lanes + t]  # column t - lane
                # __shfl_up_sync(FULL, v, 1): lane j gets lane j-1's value
                MA, XA, YA = (np.concatenate([v[:1], v[:-1]]) for v in (mo, xo, yo))
                if s > 0:  # the carried row at column t
                    MA[0], XA[0], YA[0] = carry[:, t] if t <= cl else (0, 0, 0)
                else:  # row 0
                    MA[0], XA[0], YA[0] = 0, 0, iy
                for q in range(k):
                    dist = np.where((rs[:, q] & hw) != 0, omq[:, q], q3[:, q])
                    t1 = _f(md[:, q] * p_mm)
                    t2 = _f(xd[:, q] * p_gapm)
                    t3 = _f(yd[:, q] * p_gapm)
                    M = _f(_f(_f(t1 + t2) + t3) * dist)
                    X = _f(_f(MA * p_mx) + _f(XA * p_xx))
                    Y = _f(_f(ml[:, q] * p_my) + _f(yl[:, q] * p_yy))
                    if q == qc:
                        acc_m = _f(acc_m + M)
                        acc_x = _f(acc_x + X)
                    md[:, q], xd[:, q], yd[:, q] = MA, XA, YA
                    ml[:, q], yl[:, q] = M, Y
                    MA, XA, YA = M, X, Y
                mo, xo, yo = MA, XA, YA
                if more and t >= LANES:  # lane 31 reaches column t - 31
                    carry[:, t - (LANES - 1)] = mo[-1], xo[-1], yo[-1]
        out[b] = _f(acc_m[jr] + acc_x[jr])
    return out


def edge_pairs(rng, k, r_pad, c_pad):
    """ASCII pairs whose read lengths sit at the lane and stripe edges
    (1, k +- 1, 32k +- 1, r_pad), three times each: a read drawn from its
    haplotype with substitutions and N bases where it fits, at a random
    start or as its last r - 1 bases and one inserted base (so the last
    column of every row carries weight), else unrelated (which underflows
    once the read is long)."""
    S = LANES * k
    lengths = sorted({n for n in (1, k - 1, k, k + 1, S - 1, S, S + 1,
                                  r_pad - 1, r_pad) if 1 <= n <= r_pad})
    out = []
    for i, r in enumerate(lengths * 3):
        c = int(rng.integers(min(r, c_pad), c_pad + 1))
        hap = ACGTN[rng.integers(0, 4, c)]
        hap[rng.random(c) < 0.03] = ord("N")
        if i % 3 == 2 or r > c:
            read = ACGTN[rng.integers(0, 5, r)]
        else:
            s = int(rng.integers(0, c - r + 1))
            read = hap[s : s + r].copy()
            if i % 3:  # the haplotype's last r - 1 bases, then one inserted
                read = np.append(hap[c - r + 1 :], ACGTN[rng.integers(0, 4)])
            read[rng.random(r) < 0.05] = ACGTN[rng.integers(0, 4)]
            read[rng.random(r) < 0.03] = ord("N")
        qual = (rng.integers(2, 41, r) + 33).astype(np.uint8)
        out.append((read, qual, hap))
    return out


def pair_minor(rc, omq, q3, rl, hc, hl, iy):
    """forward_batch's conversion to the kernel's pair-minor inputs, numpy."""
    mask = lambda a: pt.base_mask(torch.from_numpy(a)).numpy()  # noqa: E731
    rows = np.stack([mask(rc), omq.view(np.int32), q3.view(np.int32)])
    return (np.ascontiguousarray(rows.transpose(2, 0, 1)),
            np.ascontiguousarray(mask(hc).T), rl, hl, iy)


@pytest.mark.parametrize("nr", [1, 2, 4, 8])
def test_rows_per_lane_rule(nr):
    """K = min(8, max(NR, ceil(r_pad / 32))): one stripe at every bucket
    (4 / 5 / 7 with the default NR 4), stripes of 256 rows above 256."""
    want = {1: (3, 5, 7), 2: (3, 5, 7), 4: (4, 5, 7), 8: (8, 8, 8)}[nr]
    for r_pad, k in zip((96, 160, 224), want):
        got = pt.rows_per_lane(pt.select_rows(nr, r_pad), r_pad)
        assert got == k and pt.ppe_stripes(got, r_pad) == 1
    assert pt.rows_per_lane(nr, 256) == 8 and pt.ppe_stripes(8, 256) == 1
    for r_pad, stripes in ((288, 2), (512, 2), (520, 3)):
        assert pt.rows_per_lane(pt.select_rows(nr, r_pad), r_pad) == 8
        assert pt.ppe_stripes(8, r_pad) == stripes
    assert pt.rows_per_lane(nr, 24) == nr  # NR is the floor
    assert pt.ppe_stripes(nr, 24) == 1


@pytest.mark.parametrize("k, r_pad, c_pad", [
    (1, 40, 48),    # 2 stripes of 32 rows
    (1, 100, 40),   # 4 stripes, reads longer than haps
    (2, 72, 80),    # 2 stripes of 64 rows
    (3, 90, 64),    # 1 stripe, lanes 30-31 past r_pad
    (4, 136, 144),  # 2 stripes of 128 rows
])
def test_warp_model_matches_plain_and_oracle(k, r_pad, c_pad):
    rng = np.random.default_rng(1000 * k + r_pad)
    pairs = edge_pairs(rng, k, r_pad, c_pad)
    rc, omq, q3, rl, hc, hl, iy = pair_major(pairs, r_pad, c_pad)
    want = oracle(pairs)
    assert (want > 0).any() and (want == 0).any()
    # three more pairs: rlen 0, rlen > r_pad, clen > c_pad (the first c_pad
    # columns are summed, init_y as given)
    extra = [0, 1, 2]
    rc, omq, q3, hc, iy = (np.concatenate([a, a[extra]]) for a in (rc, omq, q3, hc, iy))
    rl = np.concatenate([rl, [0, r_pad + 1, rl[2]]]).astype(np.int32)
    hl = np.concatenate([hl, [hl[0], hl[1], c_pad + 7]]).astype(np.int32)
    args = pair_minor(rc, omq, q3, rl, hc, hl, iy)
    with np.errstate(over="ignore", invalid="ignore"):
        got = warp_model(*args, TRANS, k)
    plain = pt.ppe_forward_plain(*(torch.from_numpy(a) for a in args), TRANS).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    n = len(pairs)
    np.testing.assert_array_equal(got[:n].view(np.int32), want.view(np.int32))
    assert got[n] == 0 and got[n + 1] == 0


def _c_params(source, name):
    """Parameters of ``extern "C" int name(...)`` in a kernel source."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, name
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_ppe_binding_matches_c_signature():
    """The binding passes what the C functions take: no scratch pointers,
    K (not NR), the unique-rows entry and a launch-shape query."""
    with open(f"{_kernels.CSRC}/pairhmm_ppe.cu") as handle:
        source = handle.read()
    names = ("pairhmm_ppe_forward", "pairhmm_ppe_forward_unique",
             "pairhmm_ppe_launch_shape")
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names})
    _kernels._BINDERS["pairhmm_ppe"](lib)
    for name in names:
        assert len(getattr(lib, name).argtypes) == len(_c_params(source, name))
    params = _c_params(source, "pairhmm_ppe_forward")
    assert params[:6] == ["const void* rows", "const void* hap", "const void* rlen",
                          "const void* clen", "const void* init_y", "void* out"]
    assert "int k" in params and not any("buf" in p for p in params)
    assert re.search(r"constexpr int MAX_K = (\d+);", source).group(1) == str(
        pt.MAX_ROWS_PER_LANE)
    assert re.search(r"constexpr int HAP_PAD = (\d+);", source).group(1) == str(
        HAP_PAD)


def test_ppe_variants_change_one_detail_each():
    """tools/ppe_variants.py edits the kernel's source by text: every
    variant must still find its lines, so each differs from the source
    that is built, and the predicated capture drops the per-place loop."""
    from gatk_hc_tpu_torch.tools import ppe_variants

    with open(f"{_kernels.CSRC}/pairhmm_ppe.cu") as handle:
        source = handle.read()
    found = ppe_variants.variants(source)
    assert found.pop("built") == source
    assert len(set(found.values())) == len(found)
    assert all(text != source for text in found.values())
    assert "if (q == qc)" in found["capture_predicated"]
    with pytest.raises(RuntimeError, match="varied lines"):
        ppe_variants.variants(source.replace("MAX_WARPS = 4", "MAX_WARPS = 6"))
