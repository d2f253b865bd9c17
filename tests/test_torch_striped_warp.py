"""The striped kernel's schedule, on the CPU.

csrc/pairhmm_striped.cu runs on the card only, so its schedule is modelled
here in numpy, step for step, one warp at a time: segments of H lanes, one
pair each (32 / H pairs per warp, the last warp partly past B), K read rows
per lane, stripes of H K rows, a shared ``__reduce_max_sync`` count of
stripes and of steps, "up" from lane i-1's bottom row of the step before
(``__shfl_up_sync`` of width H), lane 0's row 0 or carried row, the carry
written by lane H-1 up to column clen, the hap staged as masks, and the
capture: per place of row rlen at H = 32, predicated on column <= clen and
the pair's last stripe at H < 32.  The model is held bit for bit against
the plain PyTorch version and the FTZ oracle at tiny sizes, with pairs of
different clen in one warp, several stripes, rlen at the lane and stripe
edges, rlen 0, rlen > r_pad, clen > c_pad and N bases; the rows-per-lane
rule, the base-mask match and the C interface's arguments are checked
against the wrapper and its binding."""

import re
import types

import numpy as np
import pytest
import torch

from gatk_hc_tpu.utils.quality import BASE_TABLE as JAX_BASE_TABLE
from gatk_hc_tpu_torch.ops import _kernels
from gatk_hc_tpu_torch.ops import pairhmm_striped as ps
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from gatk_hc_tpu_torch.utils.quality import BASE_TABLE
from tests.test_torch_pairhmm import ACGTN, TRANS, oracle, pair_major

LANES = 32
HAP_PAD = 32  # csrc/pairhmm_striped.cu: zero slots around the staged hap
F32 = np.float32


def _f(x):
    """Flush subnormal f32 results to zero (the kernel's -ftz=true)."""
    return np.where(np.abs(x) < pt.MIN_NORMAL, F32(0), x).astype(F32)


def code_mask(codes):
    """The kernel's code_mask: A0 C1 T2 G3 -> 1 << code, N4 -> 15."""
    codes = np.asarray(codes, np.int32)
    return np.where(codes == 4, 15, np.left_shift(1, codes)).astype(np.int32)


def warp_model(rc, omq, q3, hc, rlen, clen, init_y, trans, H, k):
    """The kernel's schedule in numpy, one warp at a time, its 32 lanes as
    one vector (a step reads only the step before).  Same pair-major inputs
    as ``striped_forward_plain`` (numpy) -> (B,) f32."""
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = (F32(t) for t in trans)
    B, r_pad = rc.shape
    c_pad = hc.shape[1]
    S = H * k
    lane = np.arange(LANES)
    i, seg = lane % H, lane // H
    up = np.where(i > 0, lane - 1, lane)  # __shfl_up_sync(.., 1, H)
    out = np.zeros(B, F32)
    for w in range(0, B, LANES // H):
        b = w + seg
        valid = b < B
        bb = np.minimum(b, B - 1)
        rl = np.where(valid, rlen[bb], 0)
        cl = np.where(valid, np.clip(clen[bb], 0, c_pad), 0)
        iy = np.where(valid, init_y[bb], F32(0)).astype(F32)
        ok = valid & (rl >= 1) & (rl <= r_pad)
        if H == LANES and not ok[0]:
            continue  # the whole warp returns 0
        n = np.where(ok, -(-rl // S), 0)
        jr, qc = np.divmod(rl - 1 - (n - 1) * S, k)
        # each segment's hap as masks, HAP_PAD zero slots around
        hap_s = np.zeros((LANES, c_pad + 2 * HAP_PAD), np.int32)
        cols = np.arange(c_pad)
        hap_s[:, HAP_PAD : HAP_PAD + c_pad] = np.where(
            cols[None, :] < cl[:, None], code_mask(hc[bb]), 0)
        carry = np.zeros((LANES // H, 3, c_pad + 1), F32)  # per segment
        acc_m = np.zeros(LANES, F32)
        acc_x = np.zeros(LANES, F32)
        for s in range(int(n.max())):  # __reduce_max_sync over segments
            live = s < n
            r = s * S + i[:, None] * k + np.arange(k)[None, :]  # (32, k)
            load = live[:, None] & (r < rl[:, None])
            rcl = np.minimum(r, r_pad - 1)
            rs = np.where(load, code_mask(rc[bb[:, None], rcl]), 0)
            om = np.where(load, omq[bb[:, None], rcl], F32(0))
            qq = np.where(load, q3[bb[:, None], rcl], F32(0))
            more = s + 1 < n
            steps = int(np.where(live, cl + np.where(more, H - 1, jr), 0).max())
            carry_lim = np.where(more & (i == H - 1), cl + H - 1, -1)
            cap_lim = np.where(live & ~more & (i == jr), cl + i, -1)
            md, xd, yd, ml, yl = (np.zeros((LANES, k), F32) for _ in range(5))
            if s == 0:
                yd[i == 0, 0] = iy[i == 0]  # Y(0, 0): row 1's diagonal
            mo = xo = yo = np.zeros(LANES, F32)
            if H == LANES:  # per place: every lane sums row qc, per stripe
                acc_m = np.zeros(LANES, F32)
                acc_x = np.zeros(LANES, F32)
            for t in range(1, steps + 1):
                hw = hap_s[lane, HAP_PAD - 1 - i + t]  # column t - i
                MA, XA, YA = mo[up], xo[up], yo[up]
                head = i == 0
                if s > 0:  # the carried row at column t, up to clen
                    inn = t <= cl
                    ct = min(t, c_pad)
                    MA = np.where(head, np.where(inn, carry[seg, 0, ct], 0), MA)
                    XA = np.where(head, np.where(inn, carry[seg, 1, ct], 0), XA)
                    YA = np.where(head, np.where(inn, carry[seg, 2, ct], 0), YA)
                else:  # row 0
                    MA = np.where(head, F32(0), MA)
                    XA = np.where(head, F32(0), XA)
                    YA = np.where(head, iy, YA)
                MA, XA, YA = (a.astype(F32) for a in (MA, XA, YA))
                cap = t <= cap_lim
                for q in range(k):
                    dist = np.where((rs[:, q] & hw) != 0, om[:, q], qq[:, q])
                    t1 = _f(md[:, q] * p_mm)
                    t2 = _f(xd[:, q] * p_gapm)
                    t3 = _f(yd[:, q] * p_gapm)
                    M = _f(_f(_f(t1 + t2) + t3) * dist)
                    X = _f(_f(MA * p_mx) + _f(XA * p_xx))
                    Y = _f(_f(ml[:, q] * p_my) + _f(yl[:, q] * p_yy))
                    if H == LANES:
                        if q == qc[0]:
                            acc_m = _f(acc_m + M)
                            acc_x = _f(acc_x + X)
                    else:  # predicated on the row and the column
                        take = cap & (q == qc)
                        acc_m = np.where(take, _f(acc_m + M), acc_m)
                        acc_x = np.where(take, _f(acc_x + X), acc_x)
                    md[:, q], xd[:, q], yd[:, q] = MA, XA, YA
                    ml[:, q], yl[:, q] = M, Y
                    MA, XA, YA = M, X, Y
                mo, xo, yo = MA, XA, YA
                wr = (t >= H) & (t <= carry_lim)
                for ln in np.flatnonzero(wr):  # lane H-1: column t - (H-1)
                    carry[seg[ln], :, t - (H - 1)] = mo[ln], xo[ln], yo[ln]
        for g in range(LANES // H):
            if not valid[g * H]:
                continue
            ln = g * H + (jr[g * H] if ok[g * H] else 0)
            out[b[ln]] = _f(acc_m[ln] + acc_x[ln]) if ok[ln] else F32(0)
    return out


def edge_pairs(rng, H, k, r_pad, c_pad):
    """ASCII pairs whose read lengths sit at the lane and stripe edges (1,
    k +- 1, H k +- 1, r_pad - 1, r_pad), three times each, each with its
    own hap length, so a warp holds pairs of different clen: a read drawn
    from its haplotype with substitutions and N bases where it fits, at a
    random start or as its last r - 1 bases and one inserted base (so the
    last column of every row carries weight), else unrelated."""
    S = H * k
    lengths = sorted({n for n in (1, k - 1, k, k + 1, S - 1, S, S + 1,
                                  r_pad - 1, r_pad) if 1 <= n <= r_pad})
    out = []
    for j, r in enumerate(lengths * 3):
        c = int(rng.integers(min(r, c_pad), c_pad + 1))
        hap = ACGTN[rng.integers(0, 4, c)]
        hap[rng.random(c) < 0.03] = ord("N")
        if j % 3 == 2 or r > c:
            read = ACGTN[rng.integers(0, 5, r)]
        else:
            s = int(rng.integers(0, c - r + 1))
            read = hap[s : s + r].copy()
            if j % 3:  # the haplotype's last r - 1 bases, then one inserted
                read = np.append(hap[c - r + 1 :], ACGTN[rng.integers(0, 4)])
            read[rng.random(r) < 0.05] = ACGTN[rng.integers(0, 4)]
            read[rng.random(r) < 0.03] = ord("N")
        qual = (rng.integers(2, 41, r) + 33).astype(np.uint8)
        out.append((read, qual, hap))
    return out


@pytest.mark.parametrize("H, k, r_pad, c_pad", [
    (8, 2, 40, 48),     # 3 stripes of 16 rows, 4 pairs per warp
    (8, 5, 40, 64),     # 1 stripe
    (8, 3, 48, 40),     # 2 stripes, reads longer than some haps
    (16, 2, 64, 48),    # 2 stripes of 32 rows, 2 pairs per warp
    (16, 4, 64, 80),    # 1 stripe
    (32, 1, 64, 48),    # 2 stripes of 32 rows, one pair per warp
    (32, 3, 96, 40),    # 1 stripe
    (32, 2, 96, 72),    # 2 stripes of 64 rows
])
def test_warp_model_matches_plain_and_oracle(H, k, r_pad, c_pad):
    rng = np.random.default_rng(1000 * H + 10 * k + r_pad)
    pairs = edge_pairs(rng, H, k, r_pad, c_pad)
    rc, omq, q3, rl, hc, hl, iy = pair_major(pairs, r_pad, c_pad)
    want = oracle(pairs)
    assert (want > 0).any() and (want == 0).any()
    if H < LANES:  # some warp holds pairs of different clen
        per_warp = hl[: len(hl) // (LANES // H) * (LANES // H)]
        assert (np.ptp(per_warp.reshape(-1, LANES // H), axis=1) > 0).any()
    # three more pairs: rlen 0, rlen > r_pad, clen > c_pad (the first c_pad
    # columns are summed, init_y as given); B then leaves the last warp
    # partly empty at H < 32
    extra = [0, 1, 2]
    rc, omq, q3, hc, iy = (np.concatenate([a, a[extra]]) for a in (rc, omq, q3, hc, iy))
    rl = np.concatenate([rl, [0, r_pad + 1, rl[2]]]).astype(np.int32)
    hl = np.concatenate([hl, [hl[0], hl[1], c_pad + 7]]).astype(np.int32)
    with np.errstate(over="ignore", invalid="ignore"):
        got = warp_model(rc, omq, q3, hc, rl, hl, iy, TRANS, H, k)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    plain = ps.striped_forward_plain(t(rc), t(omq), t(q3), t(hc), t(rl), t(hl),
                                     t(iy), TRANS, H).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    n = len(pairs)
    np.testing.assert_array_equal(got[:n].view(np.int32), want.view(np.int32))
    assert got[n] == 0 and got[n + 1] == 0


@pytest.mark.parametrize("H", ps.KERNEL_STRIPES)
def test_striped_rows_per_lane_rule(H):
    """The fewest stripes of at most KMAX(H) rows per lane, then the fewest
    rows per lane that fill them: H 32 holds every bucket in one stripe
    (K 3 / 5 / 7, as ppe's rule gives), H 16 and 8 too (K 6 / 10 / 14 and
    12 / 20 / 28); reads of 288 rows take two stripes at H 32 and 8."""
    want = {  # r_pad -> (K, stripes)
        32: {96: (3, 1), 160: (5, 1), 224: (7, 1), 288: (5, 2)},
        16: {96: (6, 1), 160: (10, 1), 224: (14, 1), 288: (18, 1)},
        8: {96: (12, 1), 160: (20, 1), 224: (28, 1), 288: (18, 2)},
    }[H]
    for r_pad, (k, stripes) in want.items():
        assert ps.striped_rows_per_lane(H, r_pad) == k
        assert ps.striped_stripes(H, k, r_pad) == stripes
    assert ps.striped_rows_per_lane(H, H) == 1
    kmax = ps.MAX_ROWS_PER_LANE[H]
    for r_pad in range(H, 80 * H, H):
        k = ps.striped_rows_per_lane(H, r_pad)
        n = ps.striped_stripes(H, k, r_pad)
        assert 1 <= k <= kmax
        assert n == -(-r_pad // (H * kmax))  # the fewest stripes
        assert H * (k - 1) * n < r_pad <= H * k * n  # the fewest rows
        assert n == 1 or 2 * k > kmax  # the kernel's carry instances
    if H == LANES:  # the ppe kernel's rule at NR 1, up to 256 rows
        for r_pad in (96, 160, 224, 256):
            assert ps.striped_rows_per_lane(H, r_pad) == pt.rows_per_lane(1, r_pad)


def test_code_mask_match_equals_code_compare():
    """(mask(r) & mask(h)) != 0 is the raw-code match (r == h) | (r == 4) |
    (h == 4) for every pair of codes 0..4 and for every pair of the 256
    bytes through the byte table (unknown bytes map to code 0)."""
    codes = np.arange(5)
    r, h = np.meshgrid(codes, codes, indexing="ij")
    want = (r == h) | (r == 4) | (h == 4)
    np.testing.assert_array_equal((code_mask(r) & code_mask(h)) != 0, want)
    np.testing.assert_array_equal(
        code_mask(codes), pt.base_mask(torch.from_numpy(codes)).numpy())
    assert set(np.unique(BASE_TABLE)) <= set(range(5))
    np.testing.assert_array_equal(BASE_TABLE, JAX_BASE_TABLE)
    rb, hb = np.meshgrid(BASE_TABLE, BASE_TABLE, indexing="ij")
    want = (rb == hb) | (rb == 4) | (hb == 4)
    np.testing.assert_array_equal((code_mask(rb) & code_mask(hb)) != 0, want)


def _c_params(source, name):
    """Parameters of ``extern "C" int name(...)`` in a kernel source."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, name
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_striped_binding_matches_c_signature():
    """The binding passes what the C functions take (k after the stripe
    height, a launch-shape query by r_pad, c_pad, stripe, k), and the
    source's KMAX and hap padding are the wrapper's."""
    with open(f"{_kernels.CSRC}/pairhmm_striped.cu") as handle:
        source = handle.read()
    lib = types.SimpleNamespace(
        pairhmm_striped_forward=types.SimpleNamespace(),
        pairhmm_striped_launch_shape=types.SimpleNamespace(),
    )
    _kernels._BINDERS["pairhmm_striped"](lib)
    for name in ("pairhmm_striped_forward", "pairhmm_striped_launch_shape"):
        params = _c_params(source, name)
        argtypes = getattr(lib, name).argtypes
        assert len(argtypes) == len(params)
        for param, argtype in zip(params, argtypes):
            ctype = {"int": "c_int", "float": "c_float"}.get(param.split()[0],
                                                            "c_void_p")
            assert argtype.__name__ == ctype, (param, argtype)
    params = _c_params(source, "pairhmm_striped_forward")
    assert params[8:13] == ["int B", "int r_pad", "int c_pad", "int stripe", "int k"]
    assert _c_params(source, "pairhmm_striped_launch_shape") == [
        "int r_pad", "int c_pad", "int stripe", "int k", "void* out"]
    for h in ps.KERNEL_STRIPES:
        kmax = re.search(rf"constexpr int KMAX_{h} = (\d+);", source).group(1)
        assert int(kmax) == ps.MAX_ROWS_PER_LANE[h]
    assert re.search(r"constexpr int HAP_PAD = (\d+);", source).group(1) == str(
        HAP_PAD)


def test_striped_variants_change_one_detail_each():
    """tools/ppe_variants.py edits the striped kernel's source by text:
    every variant must still find its lines, so each differs from the
    source that is built (but "min_rule", which runs the built library at
    another K), and the tool reads K back as the package's rule does."""
    from gatk_hc_tpu_torch.tools import ppe_variants

    with open(f"{_kernels.CSRC}/pairhmm_striped.cu") as handle:
        source = handle.read()
    found = ppe_variants.striped_variants(source)
    assert found.pop("built") == source
    assert found.pop("min_rule") == source
    assert len(set(found.values())) == len(found)
    assert all(text != source for text in found.values())
    for h in ps.KERNEL_STRIPES:
        assert ppe_variants.source_kmax(source, h) == ps.MAX_ROWS_PER_LANE[h]
        for r_pad in (96, 160, 224, 288):
            assert ppe_variants.variant_rows("built", source, h, r_pad) == (
                ps.striped_rows_per_lane(h, r_pad))
    assert ppe_variants.source_kmax(found["kmax12"], 8) == 12
    assert ppe_variants.source_kmax(found["kmax24"], 16) == 24
    assert ppe_variants.source_kmax(found["kmax20"], 8) == 20
    assert ppe_variants.source_kmax(found["kmax8"], 32) == ps.MAX_ROWS_PER_LANE[32]
    assert "mc = M;" in found["capture_select"] and "mc = M;" not in source
    rows = {  # H 16 at r_pad 160, 256, 352
        "min_rule": (10, 16, 20), "kmax8": (5, 8, 8), "kmax12": (10, 8, 11),
        "kmax16": (10, 16, 11), "kmax24": (10, 16, 22)}
    for name, want in rows.items():
        text = found.get(name, source)
        got = tuple(ppe_variants.variant_rows(name, text, 16, r) for r in (160, 256, 352))
        assert got == want, name
    with pytest.raises(RuntimeError, match="varied lines"):
        ppe_variants.striped_variants(source.replace("MAX_WARPS = 4", "MAX_WARPS = 6"))


def test_chip_smoke_names_every_striped_instance():
    """chip_smoke.py names instances from their mangled symbols by every
    template argument, so no two striped instances merge, and expects K
    1..KMAX(H), and K > KMAX(H) / 2 with the carry, at every H."""
    import chip_smoke

    sym = "_ZN12_GLOBAL__N_122striped_forward_kernelILi{}ELi{}ELb{}EEEvNS_4ArgsE"
    assert chip_smoke.instance_name(sym.format(8, 16, 1)) == "striped8_k16_carry"
    assert chip_smoke.instance_name(sym.format(32, 5, 0)) == "striped32_k5"
    ppe = "_ZN12_GLOBAL__N_118ppe_forward_kernelILi8ELb1EEEvPKiS2_S2_S2_PKfPfiii5Trans"
    assert chip_smoke.instance_name(ppe) == "ppe_k8_carry"
    want = chip_smoke.expected_instances("pairhmm_striped")
    assert len(want) == sum(k + k - k // 2 for k in ps.MAX_ROWS_PER_LANE.values())
    assert "striped16_k11_carry" in want and "striped16_k10_carry" not in want
    assert {"striped32_k8_carry", "striped32_k5", "striped8_k20_carry"} <= want
    assert len(chip_smoke.expected_instances("pairhmm_ppe")) == 16
