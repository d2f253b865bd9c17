"""The port's ppe forward (its plain PyTorch version, which is what a CPU
tensor runs) against the reference package: the NumPy oracle bit for bit,
the Pallas ppe kernels in interpret mode and the jnp engine within the
bounds those tests use themselves."""

import numpy as np
import pytest
import torch

from gatk_hc_tpu.ops import pairhmm_oracle as jax_oracle
from gatk_hc_tpu.ops.pairhmm_jax import pairhmm_forward_batch
from gatk_hc_tpu.ops.pairhmm_pallas import _pallas_forward, _unpack_planes
from gatk_hc_tpu.utils.quality import BASE_TABLE, INITIAL_CONSTANT_F32, PH2PR_F32
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt

TRANS = pt.transition_constants(ord("I"), ord("+"))
ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def random_pairs(rng, n, max_r, max_c):
    """ASCII (read, qual, hap) triples: reads drawn from their haplotype with
    substitutions, N bases on both sides, and a share of unrelated pairs
    whose probability underflows to 0 under FTZ."""
    out = []
    for k in range(n):
        c = int(rng.integers(max(2, max_c // 3), max_c + 1))
        r = int(rng.integers(1, min(max_r, c) + 1))
        hap = ACGTN[rng.integers(0, 4, c)]
        hap[rng.random(c) < 0.03] = ord("N")
        if k % 4 == 3:  # unrelated
            read = ACGTN[rng.integers(0, 5, r)]
        else:
            s = int(rng.integers(0, c - r + 1))
            read = hap[s : s + r].copy()
            read[rng.random(r) < 0.05] = ACGTN[rng.integers(0, 4)]
            read[rng.random(r) < 0.03] = ord("N")
        qual = (rng.integers(2, 41, r) + 33).astype(np.uint8)
        out.append((read, qual, hap))
    return out


def pair_major(pairs, r_pad, c_pad):
    """_pallas_forward's inputs for ASCII pairs: codes A0 C1 T2 G3 N4,
    1 - q and q / 3 computed on the host, lengths, INITIAL / haplen."""
    B = len(pairs)
    rc = np.zeros((B, r_pad), np.int32)
    omq = np.zeros((B, r_pad), np.float32)
    q3 = np.zeros((B, r_pad), np.float32)
    hc = np.zeros((B, c_pad), np.int32)
    rl = np.zeros(B, np.int32)
    hl = np.zeros(B, np.int32)
    for k, (read, qual, hap) in enumerate(pairs):
        rl[k], hl[k] = len(read), len(hap)
        rc[k, : len(read)] = BASE_TABLE[read]
        q = PH2PR_F32[qual & 127]
        omq[k, : len(read)] = np.float32(1.0) - q
        q3[k, : len(read)] = q / np.float32(3.0)
        hc[k, : len(hap)] = BASE_TABLE[hap]
    iy = (INITIAL_CONSTANT_F32 / hl.astype(np.float32)).astype(np.float32)
    return rc, omq, q3, rl, hc, hl, iy


def oracle(pairs):
    return np.array(
        [np.float32(jax_oracle.pairhmm_prob(r, q, h, ftz=True)) for r, q, h in pairs],
        np.float32,
    )


def test_plain_equals_oracle_bitwise():
    rng = np.random.default_rng(2024)
    pairs = random_pairs(rng, 96, 40, 100)
    got = pt.forward_batch(*pair_major(pairs, 40, 128), TRANS, 40, 128).numpy()
    want = oracle(pairs)
    assert (want == 0).any() and (want > 0).any()  # underflow and not
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def pallas_ppe_case():
    """The inputs of tests/test_pallas.py::TestPairPerElementKernel, each NR
    instance of the reference ppe kernel on them in interpret mode, and the
    FTZ oracle on every pair.  The four interpret programs compile in
    threads (XLA compiles outside the GIL) while the oracle runs."""
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    nprng = np.random.default_rng(1234)
    B, R, C = 1024, 16, 64
    rc = nprng.integers(0, 5, (B, R)).astype(np.int32)  # incl N=4
    q = nprng.integers(1, 40, (B, R))
    omq = (1.0 - PH2PR_F32[q + 33]).astype(np.float32)
    q3 = (PH2PR_F32[q + 33] / np.float32(3.0)).astype(np.float32)
    rl = nprng.integers(5, R + 1, B).astype(np.int32)
    hc = nprng.integers(0, 5, (B, C)).astype(np.int32)
    hl = nprng.integers(20, C + 1, B).astype(np.int32)
    iy = (np.float32(2.0**120) / hl.astype(np.float32)).astype(np.float32)
    args = (rc, omq, q3, rl, hc, hl, iy)

    def pallas(nr):
        return np.asarray(_pallas_forward(
            *(jnp.asarray(a) for a in args), TRANS, R, C, 8, True,
            algo="ppe", ppe_rows=nr,
        ))

    with ThreadPoolExecutor(4) as pool:
        refs = dict(zip((1, 2, 4, 8), pool.map(pallas, (1, 2, 4, 8))))
        acgtn = np.frombuffer(b"ACTGN", np.uint8)  # code -> byte
        want = np.array([
            np.float32(jax_oracle.pairhmm_prob(
                acgtn[rc[k, : rl[k]]], (q[k, : rl[k]] + 33).astype(np.uint8),
                acgtn[hc[k, : hl[k]]], ftz=True,
            ))
            for k in range(B)
        ], np.float32)
    return args, R, C, refs, want


# per NR: the share of pairs bit-identical to the interpret program, just
# under the share measured on these inputs (0.532, 0.532, 0.535, 0.614)
PALLAS_IDENTICAL_FLOOR = {1: 0.52, 2: 0.52, 4: 0.52, 8: 0.60}


@pytest.mark.parametrize("nr", [1, 2, 4, 8])
def test_matches_pallas_ppe_interpret(nr, pallas_ppe_case):
    """Each NR instance of the reference ppe kernel (interpret mode)
    against the port.  XLA:CPU contracts mul+add into FMA in interpret
    mode, so the Pallas program is not exact on the CPU: on these inputs it
    differs from the FTZ oracle on 39-47% of pairs, by up to 9.7e-7
    relative, while the port equals the oracle bit for bit on every pair.
    The JAX tests' tighter ppe bounds (rtol 2.4e-7 to 1e-6, 75-98%
    identical) compare two contracted Pallas programs with each other;
    against an exact result the drift is bounded here by rtol 1e-6 and the
    identical share by PALLAS_IDENTICAL_FLOOR."""
    args, R, C, refs, want = pallas_ppe_case
    got = pt.forward_batch(*args, TRANS, R, C, nr).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = refs[nr]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert np.mean(got == ref) > PALLAS_IDENTICAL_FLOOR[nr]


def test_matches_jnp_engine():
    import jax.numpy as jnp

    rng = np.random.default_rng(99)
    pairs = random_pairs(rng, 48, 30, 90)
    args = pair_major(pairs, 32, 96)
    ref = np.asarray(
        pairhmm_forward_batch(
            *(jnp.asarray(a) for a in args), TRANS, r_pad=32, c_pad=96,
            flush_denormals=True,
        )
    )
    got = pt.forward_batch(*args, TRANS, 32, 96).numpy()
    # rel 2e-6: tests/test_pairhmm_jax.py's bound (XLA:CPU contracts FMAs)
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0)


def _plane_buffer(rng, nr_pad, nh_pad, r_pad, c_pad):
    mask, omq_bits, q3_bits = pt.plane_tables(BASE_TABLE, PH2PR_F32)
    read_u8 = ACGTN[rng.integers(0, 5, (nr_pad, r_pad))]
    qual_u8 = (rng.integers(2, 41, (nr_pad, r_pad)) + 33).astype(np.uint8)
    hap_u8 = ACGTN[rng.integers(0, 5, (nh_pad, c_pad))]
    rlens = rng.integers(1, r_pad + 1, nr_pad).astype(np.int32)
    hlens = rng.integers(r_pad, c_pad + 1, nh_pad).astype(np.int32)
    iy = (INITIAL_CONSTANT_F32 / hlens.astype(np.float32)).astype(np.float32)
    return np.concatenate([
        rlens, hlens, iy.view(np.int32), mask[read_u8].ravel(),
        omq_bits[qual_u8].ravel(), q3_bits[qual_u8].ravel(), mask[hap_u8].ravel(),
    ]).astype(np.int32)


def test_planes_gather_matches_jax_unpack_and_gather():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    nr_pad, nh_pad, r_pad, c_pad, B = 16, 8, 24, 64, 300
    buf = _plane_buffer(rng, nr_pad, nh_pad, r_pad, c_pad)
    pairs = np.stack([
        rng.integers(0, nr_pad, B), rng.integers(0, nh_pad, B)
    ]).astype(np.int32)
    rows, hap, rlen, clen, iy = pt.gather_pairs(
        torch.from_numpy(buf), torch.from_numpy(pairs), nr_pad, nh_pad, r_pad, c_pad
    )
    ru, hu, read_lens, hap_lens, init_y = _unpack_planes(
        jnp.asarray(buf), nr_pad, nh_pad, r_pad, c_pad
    )
    pr, ph = jnp.asarray(pairs[0]), jnp.asarray(pairs[1])
    want_rows = np.asarray(jnp.take(ru, pr, axis=1)).transpose(2, 0, 1)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_array_equal(hap.numpy(), np.asarray(jnp.take(hu, ph, axis=0)).T)
    np.testing.assert_array_equal(rlen.numpy(), np.asarray(jnp.take(read_lens, pr)))
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jnp.take(hap_lens, ph)))
    np.testing.assert_array_equal(
        iy.numpy().view(np.int32), np.asarray(jnp.take(init_y, ph)).view(np.int32)
    )
    out = pt.pairhmm_planes(
        torch.from_numpy(buf), torch.from_numpy(pairs), TRANS,
        nr_pad, nh_pad, r_pad, c_pad, 4,
    )
    assert out.shape == (B,) and out.dtype == torch.float32


def test_padding_invariant():
    rng = np.random.default_rng(3)
    pairs = random_pairs(rng, 12, 30, 80)
    small = pt.forward_batch(*pair_major(pairs, 32, 96), TRANS, 32, 96).numpy()
    big = pt.forward_batch(*pair_major(pairs, 64, 160), TRANS, 64, 160).numpy()
    alone = pt.forward_batch(*pair_major(pairs[:1], 32, 96), TRANS, 32, 96).numpy()
    np.testing.assert_array_equal(small.view(np.int32), big.view(np.int32))
    assert alone[0].view(np.int32) == small[0].view(np.int32)


def test_out_of_range_lengths_capture_nothing():
    """rlen outside 1..r_pad captures no row (the TPU kernel's row mask
    never fires); clen past c_pad sums every column."""
    rng = np.random.default_rng(8)
    pairs = random_pairs(rng, 4, 16, 60)
    rc, omq, q3, rl, hc, hl, iy = pair_major(pairs, 16, 64)
    rl = rl.copy()
    rl[0], rl[1] = 0, 17
    got = pt.forward_batch(rc, omq, q3, rl, hc, hl, iy, TRANS, 16, 64).numpy()
    assert got[0] == 0 and got[1] == 0


def test_select_rows_follows_pallas_rule():
    assert [pt.select_rows(n, 160) for n in (1, 2, 4, 8)] == [1, 2, 4, 8]
    assert pt.select_rows(8, 164) == 2  # 8 refused -> 2, as _pallas_call_ppe
    assert pt.select_rows(4, 162) == 2
    assert pt.select_rows(4, 33) == 1


def test_wrapper_checks_inputs():
    rows = torch.zeros((8, 3, 4), dtype=torch.int32)
    hap = torch.zeros((16, 4), dtype=torch.int32)
    lens = torch.ones(4, dtype=torch.int32)
    iy = torch.ones(4, dtype=torch.float32)
    with pytest.raises(TypeError):
        pt.ppe_forward(rows, hap, lens, lens, lens, TRANS)  # init_y dtype
    with pytest.raises(ValueError):
        pt.ppe_forward(rows, hap[:, :3], lens, lens, iy, TRANS)
    with pytest.raises(ValueError):
        pt.ppe_forward(rows, hap.t().contiguous().t(), lens, lens, iy, TRANS)
    before = dict(pt.LAUNCHES)
    pt.ppe_forward(rows, hap, lens, lens, iy, TRANS)  # CPU: plain version
    assert pt.LAUNCHES == before
