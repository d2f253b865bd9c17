"""The port's anti-diagonal engine (ops/pairhmm_diag.py, ops/batching.py,
DiagPairHMMRunner, --pairhmm diag) and --pairhmm auto, on the CPU, against
the FTZ oracle, the reference package's jnp engine
(gatk_hc_tpu/ops/pairhmm_jax.py) and the native engine's VCF.

Tolerances: the port is held bit-exact against the oracle (PyTorch runs
each multiply and add as its own op, so nothing is contracted) and the
VCF text exactly; against the reference's jnp forward on the CPU, which
XLA:CPU contracts into FMAs (tests/test_pairhmm_jax.py), rel 2e-6."""

import contextlib
import dataclasses
import io
import json
import os
import random

import numpy as np
import pytest
import torch

from gatk_hc_tpu import config as jax_config
from gatk_hc_tpu.ops import batching as jax_batching
from gatk_hc_tpu.ops import pairhmm_jax
from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch import config as torch_config
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.models.caller import call, call_batched
from gatk_hc_tpu_torch.ops import batching
from gatk_hc_tpu_torch.ops import pairhmm_diag as pd
from gatk_hc_tpu_torch.ops import pairhmm_oracle as oracle
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from gatk_hc_tpu_torch.ops.runner import DiagPairHMMRunner, PairHMMJob
from tests.test_pairhmm import make_pair, to_bytes
from tests.test_torch_runner import one_torch_thread  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")
SAM = os.path.join(FIXTURES, "chrM.sam")
FASTA = os.path.join(FIXTURES, "chrM.fa")
GOLDEN = os.path.join(FIXTURES, "chrM.golden.vcf")
TRANS = pd.transition_constants(ord("I"), ord("+"))
DIAG_CPU = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="diag")
NATIVE = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")


def some_pairs(seed, n=6):
    """tests/test_pairhmm_jax.py::TestJaxForward's inputs: n reads drawn
    from their haplotypes with 0-2 substitutions, every (read, hap)
    pair."""
    rng = random.Random(seed)
    read_arrays, hap_arrays = [], []
    for _ in range(n):
        read, quals, hap = make_pair(
            rng, rng.randint(12, 50), rng.randint(40, 100), rng.randint(0, 3)
        )
        read_arrays.append((to_bytes(read), to_bytes(quals)))
        hap_arrays.append(to_bytes(hap))
    return read_arrays, hap_arrays


def run_batch(read_arrays, hap_arrays, pair_read, pair_hap, flush=True):
    batch = batching.pack_pairs(read_arrays, hap_arrays, pair_read, pair_hap,
                                read_pad_buckets=(64,), hap_pad_buckets=(128,),
                                pair_batch=8)
    args = [torch.from_numpy(a) for a in pd.batch_to_device_args(batch)]
    probs = pd.pairhmm_forward_batch(
        *args, TRANS, r_pad=batch.shape[1], c_pad=batch.shape[2],
        flush_denormals=flush,
    )
    return probs.numpy()[: batch.n_valid], batch


@pytest.mark.parametrize("flush", [True, False])
def test_matches_oracle_bit_exact(flush):
    """Every pair bit-equal to the oracle, with flush-to-zero (the default:
    the reference's FTZ mode) and without it (the oracle's ftz=False)."""
    read_arrays, hap_arrays = some_pairs(1234)
    pair_read, pair_hap = batching.all_pairs(6, 6)
    got, _ = run_batch(read_arrays, hap_arrays, pair_read, pair_hap, flush)
    want = np.array([
        np.float32(oracle.pairhmm_prob(*read_arrays[r], hap_arrays[h],
                                       ftz=flush))
        for r, h in zip(pair_read, pair_hap)
    ], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got > 0).any()


def test_varied_lengths_padding_invariant():
    """The same pair packed alone and packed with longer others gives the
    same bits."""
    rng = random.Random(99)
    read, quals, hap = make_pair(rng, 33, 77, 2)
    ra = [(to_bytes(read), to_bytes(quals))]
    ha = [to_bytes(hap)]
    solo = run_batch(ra, ha, *batching.all_pairs(1, 1))[0][0]
    other_r, other_q, other_h = make_pair(rng, 50, 100, 1)
    ra2 = ra + [(to_bytes(other_r), to_bytes(other_q))]
    ha2 = ha + [to_bytes(other_h)]
    together = run_batch(ra2, ha2, *batching.all_pairs(2, 2))[0][0]
    assert np.float32(solo).view(np.int32) == np.float32(together).view(np.int32)


def test_matches_reference_jnp_forward():
    """The reference's jnp forward on the same batch: rel 2e-6 (XLA:CPU
    contracts its multiplies and adds into FMAs)."""
    read_arrays, hap_arrays = some_pairs(77)
    pair_read, pair_hap = batching.all_pairs(6, 6)
    got, batch = run_batch(read_arrays, hap_arrays, pair_read, pair_hap)
    want = np.asarray(pairhmm_jax.pairhmm_forward_batch(
        *pairhmm_jax.batch_to_device_args(batch), TRANS,
        r_pad=batch.shape[1], c_pad=batch.shape[2]))[: batch.n_valid]
    assert got == pytest.approx(want, rel=2e-6)


def test_batching_copy_matches_reference():
    """ops/batching.py packs what the reference's packs, and the forward's
    host arrays are the reference's, bit for bit; PAIR_BATCH is the
    reference's pair_batch default."""
    read_arrays, hap_arrays = some_pairs(5, n=5)
    pair_read, pair_hap = batching.all_pairs(5, 5)
    assert np.array_equal(pair_read, jax_batching.all_pairs(5, 5)[0])
    kw = dict(read_pad_buckets=(32, 64), hap_pad_buckets=(128,))
    got = batching.pack_pairs(read_arrays, hap_arrays, pair_read, pair_hap, **kw)
    want = jax_batching.pack_pairs(read_arrays, hap_arrays, pair_read,
                                   pair_hap, pair_batch=128, **kw)
    for field in dataclasses.fields(batching.PairBatch):
        assert np.array_equal(getattr(got, field.name),
                              getattr(want, field.name)), field.name
    assert got.shape == want.shape == (128, 64, 128)
    for a, b in zip(pd.batch_to_device_args(got),
                    pairhmm_jax.batch_to_device_args(want)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8))
    assert batching.PAIR_BATCH == jax_config.DEFAULT_CONFIG.pair_batch
    for t, u in zip(TRANS, pairhmm_jax.transition_constants(ord("I"), ord("+"))):
        assert np.float32(t).view(np.int32) == np.float32(u).view(np.int32)


def test_pipeline_rows_match_native():
    """TestJaxEngineEndToEnd: the per-region pipeline through the diag
    engine writes the native engine's rows for regions 2, 3 and 11."""
    keep = lambda i: i in (2, 3, 11)  # noqa: E731
    r_native = call(SAM, FASTA, None, NATIVE, region_filter=keep)
    r_diag = call(SAM, FASTA, None, DIAG_CPU, region_filter=keep,
                  device="cpu")
    rows_native = [v.to_vcf_row() for r in r_native for v in r.variants]
    rows_diag = [v.to_vcf_row() for r in r_diag for v in r.variants]
    assert rows_native == rows_diag
    assert rows_native


def test_batched_runner_matches_native(tmp_path):
    """call_batched builds the DiagPairHMMRunner for the diag engine (one
    engine call per job) and writes the native engine's VCF."""
    keep = lambda i: i in (2, 11)  # noqa: E731
    out_n, out_d = tmp_path / "n.vcf", tmp_path / "d.vcf"
    call_batched(SAM, FASTA, str(out_n), NATIVE, region_filter=keep)
    before = dict(pt.LAUNCHES)
    results = call_batched(SAM, FASTA, str(out_d), DIAG_CPU,
                           region_filter=keep, device="cpu")
    assert out_d.read_text() == out_n.read_text()
    assert sum(len(r.variants) for r in results) > 0
    assert pt.LAUNCHES == before


def test_diag_runner_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiagPairHMMRunner(DEFAULT_CONFIG)
    runner = DiagPairHMMRunner(DEFAULT_CONFIG, device="cpu")
    read_arrays, hap_arrays = some_pairs(3, n=2)
    job = PairHMMJob(read_arrays, hap_arrays)
    empty = PairHMMJob([], hap_arrays)
    runner.run([job, empty])
    assert job.result.shape == (2, 2) and np.isfinite(job.result).all()
    assert empty.result.shape == (0, 2)


def _cli(argv):
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(argv + ["--stats"])
    assert rc == 0
    return json.loads(stdout.getvalue().splitlines()[0])


def test_cli_diag_on_cpu_matches_native(tmp_path):
    """--pairhmm diag --device cpu on a slice of chrM writes the native
    engine's VCF for the same slice."""
    base = ["-I", SAM, "-R", FASTA, "-L", "chrM:490-1000"]
    native = _cli(base + ["-O", str(tmp_path / "n.vcf"), "--pairhmm", "native"])
    diag = _cli(base + ["-O", str(tmp_path / "d.vcf"), "--pairhmm", "diag",
                        "--device", "cpu"])
    assert (tmp_path / "d.vcf").read_text() == (tmp_path / "n.vcf").read_text()
    assert diag["engine"] == "diag" and diag["regions"] == native["regions"]
    assert "kernel_launches" not in diag


def test_auto_engine_resolution():
    """tests/test_cli.py's auto resolution, with the port's own threshold
    and "cuda" for the reference's "pallas"."""
    limit = torch_config.AUTO_NATIVE_MAX_SAM_BYTES
    resolve = torch_config.resolve_auto_pairhmm_engine
    assert resolve(0) == "native"
    assert resolve(limit - 1) == "native"
    assert resolve(limit) == "cuda"
    assert resolve(10 * limit) == "cuda"
    assert os.path.getsize(SAM) < limit  # chrM resolves to native


def test_cli_auto_engine_matches_golden(tmp_path):
    """chrM (1.1 MB of SAM) is under the threshold: the CLI picks the
    native engine and writes the golden VCF."""
    out = tmp_path / "o.vcf"
    stats = _cli(["-I", SAM, "-R", FASTA, "-O", str(out), "--pairhmm", "auto"])
    assert out.read_text() == open(GOLDEN).read()
    assert stats["engine"] == "native"
    assert stats["engine_requested"] == "auto"


def test_cli_auto_on_cpu_is_native(tmp_path, monkeypatch):
    """The auto threshold holds on the card only: with --device cpu a SAM
    past it still resolves to native (the threshold set to 0 makes chrM
    such a SAM), and the slice's VCF is the native one."""
    limit = torch_config.AUTO_NATIVE_MAX_SAM_BYTES
    assert torch_config.resolve_auto_pairhmm_engine(10 * limit, "cpu") == (
        "native")
    assert torch_config.resolve_auto_pairhmm_engine(10 * limit, "cuda") == (
        "cuda")
    monkeypatch.setattr(torch_config, "AUTO_NATIVE_MAX_SAM_BYTES", 0)
    base = ["-I", SAM, "-R", FASTA, "-L", "chrM:490-1000"]
    native = _cli(base + ["-O", str(tmp_path / "n.vcf"), "--pairhmm",
                          "native"])
    auto = _cli(base + ["-O", str(tmp_path / "a.vcf"), "--pairhmm", "auto",
                        "--device", "cpu"])
    assert (tmp_path / "a.vcf").read_text() == (tmp_path / "n.vcf").read_text()
    assert auto["engine"] == "native" and auto["engine_requested"] == "auto"
    assert auto["regions"] == native["regions"]
