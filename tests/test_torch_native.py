"""The port's native whole-window call (hc_fused_run) refuses a window wider
than its downsample-select scratch instead of writing past it."""

import os

import pytest

from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.io.columnar import ColumnarReadStore
from gatk_hc_tpu_torch.io.fasta import read_all_fasta
from gatk_hc_tpu_torch.native import fused_window_fn

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fixtures")


@pytest.fixture(scope="module")
def chrm():
    contigs = read_all_fasta(os.path.join(FIXTURES, "chrM.fa"))
    seq = contigs[0].seq.upper()
    store = ColumnarReadStore(
        os.path.join(FIXTURES, "chrM.sam"), {c.name: len(c.seq) for c in contigs}
    )
    return store, seq


def _same(a, b):
    assert a[1] == b[1] and len(a[0]) == len(b[0]) and len(a[2]) == len(b[2])
    for ra, rb in zip(a[0], b[0]):
        assert ra.seq_u8.tobytes() == rb.seq_u8.tobytes()
    for ha, hb in zip(a[2], b[2]):
        assert ha.bases == hb.bases


def test_shrunk_select_scratch_raises(chrm):
    store, seq = chrm
    full = fused_window_fn(DEFAULT_CONFIG, store, {"chrM": seq})
    small = fused_window_fn(DEFAULT_CONFIG, store, {"chrM": seq}, sel_capacity=100)
    # a window that fits the shrunk scratch computes what the full one does
    _same(small("chrM", 4000, 4100, seq[4000:4100]),
          full("chrM", 4000, 4100, seq[4000:4100]))
    with pytest.raises(ValueError, match="downsample-select scratch"):
        small("chrM", 4000, 4415, seq[4000:4415])
    # and the scratch is still usable after the refusal
    _same(small("chrM", 4000, 4100, seq[4000:4100]),
          full("chrM", 4000, 4100, seq[4000:4100]))


def test_window_wider_than_default_scratch_raises(chrm):
    store, seq = chrm
    fn = fused_window_fn(DEFAULT_CONFIG, store, {"chrM": seq})
    reads, n_ds, _haps = fn("chrM", 4000, 4415, seq[4000:4415])
    assert n_ds > 0 and len(reads) > 0
    with pytest.raises(ValueError, match="downsample-select scratch"):
        fn("chrM", 0, 3000, seq[:3000])  # 3000 positions > 1024
