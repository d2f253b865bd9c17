"""The generator: deterministic per seed, sizes from the mix alone."""

import numpy as np
import pytest

from hcbench import gen


def test_same_seed_same_pool(cell):
    config, traffic = cell
    a = gen.make_pool(config, traffic, 2 ** 31 + 99)
    b = gen.make_pool(config, traffic, 2 ** 31 + 99)
    for (sa, qa, oa, ha), (sb, qb, ob, hb) in zip(a, b):
        assert np.array_equal(sa, sb) and np.array_equal(qa, qb)
        assert np.array_equal(oa, ob)
        assert all(np.array_equal(x, y) for x, y in zip(ha, hb))


def test_seeds_share_sizes_not_contents(cell):
    config, traffic = cell

    def sizes(pool):
        return [(off.size - 1, [h.size for h in haps])
                for _, _, off, haps in pool]

    a = gen.make_pool(config, traffic, 1)
    b = gen.make_pool(config, traffic, 2)
    assert sizes(a) == sizes(b)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))


def test_sizes_follow_the_shapes(cell):
    config, traffic = cell
    shapes = gen.region_shapes(config, traffic)
    pool = gen.make_pool(config, traffic, 5)
    assert len(pool) == len(shapes)
    q_lo, q_hi = traffic["qual_ascii"]
    for (seq, qual, off, haps), (hap_lens, read_lens) in zip(pool, shapes):
        assert [h.size for h in haps] == hap_lens
        assert np.diff(off).tolist() == read_lens
        assert seq.size == qual.size == off[-1]
        assert set(np.unique(seq)) <= set(b"ACGT")
        assert qual.min() >= q_lo and qual.max() <= q_hi
        assert len({h.tobytes() for h in haps}) == len(haps)


def test_reads_come_from_their_haplotypes():
    """Without substitutions, read i is a stretch of haplotype i mod n."""
    traffic = {"snps_per_hap_max": 1, "substitutions_per_read_max": 0,
               "qual_ascii": [53, 73]}
    shape = ([40, 37, 44], [20, 20, 20, 17, 9, 3])
    seq, _, off, haps = gen.make_region(traffic, shape, 0, 9)
    for i in range(len(off) - 1):
        read = seq[off[i]:off[i + 1]].tobytes()
        assert read in haps[i % 3].tobytes()


def test_encode_decode():
    line = gen.encode([415, 412], [151, 151, 150, 151, 10])
    assert line == "[[415,412],[[151,2],[150,1],[151,1],[10,1]]]"
    assert gen.decode(line) == ([415, 412], [151, 151, 150, 151, 10])


@pytest.mark.parametrize("name", ["wgs30x_2x151", "wgs30x_2x250"])
def test_recorded_shapes(name):
    """The cells' own files: the recorded regions fill the pool twice
    over what is in flight; reads no longer than the configuration's and
    than any haplotype; at most max_haplotypes haplotypes."""
    import json
    import os

    from conftest import ROOT

    def load(kind, name):
        with open(os.path.join(ROOT, "hcbench", kind, name + ".json")) as f:
            return json.load(f)

    traffic = load("traffic", "wgs")
    config = load("configs", name)
    shapes = gen.region_shapes(config, traffic)
    assert len(shapes) == config["regions"] >= 2 * (
        traffic["regions_per_submit"] * traffic["max_in_flight"])
    for hap_lens, read_lens in shapes:
        assert 1 <= len(hap_lens) <= config["max_haplotypes"]
        assert 1 <= min(read_lens)
        assert max(read_lens) <= min(config["read_length"], min(hap_lens))


def test_the_recorder_writes_what_decode_reads():
    from gatk_hc_tpu_torch.io.columnar import ReadPairs
    from gatk_hc_tpu_torch.ops.runner import PairHMMJob

    from hcbench import record_shapes

    seq = np.frombuffer(b"ACGTACGTAC", np.uint8)
    job = PairHMMJob(ReadPairs(seq, seq.copy(), np.array([0, 6, 10])),
                     [np.frombuffer(b"ACGTACGT", np.uint8),
                      np.frombuffer(b"ACGTAC", np.uint8)])
    rec = record_shapes.ShapeRecorder()
    rec.drain(rec.submit([job]))
    assert gen.decode(rec.lines[0]) == ([8, 6], [6, 4])
    assert job.result.shape == (2, 2)


def test_indels_land_where_placed():
    """A deletion removes a run of window bases, an insertion puts new
    bases in, and a haplotype without an indel differs by a SNP."""
    rng = np.random.default_rng(1)
    base = gen.ACGT[rng.integers(0, 4, 30)]
    haps = gen.make_haps(np.random.default_rng(2), base,
                         np.array([0, -3, 5, 0]), 0)
    text = [h.tobytes() for h in haps]
    b = base.tobytes()
    assert [len(t) for t in text] == [30, 27, 35, 30]
    assert text[0] == b and text[3] == b  # no SNPs asked for
    assert any(text[1] == b[:a] + b[a + 3:] for a in range(28))
    assert any(text[2][:a] + text[2][a + 5:] == b for a in range(31))
    haps = gen.make_haps(np.random.default_rng(3), base,
                         np.array([0, 0, 2]), 1)
    one_snp = [sum(x != y for x, y in zip(h.tobytes(), b)) for h in haps]
    assert one_snp[:2] == [0, 1] and len(haps[2]) == 32
