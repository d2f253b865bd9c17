"""The runner's native pack (native.pack_dict / pack_rows, through
TorchPairHMMRunner._row_sources) against its numpy fallback
(_unique_rows and the _pack_* writers): the whole shipped host buffer,
byte for byte, in every encoding, on benchmark-shaped groups and edge
cases; and the CPU runner's results and engagement counter with the
native library and without it."""

import dataclasses
import json
import os
import random

import numpy as np
import pytest

from gatk_hc_tpu_torch import native
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.io.columnar import ReadPairs
from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
from hcbench import gen
from tests.test_torch_runner import (  # noqa: F401 - autouse
    TINY_CFG, make_job, one_torch_thread)

HCBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hcbench")
SEED = 3_000_000_019  # past 32 bits, as the benchmark's seeds are

# each encoding as (runner configuration, path, chunks): nib, planes, raw
# bytes (nib off, and a group of several chunks), the striped path's bytes
ENCODINGS = {
    "nib": ({}, "packed", 1),
    "planes": ({}, "planes", 1),
    "bytes": ({"packed_nib": False}, "packed", 1),
    "bytes_chunks": ({}, "packed", 3),
    "planes_chunks": ({}, "planes", 2),
    "striped": ({"pallas_algo": "striped", "stripe_height": 8}, "striped",
                1),
}


def wgs_jobs(config: str, regions: int):
    """The first ``regions`` regions of the benchmark's ``wgs`` mix for
    ``config``, as the caller's columnar jobs."""
    with open(os.path.join(HCBENCH, "configs", config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HCBENCH, "traffic", "wgs.json")) as f:
        traffic = json.load(f)
    shapes = gen.region_shapes(cfg, traffic)[:regions]
    return [PairHMMJob(ReadPairs(s, q, o), h) for s, q, o, h in
            (gen.make_region(traffic, shape, k, SEED)
             for k, shape in enumerate(shapes))]


def columnar(reads, haps):
    """A columnar job of (bases, quals) byte strings."""
    lens = np.array([len(b) for b, _ in reads], np.int64)
    off = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    cat = lambda parts: np.frombuffer(b"".join(parts), np.uint8)  # noqa: E731
    return PairHMMJob(
        ReadPairs(cat([b for b, _ in reads]), cat([q for _, q in reads]),
                  off),
        [np.frombuffer(h, np.uint8) for h in haps])


def random_job(rng, n_reads, n_haps, read_len=(20, 60), hap_len=(60, 120),
               seq=b"ACGT", qual=range(53, 74)):
    reads = []
    for _ in range(n_reads):
        n = rng.randint(*read_len)
        reads.append((bytes(rng.choice(seq) for _ in range(n)),
                      bytes(rng.choice(qual) for _ in range(n))))
    haps = [bytes(rng.choice(b"ACGT") for _ in range(rng.randint(*hap_len)))
            for _ in range(n_haps)]
    return columnar(reads, haps)


def runner_for(encoding):
    changes, _path, _chunks = ENCODINGS[encoding]
    return TorchPairHMMRunner(dataclasses.replace(DEFAULT_CONFIG, **changes),
                              device="cpu")


def assert_same_payload(runner, encoding, jobs, group=None, r_pad=None,
                        c_pad=None, chunks=None):
    """Both routes' payloads of ``group`` (every job by default), at the
    given pads (by default the group's, which both routes size alike):
    the same path, shape, spans and every array's bytes.  -> the path."""
    _changes, path, default_chunks = ENCODINGS[encoding]
    chunks = default_chunks if chunks is None else chunks
    group = list(range(len(jobs))) if group is None else group
    pads = runner._pads_for_group(jobs, group)
    assert runner._row_sources(jobs, group).dims[2:] == pads
    if r_pad is None:
        r_pad, c_pad = pads
    got = runner._encode(runner._row_sources(jobs, group, r_pad, c_pad),
                         path, chunks)
    want = runner._encode(runner._unique_rows(jobs, group, r_pad, c_pad),
                          path, chunks)
    assert (got.path, got.dims, got.spans, got.total) == (
        want.path, want.dims, want.spans, want.total)
    assert got.buf.specs == want.buf.specs
    for k in range(len(want.buf.specs)):
        assert got.buf.array(k).tobytes() == want.buf.array(k).tobytes(), k
    return got.path


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
@pytest.mark.parametrize("config,regions", [("wgs30x_2x250", 120),
                                            ("wgs30x_2x151", 160)])
def test_wgs_group_ships_the_same_bytes(config, regions, encoding):
    jobs = wgs_jobs(config, regions)
    path = assert_same_payload(runner_for(encoding), encoding, jobs)
    assert path == {"nib": "packednib", "planes": "planes",
                    "planes_chunks": "planes"}.get(encoding, "packed")


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_read_exactly_r_pad_long(encoding):
    rng = random.Random(1)
    jobs = [random_job(rng, 5, 2, read_len=(10, 40)),
            random_job(rng, 3, 3, read_len=(64, 64))]
    runner = runner_for(encoding)
    _r_pad, c_pad = runner._pads_for_group(jobs, [0, 1])
    assert_same_payload(runner, encoding, jobs, r_pad=64, c_pad=c_pad)


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_group_filling_part_of_its_buckets(encoding):
    """A few reads and haps in buckets of 4,096 and 1,024 rows: the
    padding rows past the group's are what byte 0 encodes to."""
    rng = random.Random(2)
    jobs = [random_job(rng, rng.randint(1, 6), rng.randint(1, 4))
            for _ in range(5)]
    assert_same_payload(runner_for(encoding), encoding, jobs)


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_haps_clipped_to_c_pad(encoding):
    rng = random.Random(3)
    jobs = [random_job(rng, 4, 3, hap_len=(100, 300)) for _ in range(3)]
    runner = runner_for(encoding)
    r_pad, _ = runner._pads_for_group(jobs, [0, 1, 2])
    assert_same_payload(runner, encoding, jobs, r_pad=r_pad, c_pad=128)


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_group_of_several_chunks(encoding):
    """One oversized job (more pairs than the pair budget) and others."""
    rng = random.Random(4)
    jobs = [random_job(rng, 3, 2), random_job(rng, 40, 8),
            random_job(rng, 3, 2)]
    runner = runner_for(encoding)
    runner.pair_budget = 64
    assert runner._plan_groups(jobs) == [[0], [1], [2]]
    assert_same_payload(runner, encoding, jobs, group=[1], chunks=5)


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
@pytest.mark.parametrize("alphabet", ["seq", "qual"])
def test_overflowing_alphabet_ships_raw_bytes(encoding, alphabet):
    """9 distinct sequence bytes, or 33 distinct quality bytes, with byte
    0: nib cannot hold them and the group ships raw bytes, as numpy's."""
    rng = random.Random(5)
    seq, qual = ((b"ACGTNRYK", range(53, 74)) if alphabet == "seq" else
                 (b"ACGT", range(40, 72)))
    jobs = [random_job(rng, 30, 2, seq=seq, qual=qual) for _ in range(4)]
    runner = runner_for(encoding)
    assert assert_same_payload(runner, encoding, jobs) != "packednib"
    group = list(range(len(jobs)))
    assert runner._nib_dictionary(runner._row_sources(jobs, group)) is None


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_a_job_with_no_reads(encoding):
    """An empty read list in one job (its haps still take rows), columnar
    and tuple-list."""
    rng = random.Random(6)
    jobs = [random_job(rng, 4, 2),
            PairHMMJob(ReadPairs(np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                                 np.zeros(1, np.int64)),
                       [np.frombuffer(b"ACGTACGTAC", np.uint8)]),
            PairHMMJob([], [np.frombuffer(b"ACGTAC", np.uint8)]),
            random_job(rng, 3, 3)]
    assert_same_payload(runner_for(encoding), encoding, jobs)


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_tuple_list_jobs(encoding):
    """Generic jobs of per-read (bases, quals) arrays, beside columnar
    ones: their reads are joined per job and take the same pass."""
    rng = random.Random(7)
    jobs = [make_job(rng, rng.randint(1, 6), rng.randint(1, 3))
            for _ in range(6)]
    jobs.insert(2, random_job(rng, 5, 2))
    assert_same_payload(runner_for(encoding), encoding, jobs)


@pytest.mark.parametrize("name", ["planes", "nib", "packed", "striped"])
def test_cpu_runner_results_equal_without_the_native_library(name,
                                                             monkeypatch):
    """A seeded submit of several groups through the CPU runner: the
    results with the native pack equal those with the numpy fallback bit
    for bit, and the counter reads all native, then all numpy."""
    changes = {"planes": {}, "nib": {"dispatch_mode": "packed"},
               "packed": {"dispatch_mode": "packed", "packed_nib": False},
               "striped": {"pallas_algo": "striped",
                           "stripe_height": 8}}[name]
    cfg = dataclasses.replace(TINY_CFG, **changes)

    def run():
        rng = random.Random(8)
        jobs = [make_job(rng, rng.randint(1, 5), rng.randint(1, 3))
                for _ in range(10)]
        runner = TorchPairHMMRunner(cfg, device="cpu", pair_budget=24)
        runner.READ_BUCKETS = (8, 16)
        runner.HAP_BUCKETS = (8, 16)
        runner.run(jobs)
        return [job.result for job in jobs], runner

    results, runner = run()
    monkeypatch.setattr(native, "available", lambda: False)
    fallback, numpy_runner = run()
    for got, want in zip(results, fallback):
        assert got.tobytes() == want.tobytes()
    groups = len(runner.stage_ms["pack"])
    assert groups > 2 and groups == len(numpy_runner.stage_ms["pack"])
    path = {"planes": "planes", "nib": "packednib"}.get(name, "packed")
    assert runner.pack_counts == {path: {"native": groups, "numpy": 0}}
    assert numpy_runner.pack_counts == {path: {"native": 0, "numpy": groups}}
    assert runner.stage_medians()["pack_profile"] == runner.pack_counts


@pytest.mark.parametrize("fault", ["offsets_past_bytes", "short_quals"])
def test_malformed_jobs_raise_before_the_native_pass(fault):
    """Reads the native pass would read past their buffers are refused
    in Python, before any address reaches it."""
    rng = random.Random(9)
    jobs = [random_job(rng, 4, 2), random_job(rng, 3, 2)]
    if fault == "offsets_past_bytes":
        r = jobs[1].reads
        jobs[1] = PairHMMJob(ReadPairs(r.flat_seq[:-1], r.flat_qual, r.off),
                             jobs[1].haps)
    else:
        jobs[1] = PairHMMJob([(np.frombuffer(b"ACGT", np.uint8),
                               np.frombuffer(b"555", np.uint8))],
                             jobs[1].haps)
    with pytest.raises(ValueError, match="job 1"):
        runner_for("nib")._row_sources(jobs, [0, 1])


@pytest.mark.parametrize("fault", ["short_output", "missing_read_length",
                                   "short_table"])
def test_pack_rows_refuses_arrays_that_do_not_fit(fault):
    rng = random.Random(10)
    jobs = [random_job(rng, 4, 2), random_job(rng, 3, 2)]
    s = runner_for("nib")._row_sources(jobs, [0, 1])
    nr_pad, nh_pad, r_pad, c_pad = s.dims
    out = np.zeros(nr_pad * r_pad - (fault == "short_output"), np.uint8)
    row_lens = s.row_lens[: s.row_lens.size - (fault == "missing_read_length")]
    tab = np.zeros(512 - (fault == "short_table"), np.uint8)
    with pytest.raises(ValueError):
        native.pack_rows(s.jobs, row_lens, nr_pad, r_pad, s.hap_flat,
                         s.hap_row_lens, nh_pad, c_pad, "nib", tab, out,
                         np.zeros(nh_pad * c_pad, np.uint8), None)
