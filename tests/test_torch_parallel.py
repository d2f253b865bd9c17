"""The port's multi-device and multi-process layer on the CPU, against the
reference package: the sharded raw step over a grid of CPU slots, the
shardmap runner end to end, the runner's round-robin over slots, and the
single-process side of parallel/multihost.py (record encoding, shard
ranges, gathers, per-process manifests).  Counterparts of
tests/test_parallel.py and tests/test_sharding.py::TestShardRanges.

Tolerances: raw f32 probabilities, best and underflow counts are compared
bit for bit; VCF text and encoded records byte for byte."""

import dataclasses
import functools
import os
import random

import numpy as np
import pytest
import torch

from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.models.caller import call_batched as jax_call_batched
from gatk_hc_tpu.models.haplotype import Variant as JaxVariant
from gatk_hc_tpu.ops import pairhmm_jax
from gatk_hc_tpu.parallel import multihost as jax_multihost
from gatk_hc_tpu.parallel import sharded_step as jax_sharded
from gatk_hc_tpu.utils.interval import Interval as JaxInterval
from gatk_hc_tpu.utils.logging import RunCounters as JaxCounters
from gatk_hc_tpu.utils.logging import StageTimers as JaxTimers
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.io.fasta import read_all_fasta
from gatk_hc_tpu_torch.models.caller import call_batched
from gatk_hc_tpu_torch.models.haplotype import Variant
from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
from gatk_hc_tpu_torch.ops.engines import make_pairhmm_engine
from gatk_hc_tpu_torch.ops.runner import (
    PairHMMJob,
    TorchPairHMMRunner,
    local_devices,
)
from gatk_hc_tpu_torch.parallel import multihost
from gatk_hc_tpu_torch.parallel.sharded_step import (
    HAP_SPECS,
    READ_SPECS,
    ShardMapPairHMMRunner,
    _forward_local,
    _pow2_multiple,
    make_mesh,
    make_sharded_raw_step,
    shard_inputs,
)
from gatk_hc_tpu_torch.utils.interval import Interval
from gatk_hc_tpu_torch.utils.logging import RunCounters, StageTimers
from tests.test_multicontig import write_two_contig_fixture
from tests.test_parallel import _mesh_workload
from tests.test_torch_runner import make_job, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")
SAM = os.path.join(FIXTURES, "chrM.sam")
FASTA = os.path.join(FIXTURES, "chrM.fa")
GOLDEN = os.path.join(FIXTURES, "chrM.golden.vcf")
TRANS = pt.transition_constants(ord("I"), ord("+"))
CPU8 = ["cpu"] * 8


def cpu_grid(n=8, hap_parallel=2):
    return make_mesh(n, hap_parallel=hap_parallel, devices=["cpu"] * n)


def padded_workload(n_reads, n_haps, data_n, hap_n, r_pad=16, c_pad=128):
    """_mesh_workload's arrays with the rows padded to _pow2_multiple of
    the grid (the shardmap runner's padding: len 1, code 0 rows)."""
    rc, omq, q3, rl, hc, hl, iy = _mesh_workload(n_reads, n_haps, r_pad, c_pad)
    nr_pad = _pow2_multiple(n_reads, data_n)
    nh_pad = _pow2_multiple(n_haps, hap_n)

    def pad(a, n, fill):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    return (pad(rc, nr_pad, 0), pad(omq, nr_pad, 1), pad(q3, nr_pad, 0),
            pad(rl, nr_pad, 1), pad(hc, nh_pad, 0), pad(hl, nh_pad, 1),
            pad(iy, nh_pad, iy[0]))


def reference_step(arrays, r_pad, c_pad, monkeypatch):
    """The JAX package's make_sharded_raw_step (use_pallas=False) on its
    8-virtual-device (4, 2) CPU mesh.  Its jnp forward runs in its FTZ
    mode (flush_denormals=True), the arithmetic the port's kernels and
    the oracle share: unflushed, XLA:CPU keeps subnormal intermediates
    that the oracle flushes."""
    monkeypatch.setattr(
        pairhmm_jax, "pairhmm_forward_batch",
        functools.partial(pairhmm_jax.pairhmm_forward_batch,
                          flush_denormals=True))
    mesh = jax_sharded.make_mesh(8, hap_parallel=2)
    step = jax_sharded.make_sharded_raw_step(
        mesh, pairhmm_jax.transition_constants(ord("I"), ord("+")),
        r_pad, c_pad, use_pallas=False, cfg=JAX_DEFAULT_CONFIG)
    raw, best, n_rescue = step(*jax_sharded.shard_inputs(
        mesh, arrays, jax_sharded.READ_SPECS + jax_sharded.HAP_SPECS))
    return np.asarray(raw), np.asarray(best), np.asarray(n_rescue)


class TestShardedStep:
    @pytest.mark.parametrize("n_reads,n_haps", [(16, 4), (32, 6), (13, 3)])
    def test_raw_matches_reference_and_unsharded_bitwise(
            self, n_reads, n_haps, monkeypatch):
        """The 4 x 2 grid of CPU slots gives the reference's sharded step's
        raw grid, best and underflow count bit for bit, and the port's
        unsharded forward's grid.  (13, 3) pads both axes to
        _pow2_multiple of the grid, as the shardmap runner does."""
        r_pad, c_pad = 16, 128
        arrays = padded_workload(n_reads, n_haps, 4, 2, r_pad, c_pad)
        grid = cpu_grid()
        step = make_sharded_raw_step(grid, TRANS, r_pad, c_pad, DEFAULT_CONFIG)
        raw, best, n_rescue = step(*shard_inputs(grid, arrays,
                                                 READ_SPECS + HAP_SPECS))
        want_raw, want_best, want_rescue = reference_step(
            arrays, r_pad, c_pad, monkeypatch)
        np.testing.assert_array_equal(raw, want_raw)
        np.testing.assert_array_equal(best, want_best)
        np.testing.assert_array_equal(n_rescue, want_rescue)
        unsharded = _forward_local(
            *(torch.from_numpy(a) for a in arrays), TRANS, r_pad, c_pad,
            ppe_rows=DEFAULT_CONFIG.ppe_rows).numpy()
        np.testing.assert_array_equal(raw, unsharded)
        np.testing.assert_array_equal(best, unsharded.max(axis=1))
        assert raw.shape == (arrays[0].shape[0], arrays[4].shape[0])

    def test_unflushed_reference_within_rel_bound(self):
        """Without its FTZ mode the reference's jnp step differs from the
        flushed arithmetic in the last bits only where subnormal
        intermediates feed a result: rel 2e-6 (tests/test_pairhmm_jax.py's
        bound); the underflow count is the same."""
        r_pad, c_pad = 16, 128
        arrays = _mesh_workload(16, 4, r_pad, c_pad)
        mesh = jax_sharded.make_mesh(8, hap_parallel=2)
        step = jax_sharded.make_sharded_raw_step(
            mesh, pairhmm_jax.transition_constants(ord("I"), ord("+")),
            r_pad, c_pad, use_pallas=False, cfg=JAX_DEFAULT_CONFIG)
        want, _best, want_rescue = step(*jax_sharded.shard_inputs(
            mesh, arrays, jax_sharded.READ_SPECS + jax_sharded.HAP_SPECS))
        grid = cpu_grid()
        raw, _best, n_rescue = make_sharded_raw_step(
            grid, TRANS, r_pad, c_pad, DEFAULT_CONFIG)(
            *shard_inputs(grid, arrays, READ_SPECS + HAP_SPECS))
        np.testing.assert_allclose(raw, np.asarray(want), rtol=2e-6, atol=0)
        np.testing.assert_array_equal(n_rescue, np.asarray(want_rescue))

    def test_striped_kernel_under_the_grid(self):
        """cfg.pallas_algo "striped" runs the striped kernel's plain
        version per block: the same grid as ppe, bit for bit."""
        r_pad, c_pad = 16, 128
        arrays = _mesh_workload(8, 2, r_pad, c_pad)
        grid = cpu_grid()
        inputs = shard_inputs(grid, arrays, READ_SPECS + HAP_SPECS)
        ppe = make_sharded_raw_step(grid, TRANS, r_pad, c_pad,
                                    DEFAULT_CONFIG)(*inputs)
        cfg = dataclasses.replace(DEFAULT_CONFIG, pallas_algo="striped",
                                  stripe_height=8)
        striped = make_sharded_raw_step(grid, TRANS, r_pad, c_pad,
                                        cfg)(*inputs)
        for a, b in zip(ppe, striped):
            np.testing.assert_array_equal(a, b)

    def test_underflow_count(self):
        """Unrelated reads underflow MIN_ACCEPTED: the count is the sum
        over both axes of the grid's raw values under it."""
        r_pad, c_pad = 64, 128
        rc, omq, q3, rl, hc, hl, iy = _mesh_workload(8, 2, r_pad, c_pad)
        rc[::2] = np.random.default_rng(3).integers(0, 4, rc[::2].shape)
        grid = cpu_grid()
        raw, best, n_rescue = make_sharded_raw_step(
            grid, TRANS, r_pad, c_pad, DEFAULT_CONFIG)(
            *shard_inputs(grid, (rc, omq, q3, rl, hc, hl, iy),
                          READ_SPECS + HAP_SPECS))
        under = int((raw < np.float32(1e-28)).sum())
        assert 0 < under < raw.size
        assert int(n_rescue[0]) == under
        np.testing.assert_array_equal(best, raw.max(axis=1))

    def test_mesh_shapes(self):
        assert cpu_grid(8, 2).devices.shape == (4, 2)
        assert cpu_grid(8, 1).devices.shape == (8, 1)
        assert cpu_grid(8, 2).shape == {"data": 4, "hap": 2}
        with pytest.raises(ValueError, match="divide"):
            cpu_grid(8, 3)
        with pytest.raises(ValueError, match="available"):
            make_mesh(9, devices=CPU8)

    def test_shard_inputs_rejects_uneven_split(self):
        grid = cpu_grid()
        with pytest.raises(ValueError, match="split"):
            shard_inputs(grid, [np.zeros((6, 4), np.int32)], ("data",))

    def test_no_card_raises(self, monkeypatch):
        """The default grid is the visible cards: without one it raises
        instead of running on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardMapPairHMMRunner(DEFAULT_CONFIG)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call_batched(SAM, FASTA, None,
                         dataclasses.replace(DEFAULT_CONFIG,
                                             pairhmm_engine="shardmap"),
                         region_filter=lambda i: i < 1)
        assert ShardMapPairHMMRunner(
            DEFAULT_CONFIG, device="cpu").mesh.shape == {"data": 1, "hap": 1}


class TestShardMapRunner:
    def test_chrm_slice_matches_reference(self, tmp_path):
        """The shardmap engine on one CPU slot over chrM regions i < 6
        writes the reference package's VCF text for the slice."""
        flt = lambda i: i < 6  # noqa: E731
        ref = tmp_path / "ref.vcf"
        jax_call_batched(
            SAM, FASTA, str(ref),
            dataclasses.replace(JAX_DEFAULT_CONFIG, pairhmm_engine="native"),
            region_filter=flt,
        )
        out = tmp_path / "port.vcf"
        cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="shardmap")
        results = call_batched(SAM, FASTA, str(out), cfg, region_filter=flt,
                               device="cpu")
        assert out.read_text() == ref.read_text()
        assert sum(len(r.variants) for r in results) > 0

    def test_grid_runner_matches_one_slot(self):
        """Jobs through a 2 x 2 grid of CPU slots (odd read and hap counts,
        padded to the grid) finalize to the one-slot runner's results and
        the cuda runner's, bit for bit."""
        rng = random.Random(5)
        jobs = [make_job(rng, n_reads, n_haps)
                for n_reads, n_haps in ((3, 2), (5, 3), (1, 1))]
        grid = ShardMapPairHMMRunner(DEFAULT_CONFIG,
                                     mesh=cpu_grid(4, 2))
        one = ShardMapPairHMMRunner(DEFAULT_CONFIG, device="cpu")
        cuda = TorchPairHMMRunner(DEFAULT_CONFIG, device="cpu")
        results = []
        for runner in (grid, one, cuda):
            copies = [PairHMMJob(j.reads, j.haps) for j in jobs]
            runner.run(copies)
            results.append([j.result for j in copies])
        for got, one_slot, batched in zip(*results):
            np.testing.assert_array_equal(got, one_slot)
            np.testing.assert_array_equal(got, batched)

    def test_engine_factory(self):
        rng = random.Random(6)
        job = make_job(rng, 2, 2)
        cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="shardmap")
        engine = make_pairhmm_engine(cfg, device="cpu")
        got = engine(job.reads, job.haps)
        TorchPairHMMRunner(DEFAULT_CONFIG, device="cpu").run([job])
        np.testing.assert_array_equal(got, job.result)
        assert engine([], job.haps).shape == (0, 2)


TINY_CFG = dataclasses.replace(
    DEFAULT_CONFIG, read_pad_buckets=(32,), hap_pad_buckets=(128,),
)


def slot_runner(devices=None, cfg=TINY_CFG):
    runner = TorchPairHMMRunner(cfg, device="cpu", pair_budget=128,
                                devices=devices)
    runner.READ_BUCKETS = (4,)
    runner.HAP_BUCKETS = (4,)
    return runner


class TestMultiDeviceRunner:
    def test_groups_span_slots_and_match_one_slot(self):
        """16 jobs, 2 per group (a read budget of 4), over 8 CPU slots:
        the 8 launch units go round-robin to all 8 slots, and every result
        is bit-equal to a one-slot runner's."""
        rng = random.Random(1234)
        jobs = [make_job(rng, 2, 2) for _ in range(16)]
        solo = [PairHMMJob(j.reads, j.haps) for j in jobs]
        runner = slot_runner(CPU8)
        runner.drain([runner.submit(jobs)])
        assert runner.placements == list(range(8))
        single = slot_runner()
        single.run(solo)
        assert single.placements == [0] * 8
        for got, want in zip(jobs, solo):
            np.testing.assert_array_equal(got.result, want.result)

    @pytest.mark.parametrize("path", ["planes", "packed"])
    def test_fused_units_span_slots(self, path):
        """With fusion forced (fuse_groups 2, fuse_auto off) each fused
        unit of 2 groups goes to the next slot; results match one slot."""
        cfg = dataclasses.replace(TINY_CFG, fuse_groups=2, fuse_auto=False,
                                  dispatch_mode=path)
        rng = random.Random(8)
        jobs = [make_job(rng, 2, 2) for _ in range(8)]
        solo = [PairHMMJob(j.reads, j.haps) for j in jobs]
        runner = slot_runner(["cpu"] * 2, cfg)
        runner.run(jobs)
        assert runner.placements == [0, 1]
        assert sum(n for label, n in runner.dispatch_counts.items()
                   if "fused2" in label) == 2
        slot_runner(None, TINY_CFG).run(solo)
        for got, want in zip(jobs, solo):
            np.testing.assert_array_equal(got.result, want.result)

    def test_chunks_stay_on_one_slot(self):
        """An oversized job's chunks are one launch unit on one slot; the
        next group goes to the next slot."""
        rng = random.Random(9)
        big = make_job(rng, 4, 64)  # 256 pairs: 2 chunks of 128
        small = make_job(rng, 2, 2)
        runner = TorchPairHMMRunner(TINY_CFG, device="cpu", pair_budget=128,
                                    devices=["cpu"] * 2)
        runner.run([big, small])
        assert runner.placements == [0, 1]
        solo = [PairHMMJob(big.reads, big.haps), PairHMMJob(small.reads,
                                                            small.haps)]
        TorchPairHMMRunner(TINY_CFG, device="cpu", pair_budget=128).run(solo)
        for got, want in zip((big, small), solo):
            np.testing.assert_array_equal(got.result, want.result)

    def test_local_devices(self, monkeypatch):
        assert local_devices("cpu") == [torch.device("cpu")]
        assert local_devices("cuda", ["cpu", "cpu"]) == [torch.device("cpu")] * 2
        with pytest.raises(ValueError):
            local_devices("cpu", [])
        with pytest.raises(ValueError):
            local_devices("cpu", ["cpu", "meta"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_devices("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_devices("cpu", ["cuda:0"])


def port_variant(contig, begin, end, alleles, gt, gq):
    return Variant(Interval(contig, begin, end), alleles=alleles, gt=gt,
                   gq=gq)


def jax_variant(contig, begin, end, alleles, gt, gq):
    return JaxVariant(JaxInterval(contig, begin, end), alleles=alleles,
                      gt=gt, gq=gq)


VARIANTS = [
    ("chrM", 10, 11, ("A", "T"), (0, 1), 99),
    ("chrM", 50, 54, ("ACGT", "A", "*"), (1, 2), 50),
    ("ctgB", 7, 8, ("G", "C"), (1, 1), 42),
    ("chrM", 90, 91, ("C", "G" * 80), (0, 1), 3),  # an allele past 64 bytes
    ("ctgB", 3, 4, tuple("ACGTNACGTN"), (2, 3), 7),  # more than 8 alleles
]


class TestMultihost:
    def test_encode_matches_reference_bytes(self):
        names = ("chrM", "ctgB")
        table, blob = multihost.encode_variants(
            [3, 1, 2, 0, 4], [port_variant(*v) for v in VARIANTS], names)
        want_t, want_b = jax_multihost.encode_variants(
            [3, 1, 2, 0, 4], [jax_variant(*v) for v in VARIANTS], names)
        assert table.dtype == want_t.dtype and blob.dtype == want_b.dtype
        assert table.tobytes() == want_t.tobytes()
        assert blob.tobytes() == want_b.tobytes()

    def test_variant_roundtrip(self):
        variants = [port_variant(*v) for v in VARIANTS[:2]]
        table, blob = multihost.encode_variants([3, 1], variants, "chrM")
        decoded = multihost.decode_variants(table, blob, "chrM")
        assert [rid for rid, _ in decoded] == [1, 3]
        roundtripped = dict(decoded)
        assert roundtripped[3].to_vcf_row() == variants[0].to_vcf_row()
        assert roundtripped[1].alleles == ("ACGT", "A", "*")
        assert roundtripped[1].gt == (1, 2)
        want = jax_multihost.decode_variants(table, blob, "chrM")
        assert [(r, v.to_vcf_row()) for r, v in decoded] == [
            (r, v.to_vcf_row()) for r, v in want]

    def test_unknown_contig_raises(self):
        with pytest.raises(KeyError, match="ctgZ"):
            multihost.encode_variants(
                [0], [port_variant("ctgZ", 1, 2, ("A", "C"), (0, 1), 9)],
                ("chrM",))

    def test_partition_regions(self):
        for n, count in ((10, 3), (68, 2), (7, 4), (3, 5)):
            parts = [list(multihost.partition_regions(n, i, count))
                     for i in range(count)]
            assert parts == [list(jax_multihost.partition_regions(n, i, count))
                             for i in range(count)]
            assert sum(parts, []) == list(range(n))

    @pytest.mark.parametrize("count", [2, 3])
    def test_shard_start_ranges_match_reference(self, count, tmp_path):
        sam, fasta, _contigs = write_two_contig_fixture(tmp_path,
                                                        random.Random(7))
        for path in (FASTA, fasta):
            contigs = read_all_fasta(path)
            n = sum(-(-len(c.seq) // DEFAULT_CONFIG.region_size)
                    for c in contigs)
            for pid in range(count):
                mine = multihost.partition_regions(n, pid, count)
                assert multihost.shard_start_ranges(
                    contigs, DEFAULT_CONFIG, mine
                ) == jax_multihost.shard_start_ranges(
                    contigs, JAX_DEFAULT_CONFIG, mine)

    def test_gather_single_process_matches_reference(self):
        variants = [port_variant(*v) for v in VARIANTS[:3]]
        merged = multihost.gather_variants([2, 0, 1], variants,
                                           ("chrM", "ctgB"))
        want = jax_multihost.gather_variants(
            [2, 0, 1], [jax_variant(*v) for v in VARIANTS[:3]],
            ("chrM", "ctgB"))
        assert [(r, v.to_vcf_row()) for r, v in merged] == [
            (r, v.to_vcf_row()) for r, v in want]
        assert multihost.process_index() == 0
        assert multihost.process_count() == 1

    def test_gather_stats_matches_reference(self):
        values = dict(regions=10, variants=3, cell_updates=12345, pairs=77)
        counters, jax_counters = RunCounters(**values), JaxCounters(**values)
        timers, jax_timers = StageTimers(), JaxTimers()
        for t in (timers, jax_timers):
            t.add("assemble", 1.5)
            t.add("pairhmm", 2.25)
            t.add("pairhmm", 0.125)
        merged = multihost.gather_stats(counters, timers)
        assert merged["processes"] == 1
        assert merged["counters"]["cell_updates"] == 12345
        assert merged["timers_max"]["assemble"] == 1.5
        want = jax_multihost.gather_stats(jax_counters, jax_timers)
        # the port's RunCounters has the same fields as the reference's
        assert merged == want

    def test_distributed_init_single_process(self):
        assert multihost.distributed_init() == (0, 1)
        assert multihost.distributed_init(None, 1, None) == (0, 1)

    @pytest.mark.parametrize("coordinator,pid", [(None, 0), ("127.0.0.1:1", None),
                                                 ("127.0.0.1:1", 2)])
    def test_distributed_init_rejects_bad_arguments(self, coordinator, pid):
        with pytest.raises(ValueError):
            multihost.distributed_init(coordinator, 2, pid)

    def test_failed_join_raises(self):
        """Process 1 of 2 with nobody listening at the coordinator: the
        join raises after its timeout instead of going on alone."""
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with pytest.raises(Exception):
            multihost.distributed_init(f"127.0.0.1:{port}", 2, 1,
                                       timeout_s=3)
        assert multihost.process_count() == 1


class TestMultihostManifest:
    def test_per_process_manifest_resume(self, tmp_path):
        """run_multihost with a manifest path checkpoints per process and
        resumes to identical output (single-process; region ids are the
        global index the shards use)."""
        cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")
        out1 = str(tmp_path / "a.vcf")
        mpath = str(tmp_path / "m.jsonl")
        multihost.run_multihost(SAM, FASTA, out1, cfg, manifest_path=mpath)
        assert os.path.getsize(mpath + ".p0") > 0
        out2 = str(tmp_path / "b.vcf")
        multihost.run_multihost(SAM, FASTA, out2, cfg, manifest_path=mpath)
        assert open(out1).read() == open(out2).read() == open(GOLDEN).read()

    def test_region_filter_narrows_the_block(self, tmp_path):
        """-L's region filter applies inside a process's block: the VCF is
        the single-process call of the same regions."""
        cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")
        flt = lambda i: 10 <= i < 30  # noqa: E731
        out = tmp_path / "mh.vcf"
        results, merged = multihost.run_multihost(
            SAM, FASTA, str(out), cfg, region_filter=flt)
        assert len(results) == 20
        want = tmp_path / "single.vcf"
        call_batched(SAM, FASTA, str(want), cfg, region_filter=flt)
        assert out.read_text() == want.read_text()
        assert merged and all(10 <= rid < 30 for rid, _ in merged)


class TestShardRanges:
    def test_two_way_sharded_run_matches_golden(self):
        """Both shards' calls, each parsing only its start ranges, give
        the golden rows in order."""
        golden = [line for line in open(GOLDEN) if not line.startswith("#")]
        contigs = read_all_fasta(FASTA)
        n = sum(-(-len(c.seq) // DEFAULT_CONFIG.region_size) for c in contigs)
        cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")
        merged = []
        for pid in (0, 1):
            mine = multihost.partition_regions(n, pid, 2)
            chosen = set(mine)
            res = call_batched(
                SAM, FASTA, None, cfg, region_filter=lambda i: i in chosen,
                start_ranges=multihost.shard_start_ranges(contigs, cfg, mine),
            )
            merged.extend(v.to_vcf_row() for r in res for v in r.variants)
        assert merged == golden


class TestCli:
    def test_shardmap_cpu_slice_matches_native(self, tmp_path):
        """--pairhmm shardmap --device cpu on a -L slice writes the native
        engine's VCF, and --stats names the engine."""
        import contextlib
        import io
        import json

        from gatk_hc_tpu_torch import cli

        base = ["-I", SAM, "-R", FASTA, "-L", "chrM:490-1000"]
        out = tmp_path / "shardmap.vcf"
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            assert cli.main(base + ["-O", str(out), "--pairhmm", "shardmap",
                                    "--device", "cpu", "--stats"]) == 0
            want = tmp_path / "native.vcf"
            assert cli.main(base + ["-O", str(want), "--pairhmm",
                                    "native"]) == 0
        stats = json.loads(stdout.getvalue().splitlines()[0])
        assert stats["engine"] == "shardmap"
        assert stats["variants"] > 0
        assert out.read_text() == want.read_text()

    def test_shardmap_without_card_raises(self, tmp_path, monkeypatch):
        from gatk_hc_tpu_torch import cli

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-I", SAM, "-R", FASTA, "-O", str(tmp_path / "o.vcf"),
                      "--pairhmm", "shardmap", "-L", "chrM:0-500"])

    @pytest.mark.parametrize("extra", [
        ["--process-id", "0"],  # no coordinator
        ["--coordinator", "127.0.0.1:1"],  # no process id
        ["--coordinator", "127.0.0.1:1", "--process-id", "2"],
    ])
    def test_multi_process_arguments_checked(self, tmp_path, extra):
        """--num-processes 2 with a missing or out-of-range argument
        raises before any work: it never runs as one process."""
        from gatk_hc_tpu_torch import cli

        out = tmp_path / "o.vcf"
        with pytest.raises(ValueError):
            cli.main(["-I", SAM, "-R", FASTA, "-O", str(out), "--pairhmm",
                      "native", "--num-processes", "2"] + extra)
        assert not out.exists()
