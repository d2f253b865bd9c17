"""The port's sweep, genotyper and scaling benchmarks
(gatk_hc_tpu_torch/tools/{sustained_sweep,genotyper_bench,
scaling_bench}.py) against the reference's tools/ on the CPU: the same
arms, summaries and bucket bytes, every sweep arm bit-equal to the
reference's C++ engine, serial and pipelined genotyping bit-equal and, in
float64, equal to the reference's genotype_sites_host, and the scaling
sections on CPU slots ("not measured" past the visible cards)."""

import json

import numpy as np
import pytest

from gatk_hc_tpu.ops.genotyper_jax import genotype_sites_host
from gatk_hc_tpu_torch.tools import genotyper_bench, scaling_bench
from gatk_hc_tpu_torch.tools import sustained_sweep as sweep
from tests.test_torch_bench import reference_result, reference_tool, tiny_workload
from tests.test_torch_runner import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ref_sweep():
    return reference_tool("sustained_sweep")


@pytest.fixture(scope="module")
def ref_genotyper():
    return reference_tool("genotyper_bench")


def test_arms_are_the_references(ref_sweep):
    assert sweep.ARMS == ref_sweep.ARMS


@pytest.mark.parametrize("results", [
    {"a": [0.21, 0.20, 0.19], "b": [0.26, 0.25, 0.24]},
    {"a": [0.21, 0.20, 2.0], "b": [0.26, 0.25, 0.24]},
    {"x": [1.5, 0.7], "y": [0.9, 0.9], "z": [3.0, 0.2]},
    {"only": [0.5, 0.25, 0.75]},
])
def test_summarize_is_the_references(ref_sweep, results):
    for cells in (1e9, 16 * 1024 * 16 * 151 * 415):
        assert sweep.summarize(results, cells) == ref_sweep.summarize(
            results, cells)


def test_sweep_every_arm_equals_reference():
    """One round of every arm on the CPU: bit-equal to the reference's C++
    engine on the same job; the budget and read-bucket keys reach the
    runner."""
    reads, ref_reads, haps = tiny_workload()
    rows = []
    results, baseline, cells = sweep.sweep(sweep.ARMS, reads, haps, n_jobs=4,
                                           rounds=1, device="cpu",
                                           emit=rows.append)
    assert [r["arm"] for r in rows] == [a["name"] for a in sweep.ARMS]
    assert all(len(v) == 1 and v[0] > 0 for v in results.values())
    assert cells == 4 * 8 * 2 * 16 * 24
    want = reference_result(ref_reads, haps)
    for got in baseline:
        np.testing.assert_array_equal(got, want)
    arm = next(a for a in sweep.ARMS if a["name"] == "b48-packed-c48")
    runner = sweep.make_runner(arm, "cpu")
    assert runner.pair_budget == 49152
    assert runner.READ_BUCKETS == (1024, 3072, 4096)
    assert runner.cfg.dispatch_mode == "packed" and not runner.cfg.fuse_auto
    assert runner.cfg.device_timeout_s == 0.0
    raw = sweep.make_runner(
        next(a for a in sweep.ARMS if a["name"] == "b16-packed-raw"), "cpu")
    assert raw.cfg.packed_nib is False and raw.cfg.fuse_groups == 1


def test_sweep_main_on_cpu(capsys):
    rc = sweep.main(["--device", "cpu", "--n-reads", "8", "--n-haps", "2",
                     "--read-len", "16", "--hap-len", "24", "--n-jobs", "4",
                     "--rounds", "2", "--arms",
                     "b16-planes,b32-planes-c32,b16-packed-d6-jps2"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["round"], r["arm"]) for r in lines[:-1]] == [
        (rnd, arm) for rnd in range(2)
        for arm in ("b16-planes", "b32-planes-c32", "b16-packed-d6-jps2")]
    summary = lines[-1]
    assert summary["results_bitwise_equal_across_arms"] is True
    assert summary["device"] == "cpu" and summary["nvidia_smi"] is None
    assert summary["b32-planes-c32"]["chunks"] == sweep.CHUNKS_NOTE
    assert "chunks" not in summary["b16-planes"]
    assert len(summary["b16-planes"]["all_s"]) == 2
    assert summary["winner"]["arm"] in ("b16-planes", "b32-planes-c32",
                                        "b16-packed-d6-jps2")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_make_buckets_are_the_references(ref_genotyper, dtype):
    got = genotyper_bench.make_buckets(7, 5, dtype)
    want = ref_genotyper.make_buckets(7, 5, dtype)
    assert genotyper_bench.SHAPES == ref_genotyper.SHAPES
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_serial_equals_pipelined_and_reference_f64():
    """Both dispatch patterns bit-equal; float64 best and GQ equal to the
    reference's genotype_sites_host (JAX on the CPU) and the host
    genotyper at every site."""
    buckets = genotyper_bench.make_buckets(3, 4, np.float64)
    serial = genotyper_bench.run_serial(buckets, "cpu")
    assert genotyper_bench.same_outputs(
        serial, genotyper_bench.run_pipelined(buckets, "cpu"))
    host = genotyper_bench.host_genotypes(buckets)
    for (best, gq, gl), (hb, hg), b in zip(serial, host, buckets):
        assert gl is None
        _gl, want_best, want_gq = genotype_sites_host(*b)
        np.testing.assert_array_equal(best, np.asarray(want_best))
        np.testing.assert_array_equal(gq, np.asarray(want_gq))
        np.testing.assert_array_equal(best, hb)
        np.testing.assert_array_equal(gq, hg)


def test_serial_equals_pipelined_f32():
    buckets = genotyper_bench.make_buckets(3, 4, np.float32)
    serial = genotyper_bench.run_serial(buckets, "cpu")
    pipelined = genotyper_bench.run_pipelined(buckets, "cpu")
    assert all(gl is not None and gl.dtype == np.float32
               for _b, _g, gl in serial)
    assert genotyper_bench.same_outputs(serial, pipelined)
    changed = [(b, g, gl + 1) for b, g, gl in pipelined]
    assert not genotyper_bench.same_outputs(serial, changed)


@pytest.mark.parametrize("f32", [False, True])
def test_genotyper_main_on_cpu(capsys, f32):
    rc = genotyper_bench.main(["--device", "cpu", "--rounds", "2",
                               "--buckets", "3", "--sites", "4"]
                              + (["--f32"] if f32 else []))
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["dtype"] == ("float32" if f32 else "float64")
    assert row["bitwise_equal"] is True
    assert row["equal_to_host"] is (None if f32 else True)
    assert row["serial_fetches"] == 3 * (3 if f32 else 2)
    assert row["pipelined_fetches"] == (2 if f32 else 1)
    assert len(row["all_ms"]["serial"]) == len(row["all_ms"]["pipelined"]) == 2
    assert row["serial_ms"] > 0 and row["pipelined_ms"] > 0


def test_scaling_sections_on_cpu_slots():
    runner = scaling_bench.bench_runner_weak_scaling((1, 2), "cpu")
    step = scaling_bench.bench_sharded_step_weak_scaling((1, 2), "cpu")
    for section, per_device in ((runner, "jobs_per_device"),
                                (step, "reads_per_device")):
        assert per_device in section
        assert set(section["seconds"]) == {"1", "2"}
        assert all(s > 0 for s in section["seconds"].values())
        assert section["efficiency"]["1"] == 1.0
        assert section["efficiency"]["2"] > 0


def test_scaling_past_the_visible_cards_is_not_measured():
    """Counts past the visible cards (none here) are never run on another
    device in their place."""
    for bench_fn in (scaling_bench.bench_runner_weak_scaling,
                     scaling_bench.bench_sharded_step_weak_scaling):
        section = bench_fn((1, 2), "cuda")
        assert section["seconds"] == {
            str(n): "not measured: 0 card(s) visible" for n in (1, 2)}
        assert "efficiency" not in section


def test_runner_jobs_are_the_references():
    ref = reference_tool("scaling_bench")
    for got, want in zip(scaling_bench._runner_jobs(3),
                         ref._runner_jobs(3)):
        assert [h.tobytes() for h in got.haps] == [
            h.tobytes() for h in want.haps]
        assert [(b.tobytes(), q.tobytes()) for b, q in got.reads] == [
            (b.tobytes(), q.tobytes()) for b, q in want.reads]


def test_scaling_main_on_cpu_two_processes(capsys):
    """The whole tool on one CPU slot with the two-process chrM run
    (gloo over loopback)."""
    rc = scaling_bench.main(["--device", "cpu", "--counts", "1"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["device"] == "cpu" and row["nvidia_smi"] is None
    assert row["runner_weak_scaling"]["efficiency"] == {"1": 1.0}
    dcn = row["dcn_2proc"]
    assert dcn["t_1proc_s"] > 0 and dcn["t_2proc_s"] > 0
    assert dcn["efficiency"] == dcn["t_1proc_s"] / (2 * dcn["t_2proc_s"])
    assert len(dcn["parse_2proc_s"]) == 2
