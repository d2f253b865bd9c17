"""The port's PairHMM benchmarks (gatk_hc_tpu_torch/tools/bench.py,
kernel_bench.py) against the reference's (bench.py, tools/kernel_bench.py)
on the CPU: the same workload bytes and kernel inputs, every arm of every
round bit-equal to the reference's C++ engine on the same jobs, the CPU
divisor's scalar child, and every tool refusing to run without a card
unless asked for the CPU."""

import importlib.util
import json
import os

import numpy as np
import pytest

import bench as ref_bench
from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.ops.runner import NativePairHMMRunner as JaxNativeRunner
from gatk_hc_tpu.ops.runner import PairHMMJob as JaxJob
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.io.columnar import ReadPairs
from gatk_hc_tpu_torch.tools import (
    bench, genotyper_bench, kernel_bench, scaling_bench, sustained_sweep,
)
from tests.test_bench import _tiny_workload
from tests.test_torch_runner import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_tool(name):
    """A module of the reference's tools/ directory (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_workload():
    """tests/test_bench.py's tiny workload: (the port's ReadPairs, the
    reference's, the haps)."""
    ref_reads, haps = _tiny_workload()
    port = ReadPairs(ref_reads.flat_seq, ref_reads.flat_qual, ref_reads.off)
    return port, ref_reads, haps


def reference_result(ref_reads, haps):
    job = JaxJob(ref_reads, haps)
    JaxNativeRunner(JAX_DEFAULT_CONFIG).run([job])
    return job.result


def test_make_workload_is_the_references():
    reads, haps = bench.make_workload()
    want_reads, want_haps = ref_bench.make_workload()
    for name in ("flat_seq", "flat_qual", "off"):
        got, want = getattr(reads, name), getattr(want_reads, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert len(haps) == len(want_haps) == bench.N_HAPS
    for got, want in zip(haps, want_haps):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (bench.N_READS, bench.N_HAPS, bench.READ_LEN, bench.HAP_LEN) == (
        ref_bench.N_READS, ref_bench.N_HAPS, ref_bench.READ_LEN,
        ref_bench.HAP_LEN)


def test_arms_are_the_references_plus_nib():
    assert bench.ARM_NAMES == ref_bench.ARM_NAMES + ("packednib",)
    ref = {name: (k, enc, jps) for name, k, enc, jps in ref_bench.ARM_SPECS}
    for name, k, enc, jps, _nib in bench.ARM_SPECS[:-1]:
        assert ref[name] == (k, enc, jps)
    cfgs = {name: cfg for name, cfg, _enc, _jps
            in bench.arm_configs(DEFAULT_CONFIG)}
    assert cfgs["packed"].packed_nib is False
    assert cfgs["packedfused4"].packed_nib is False
    assert cfgs["packednib"].packed_nib is True
    for name, k, *_ in bench.ARM_SPECS:
        if k:
            assert cfgs[name].fuse_groups == k
            assert cfgs[name].fuse_auto is False


def test_bench_device_every_arm_every_round_equals_reference():
    """Two rounds over every arm (forward, then backward) on the CPU: each
    arm's results bit-equal to the reference's C++ engine on the same job,
    each arm's encoding in its launches."""
    reads, ref_reads, haps = tiny_workload()
    dev = bench.bench_device(reads, haps, n_jobs=2, rounds=2, device="cpu")
    assert set(dev["seconds"]) == set(bench.ARM_NAMES)
    assert all(len(s) == 2 and min(s) > 0 for s in dev["seconds"].values())
    want = reference_result(ref_reads, haps)
    assert len(dev["results"]) == 2
    for got in dev["results"]:
        np.testing.assert_array_equal(got, want)
    assert set(dev["dispatch"]["unfused"]) == {"planes"}
    assert set(dev["dispatch"]["packed"]) == {"packed"}
    assert set(dev["dispatch"]["packednib"]) == {"packednib"}
    assert dev["cells_per_round"] == 2 * 8 * 2 * 16 * 24


def test_bench_device_raises_when_an_arm_differs(monkeypatch):
    """An arm whose results change fails the run (no silent number)."""
    reads, _ref_reads, haps = tiny_workload()
    real = bench.run_stream
    calls = {"n": 0}

    def stream(runner, jobs, *a, **k):
        dt = real(runner, jobs, *a, **k)
        calls["n"] += 1
        if calls["n"] == 3:
            jobs[0].result = jobs[0].result + 1.0
        return dt

    monkeypatch.setattr(bench, "run_stream", stream)
    with pytest.raises(AssertionError, match="results differ"):
        bench.bench_device(reads, haps, n_jobs=2, rounds=1, device="cpu")


def test_bench_main_on_cpu(capsys):
    rc = bench.main(["--device", "cpu", "--n-reads", "8", "--n-haps", "2",
                     "--read-len", "16", "--hap-len", "24", "--n-jobs", "2",
                     "--rounds", "2", "--skip-e2e", "--kernel-pairs", "4"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # a CPU run is never reported under the card's metric
    assert row["metric"] == "pairhmm_cell_updates_per_s_cpu_plain_versions"
    assert row["device"] == "cpu" and row["nvidia_smi"] is None
    assert set(row["arms"]) == set(bench.ARM_NAMES)
    for arm in row["arms"].values():
        assert len(arm["all_s"]) == 2
        assert (arm["best_cells_per_s"] >= arm["median_cells_per_s"] > 0)
        assert arm["dispatch_profile"]
    assert row["value"] == max(a["median_cells_per_s"]
                               for a in row["arms"].values())
    assert row["best_arm"] in bench.ARM_NAMES
    assert row["results_bitwise_equal_across_arms"] is True
    assert row["kernel_only"]["instance"] == f"ppe{DEFAULT_CONFIG.ppe_rows}"
    assert row["current_cpu_engine_cells_per_s"] > 0
    assert row["scalar_cpu_cells_per_s"] > 0
    assert row["vs_scalar_cpu"] == row["value"] / row["scalar_cpu_cells_per_s"]
    assert row["e2e_chrM_wall_s"] is None and row["rounds"] == 2
    # no TPU constant is carried over
    assert "reference_equivalent_scalar_cells_per_s" not in row
    assert "vs_baseline" not in row and "kernel_floor_ok" not in row


def test_scalar_cpu_baseline_child_sets_the_switch():
    """The scalar divisor runs in a child process that really has
    HC_PAIRHMM_SCALAR=1 (the C++ library reads it once per process)."""
    assert os.environ.get("HC_PAIRHMM_SCALAR") in (None, "", "0")
    child = bench.scalar_cpu_baseline((8, 2, 16, 24))
    assert child["HC_PAIRHMM_SCALAR"] == "1"
    assert child["cells_per_s"] > 0


def test_cpu_baseline_counts_cells():
    reads, _ref, haps = tiny_workload()
    assert bench.bench_cpu_baseline(reads, haps) > 0


def test_kernel_bench_inputs_are_the_references(monkeypatch):
    """make_inputs gives the arrays the reference's measure_kernel hands
    its kernel (tools/kernel_bench.py:40-50), captured at a tiny size."""
    import jax
    import jax.numpy as jnp

    import gatk_hc_tpu.ops.pairhmm_pallas as pallas

    seen = []

    def capture(*args, **kwargs):
        seen.append([np.asarray(a) for a in args[:7]])
        return jnp.zeros(args[0].shape[0], jnp.float32)

    monkeypatch.setattr(jax, "jit", lambda fn: fn)
    monkeypatch.setattr(pallas, "_pallas_forward", capture)
    reference_tool("kernel_bench").measure_kernel(
        pairs=8, r_pad=16, rlen=12, c_pad=32, clen=20, iters=1)
    got = kernel_bench.make_inputs(8, 16, 12, 32, 20)
    assert seen
    for want, mine in zip(seen[0], got):
        assert want.dtype == mine.dtype and want.shape == mine.shape
        assert want.tobytes() == mine.tobytes()


def test_kernel_bench_on_cpu_every_instance_equal(capsys):
    """Seven instances on the reference's inputs (short enough that they do
    not underflow), bit-equal to each other and to the reference's FTZ
    oracle (q = 1e-4 is Phred 40; codes A0 C1 T2 G3)."""
    from gatk_hc_tpu.ops.pairhmm_oracle import pairhmm_prob

    rc = kernel_bench.main(["--device", "cpu", "--pairs", "6", "--rpad",
                            "32", "--rlen", "6", "--cpad", "32", "--clen",
                            "9", "--iters", "1"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["instance"] for r in row["instances"]] == [
        "ppe1", "ppe2", "ppe4", "ppe8", "striped8", "striped16", "striped32"]
    assert row["results_bitwise_equal_across_instances"] is True
    for r in row["instances"]:
        assert r["bound_by"] in ("bytes", "operations")
        assert r["bound_ms"] > 0 and r["pct_of_bound"] > 0
    out = kernel_bench.measure_kernel(6, 32, 6, 32, 9, "ppe", 4, 1,
                                      "cpu")["out"]
    codes, _omq, _q3, _rl, hap, _hl, _iy = kernel_bench.make_inputs(
        6, 32, 6, 32, 9)
    bases = np.frombuffer(b"ACTG", np.uint8)
    want = np.array([
        np.float32(pairhmm_prob(bases[codes[b, :6]], np.full(6, 40, np.uint8),
                                bases[hap[b, :9]], ftz=True))
        for b in range(6)], np.float32)
    assert (out > 0).all()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("tool", [bench, kernel_bench, sustained_sweep,
                                  genotyper_bench, scaling_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_refuse_without_a_card(tool, capsys):
    """No card and no --device cpu: exit non-zero and say why; never a
    CPU run in the card's place."""
    rc = tool.main([])
    err = capsys.readouterr()
    assert rc != 0
    assert "no CUDA device" in err.err and not err.out.strip()


def test_timing_is_chip_smokes():
    """chip_smoke.py times and bounds with the tools' one copy."""
    import chip_smoke
    from gatk_hc_tpu_torch.tools import _timing

    for name in ("time_ms", "time_ms_queued", "ppe_bound", "nvidia_smi",
                 "PEAK_F32_FLOPS", "PEAK_F64_FLOPS", "PEAK_HBM_BYTES"):
        assert getattr(chip_smoke, name) is getattr(_timing, name), name
    ms, by = _timing.ppe_bound([151] * 4, [415] * 4, 448)
    assert by == "operations"
    assert ms == pytest.approx(
        1e3 * (12 * 4 * 151 * 415 + 2 * 4 * 415 + 4) / 67e12)
