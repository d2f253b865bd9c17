"""The port runner's dispatch worker, wedge check and BackgroundRunner on
the CPU: the cases of tests/test_runner.py::TestWedgeFailover, where the
port raises DeviceWedgedError instead of recomputing on the C++ engine,
plus what the port adds (submit returns before packing, a worker error
raises at drain as itself, the CLI's dispatch flags and --stats)."""

import contextlib
import dataclasses
import io
import json
import os
import random
import threading
import time

import numpy as np
import pytest

from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG, HCConfig
from gatk_hc_tpu_torch.ops import runner as runner_mod
from gatk_hc_tpu_torch.ops.runner import DeviceWedgedError, TorchPairHMMRunner
from tests.test_torch_runner import (  # noqa: F401 - autouse fixture
    TINY_CFG, make_job, one_torch_thread, reference_results,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")


def jobs_and_expected(n=4, seed=11):
    rng = random.Random(seed)
    jobs = [make_job(rng, 3, 2) for _ in range(n)]
    return jobs, reference_results(jobs)


def assert_results(jobs, expected):
    for job, want in zip(jobs, expected):
        np.testing.assert_array_equal(job.result, want)


@pytest.fixture
def release():
    """An event that blocked worker bodies wait on; set at teardown so no
    test leaves a thread behind."""
    event = threading.Event()
    yield event
    event.set()


def wedged_runner(release, timeout=0.3):
    cfg = dataclasses.replace(TINY_CFG, device_timeout_s=timeout)
    runner = TorchPairHMMRunner(cfg, device="cpu", pair_budget=256)
    runner._submit_batch = lambda jobs: release.wait(60)  # wedge
    # a true wedge: the health probe cannot finish either
    runner._probe_device_alive = lambda timeout_s=30.0: False
    return runner


class TestWedge:
    def test_dispatch_wedge_raises(self, release):
        jobs, _ = jobs_and_expected()
        runner = wedged_runner(release)
        with pytest.raises(DeviceWedgedError, match="device dispatch "
                           "unresponsive"):
            runner.drain([runner.submit(jobs)])
        assert runner._wedged == "dispatch"
        assert runner._submit_pool.abandoned  # exit does not wait for it
        # nothing was recomputed elsewhere
        assert all(job.result is None for job in jobs)
        # a wedged card takes no more work, and drains nothing more
        jobs2, _ = jobs_and_expected(seed=12)
        with pytest.raises(DeviceWedgedError):
            runner.submit(jobs2)
        with pytest.raises(DeviceWedgedError):
            runner.drain([])
        assert all(job.result is None for job in jobs2)

    def test_fetch_wedge_raises(self, release):
        jobs, _ = jobs_and_expected()
        runner = wedged_runner(release)
        del runner._submit_batch  # the class body: dispatch succeeds...
        runner._sync_d2h = lambda batches: release.wait(60)  # ...the copy not
        with pytest.raises(DeviceWedgedError, match="device fetch"):
            runner.drain([runner.submit(jobs)])
        assert runner._wedged == "fetch" and runner._fetch_pool.abandoned
        assert all(job.result is None for job in jobs)

    def test_timeout_zero_disables_wedge_check(self):
        cfg = dataclasses.replace(TINY_CFG, device_timeout_s=0.0)
        runner = TorchPairHMMRunner(cfg, device="cpu", pair_budget=256)
        runner._probe_device_alive = lambda timeout_s=30.0: False
        jobs, expected = jobs_and_expected()
        runner.drain([runner.submit(jobs)])  # no side thread, no probe
        assert not runner._wedged and runner._fetch_pool is None
        assert_results(jobs, expected)

    def test_alive_but_slow_gets_bounded_extensions(self, release):
        """A timed-out batch with a LIVE probe is throttled, not wedged:
        drain grants MAX_SLOW_EXTENSIONS more budgets, then raises."""
        jobs, _ = jobs_and_expected()
        runner = wedged_runner(release, timeout=0.2)
        probes = []
        runner._probe_device_alive = lambda timeout_s=30.0: (
            probes.append(1) or True
        )
        runner.MAX_SLOW_EXTENSIONS = 2
        with pytest.raises(DeviceWedgedError):
            runner.drain([runner.submit(jobs)])
        # probe consulted once per expired budget; still raises at the cap
        assert len(probes) == 3 and runner._wedged

    def test_slow_batch_within_extensions_finishes(self, release):
        """A batch that outlasts one budget on a live card is waited for
        and finalized normally."""
        cfg = dataclasses.replace(TINY_CFG, device_timeout_s=0.2)
        runner = TorchPairHMMRunner(cfg, device="cpu", pair_budget=256)
        body = runner._submit_batch

        def slow(jobs):
            time.sleep(0.3)
            return body(jobs)

        runner._submit_batch = slow
        runner._probe_device_alive = lambda timeout_s=30.0: True
        jobs, expected = jobs_and_expected()
        runner.drain([runner.submit(jobs)])
        assert not runner._wedged
        assert_results(jobs, expected)

    def test_background_runner_build_timeout_raises(self, release,
                                                    monkeypatch):
        class HangingRunner:
            def __init__(self, cfg, *a, **k):
                release.wait(60)

        monkeypatch.setattr(runner_mod, "TorchPairHMMRunner", HangingRunner)
        cfg = dataclasses.replace(TINY_CFG, device_timeout_s=0.3)
        bg = runner_mod.BackgroundRunner(cfg, device="cpu")
        jobs, _ = jobs_and_expected()
        with pytest.raises(DeviceWedgedError,
                           match="device backend init unresponsive"):
            bg.submit(jobs)
        assert bg._build_abandoned
        # every later use raises at once, without another wait
        t0 = time.perf_counter()
        with pytest.raises(DeviceWedgedError):
            bg.drain([])
        assert time.perf_counter() - t0 < 0.2
        assert all(job.result is None for job in jobs)

    @pytest.mark.parametrize("exc", [RuntimeError("pack failed"),
                                     TimeoutError("raised by the pack")])
    def test_worker_error_raises_at_drain_as_itself(self, exc):
        """An exception on the worker (even a TimeoutError) is re-raised at
        drain as itself, not as a wedge, and the runner stays usable."""
        cfg = dataclasses.replace(TINY_CFG, device_timeout_s=0.3)
        runner = TorchPairHMMRunner(cfg, device="cpu", pair_budget=256)
        pack = runner._unique_rows

        def failing_pack(*args):
            raise exc

        runner._unique_rows = failing_pack
        jobs, _ = jobs_and_expected()
        handle = runner.submit(jobs)
        with pytest.raises(type(exc), match=str(exc)) as info:
            runner.drain([handle])
        assert not isinstance(info.value, DeviceWedgedError)
        assert not runner._wedged
        assert all(job.result is None for job in jobs)
        runner._unique_rows = pack
        jobs2, expected2 = jobs_and_expected(seed=12)
        runner.drain([runner.submit(jobs2)])
        assert_results(jobs2, expected2)


def test_submit_returns_while_pack_is_blocked(release):
    """submit() hands the batch to the dispatch worker: it returns while
    the (monkeypatched) pack is still blocked, and drain collects."""
    runner = TorchPairHMMRunner(TINY_CFG, device="cpu", pair_budget=256)
    entered = threading.Event()
    pack = runner._unique_rows

    def blocked_pack(*args):
        entered.set()
        release.wait(60)
        return pack(*args)

    runner._unique_rows = blocked_pack
    jobs, expected = jobs_and_expected()
    t0 = time.perf_counter()
    handle = runner.submit(jobs)
    assert time.perf_counter() - t0 < 1.0
    assert entered.wait(10)  # the worker is inside the pack...
    assert all(job.result is None for job in jobs)  # ...and nothing is done
    assert runner.stage_ms["submit"] and runner.stage_ms["submit"][0] < 1e3
    release.set()
    runner.drain([handle])
    assert_results(jobs, expected)


def test_worker_runs_submits_in_order():
    """Several submits in flight on the one FIFO worker, drained out of
    order: every batch finalizes its own jobs."""
    runner = TorchPairHMMRunner(TINY_CFG, device="cpu", pair_budget=64)
    batches = [jobs_and_expected(n=3, seed=s) for s in range(4)]
    handles = [runner.submit(jobs) for jobs, _ in batches]
    runner.drain(handles[::-1])
    for jobs, expected in batches:
        assert_results(jobs, expected)
    assert runner.stage_medians()["groups"] >= 4


def test_background_runner_build_error_raises_at_first_use(monkeypatch):
    class BrokenRunner:
        def __init__(self, cfg, *a, **k):
            raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runner_mod, "TorchPairHMMRunner", BrokenRunner)
    bg = runner_mod.BackgroundRunner(TINY_CFG, device="cpu")
    with pytest.raises(RuntimeError, match="nvcc failed") as info:
        bg.submit([])
    assert not isinstance(info.value, DeviceWedgedError)


def test_background_runner_on_cpu():
    bg = runner_mod.BackgroundRunner(TINY_CFG, device="cpu")
    jobs, expected = jobs_and_expected()
    bg.drain([bg.submit(jobs)])
    assert_results(jobs, expected)
    inner = bg.runner
    assert isinstance(inner, TorchPairHMMRunner)
    assert "runner_ctor_s" in inner.init_profile
    bg.stop_prewarm()
    assert inner._prewarm_stop.is_set()


@pytest.mark.parametrize("field,value", [
    ("dispatch_mode", "striped"), ("fuse_groups", 5), ("packed_nib", 1),
    ("fuse_auto", "yes"), ("device_timeout_s", -1.0),
])
def test_config_rejects_bad_dispatch_values(field, value):
    with pytest.raises(ValueError, match=field):
        HCConfig(**{field: value})


def test_cli_dispatch_flags_and_stats(tmp_path, monkeypatch):
    """The dispatch flags reach the config; a cuda run on the CPU goes
    through BackgroundRunner, writes the native engine's VCF and reports
    init_profile, dispatch_profile and the stage times (including the
    caller's time in submit)."""
    seen = {}
    real = runner_mod.BackgroundRunner

    def spy(cfg, device="cuda"):
        seen["cfg"], seen["device"] = cfg, device
        return real(cfg, device=device)

    monkeypatch.setattr(runner_mod, "BackgroundRunner", spy)
    base = ["-I", os.path.join(FIXTURES, "chrM.sam"),
            "-R", os.path.join(FIXTURES, "chrM.fa"), "-L", "chrM:0-700"]
    outs = {}
    for name, flags in (
        ("native", ["--pairhmm", "native"]),
        ("cuda", ["--device", "cpu", "--dispatch-mode", "packed",
                  "--no-packed-nib", "--fuse-groups", "2", "--no-fuse-auto",
                  "--device-timeout", "600", "--stats"]),
    ):
        out = tmp_path / f"{name}.vcf"
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            assert cli.main(base + ["-O", str(out)] + flags) == 0
        outs[name] = (out.read_text(), stdout.getvalue())
    assert outs["cuda"][0] == outs["native"][0]
    cfg = seen["cfg"]
    assert seen["device"] == "cpu"
    assert (cfg.dispatch_mode, cfg.packed_nib, cfg.fuse_groups,
            cfg.fuse_auto, cfg.device_timeout_s) == ("packed", False, 2,
                                                     False, 600.0)
    stats = json.loads(outs["cuda"][1].splitlines()[0])
    assert "runner_ctor_s" in stats["init_profile"]
    assert set(stats["dispatch_profile"]) <= {"packed", "packedfused2"}
    assert {"submit", "pack", "kernel"} <= set(stats["device_stages_ms"])
    assert "gather" not in stats["device_stages_ms"]
    defaults = cli.build_parser().parse_args(["-I", "a", "-O", "b", "-R", "c"])
    assert (defaults.dispatch_mode, defaults.fuse_groups,
            defaults.device_timeout) == (
        DEFAULT_CONFIG.dispatch_mode, DEFAULT_CONFIG.fuse_groups,
        DEFAULT_CONFIG.device_timeout_s)
    assert not defaults.no_packed_nib and not defaults.no_fuse_auto
