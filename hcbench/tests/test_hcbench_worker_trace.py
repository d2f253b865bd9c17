"""The worker's idle attribution (``worker_trace.py``) and the readers of
the runner's pack parts, on hand-made input, and the port's own spans
reduced from a profile of every thread on the CPU."""

import os

import pytest
import torch

from hcbench import gen, run, trace, worker_trace
from hcbench.drivers import runner_stream

READERS = ("runner.unique_rows_ms_per_gcell", "runner.encode_ms_per_gcell",
           "runner.launch_ms_per_gcell", "runner.pack_offcpu_pct",
           "device.idle_in_pack_pct")


def read(name, rec):
    return run.load_module("metrics", name).read(rec)


def x(cat, name, ts, dur, tid=2):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def span(name, ts, dur, tid=2):
    return x("user_annotation", name, ts, dur, tid)


def events():
    """A 1 s window from 1.0 s.  The worker (thread 2): a submit from
    0.9 s, across the window's start, whose group packs until 1.3 s
    (unique rows, then the encoding: its own time, then nib) and launches
    until 1.32 s; nothing from 1.6 s; a second submit packing from 1.7 to
    1.9 s.  The card: busy 1.15-1.2 s and 1.32-1.4 s.  The caller
    (thread 1) waits through the whole window."""
    return [
        span("hcbench.window", 1_000_000, 1_000_000, tid=1),
        span("hc.runner.wait", 1_000_000, 1_000_000, tid=1),
        span("hc.runner.batch", 900_000, 700_000),
        span("hc.runner.pack", 900_000, 400_000),
        span("hc.runner.pack.unique_rows", 950_000, 150_000),
        span("hc.runner.pack.encode", 1_100_000, 180_000),
        span("hc.runner.pack.encode.nib", 1_200_000, 80_000),
        span("hc.runner.launch", 1_300_000, 20_000),
        span("hc.runner.batch", 1_700_000, 200_000),
        span("hc.runner.pack", 1_700_000, 200_000),
        x("kernel", "void ppe_forward_kernel<8, false>()", 1_150_000,
          50_000),
        x("gpu_memcpy", "Memcpy HtoD", 1_320_000, 80_000),
        x("cpu_op", "aten::empty", 1_000_000, 999_999),
    ]


def test_idle_put_down_to_the_innermost_span():
    w = worker_trace.reduce(events())
    # idle: 1.0-1.15, 1.2-1.32, 1.4-2.0
    assert w["idle_s"] == pytest.approx(0.87)
    by = dict(w["idle_by_worker_span"])
    assert by == pytest.approx({
        "runner.pack.unique_rows": 0.1,  # 1.0-1.1, the part in the window
        "runner.pack.encode": 0.05,  # 1.1-1.15 (busy 1.15-1.2)
        "runner.pack.encode.nib": 0.08,
        "runner.pack": 0.22,  # 1.28-1.3 and 1.7-1.9
        "runner.launch": 0.02,
        "runner.batch": 0.2,  # 1.4-1.6 (busy 1.32-1.4)
        "worker idle": 0.2,  # 1.6-1.7 and 1.9-2.0
    })
    assert [s for _, s in w["idle_by_worker_span"]] == sorted(
        by.values(), reverse=True)
    assert w["idle_in_pack_s"] == pytest.approx(0.45)
    # the caller's wait is not the worker's
    assert "runner.wait" not in by and "runner.wait" not in w["self_s"]


def test_self_time_in_the_window():
    assert worker_trace.reduce(events())["self_s"] == pytest.approx({
        "runner.pack.unique_rows": 0.1, "runner.pack.encode": 0.1,
        "runner.pack.encode.nib": 0.08, "runner.pack": 0.22,
        "runner.launch": 0.02, "runner.batch": 0.28})


def test_a_child_past_its_parent_is_cut_to_it():
    pieces = worker_trace.innermost([(0.0, 10.0, "a"), (2.0, 10.0001, "b"),
                                     (10.0001, 12.0, "c")])
    assert pieces == [(0.0, 2.0, "a"), (2.0, 10.0, "b"),
                      (10.0001, 12.0, "c")]


def test_nothing_without_the_workers_spans():
    bare = [e for e in events() if not e["name"].startswith("hc.runner.b")]
    # spans of the worker without its batch spans are not known as its
    assert worker_trace.reduce(bare) is None
    with pytest.raises(ValueError):
        worker_trace.reduce(events()[1:])


def record(**extra):
    rec = {"work": {"cells": 2e9},
           "stage_sums_ms": {"pack": 100.0, "finalize": 5.0,
                             "unique_rows": 50.0, "encode": 40.0,
                             "launch": 2.0, "pack_cpu": 90.0},
           "trace": None, "worker_trace": worker_trace.reduce(events())}
    rec.update(extra)
    return rec


def test_readers():
    rec = record()
    assert read("runner.unique_rows_ms_per_gcell", rec) == pytest.approx(25)
    assert read("runner.encode_ms_per_gcell", rec) == pytest.approx(20)
    assert read("runner.launch_ms_per_gcell", rec) == pytest.approx(1)
    assert read("runner.pack_offcpu_pct", rec) == pytest.approx(10)
    assert read("device.idle_in_pack_pct", rec) == pytest.approx(
        100 * 0.45 / 0.87)


def test_readers_find_nothing_in_a_runner_without_the_parts():
    """A record of a runner with only its pack and finalize stages and no
    worker spans, untraced or traced: every reader says nothing."""
    for worker in ({}, {"worker_trace": None}):
        rec = record(stage_sums_ms={"pack": 100.0, "finalize": 5.0})
        rec.pop("worker_trace")
        rec.update(worker)
        assert all(read(name, rec) is None for name in READERS)


def test_the_ports_spans_reduce(cell, tmp_path):
    """The runner on the CPU under a profile of every thread: the worker's
    spans are found by the names this module reads, and every second of
    the window (no card: all idle) is put down to one of them or to the
    worker's idleness."""
    config, traffic = cell
    pool = gen.make_pool(config, traffic, 2 ** 31 + 5)
    bg = runner_stream.open_runner(["cpu"])
    jobs, _work = runner_stream.make_jobs(pool)
    stream = runner_stream.Stream(bg, jobs, traffic)
    stream.run(submits=1)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=every_thread) as prof:
        with torch.profiler.record_function(trace.SPAN_PREFIX + "window"):
            stream.run(submits=2)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    w = worker_trace.reduce(trace.load(path))
    assert w is not None
    assert sum(s for _, s in w["idle_by_worker_span"]) == pytest.approx(
        w["idle_s"], rel=1e-6)
    assert {"runner.batch", "runner.plan", "runner.pack",
            "runner.pack.unique_rows", "runner.pack.encode",
            "runner.launch", "runner.read_back"} <= set(w["self_s"])
    assert 0 < w["idle_in_pack_s"] < w["idle_s"]
