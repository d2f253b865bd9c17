"""The readers' arithmetic and the trace reduction on hand-made input."""

import pytest

from hcbench import roofline, run, trace


def record(**extra):
    work = roofline.job_work(read_len_sum=151 * 100, hap_len_sum=415 * 20,
                             n_reads=100, n_haps=20)
    rec = {"work": work, "window_s": 2.0, "setup_s": 9.5,
           "spans_ms": {"drain": 40.0, "submit": 1.0},
           "stage_sums_ms": {"pack": 30.0, "finalize": 5.0}, "trace": None}
    rec.update(extra)
    return rec


def read(name, rec):
    return run.load_module("metrics", name).read(rec)


def test_job_work():
    w = roofline.job_work(read_len_sum=10, hap_len_sum=7, n_reads=2,
                          n_haps=3)
    # 2 reads (10 bases in all) x 3 haplotypes (7 bases in all)
    assert w == {"pairs": 6, "cells": 70,
                 "ops": 12 * 70 + 2 * 2 * 7 + 6,
                 "bytes": 4 * (3 * 3 * 10 + 2 * 7 + 3 * 6) + 4 * 6}


def test_end_to_end_readers():
    rec = record()
    cells = 151 * 100 * 415 * 20
    assert read("gcells_per_s", rec) == pytest.approx(cells / 2.0 / 1e9)
    assert read("setup_s", rec) == 9.5


def test_per_layer_readers():
    rec = record()
    gcells = 151 * 100 * 415 * 20 / 1e9
    assert read("caller.drain_wait_ms_per_gcell", rec) == pytest.approx(
        40.0 / gcells)
    assert read("runner.pack_ms_per_gcell", rec) == pytest.approx(
        30.0 / gcells)
    assert read("runner.finalize_ms_per_gcell", rec) == pytest.approx(
        5.0 / gcells)
    # no trace: the trace's readers find nothing and say so
    assert read("pairhmm_roofline", rec) is None
    assert read("device.idle_pct", rec) is None


def events():
    """A 1 s window: two overlapping kernels, a copy, a gap in a drain."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    return [
        x("user_annotation", "hcbench.window", 1_000_000, 1_000_000),
        x("user_annotation", "hcbench.drain", 1_500_000, 400_000),
        x("user_annotation", "hcbench.submit", 1_000_000, 50_000),
        x("kernel", "void ppe_forward_kernel<5, false>()", 1_000_000,
          200_000),
        x("kernel", "void ppe_forward_kernel<5, false>()", 1_100_000,
          200_000),
        x("gpu_memcpy", "Memcpy HtoD", 1_400_000, 100_000),
        x("kernel", "outside the window", 500_000, 100_000),
        x("cpu_op", "aten::empty", 1_000_000, 999_999),
    ]


def test_trace_reduction():
    t = trace.reduce(events())
    assert t["window_s"] == pytest.approx(1.0)
    assert t["busy_s"] == pytest.approx(0.4)  # [1.0, 1.3] and [1.4, 1.5]
    assert t["device_s"]["void ppe_forward_kernel<5, false>()"] == \
        pytest.approx(0.4)
    assert t["idle_gaps"][0] == ["drain", pytest.approx(0.5)]
    assert t["idle_gaps"][1] == ["loop", pytest.approx(0.1)]
    assert t["device_ops"][0][1] == pytest.approx(0.4)


def test_trace_readers():
    rec = record(trace=trace.reduce(events()))
    assert read("device.idle_pct", rec) == pytest.approx(60.0)
    bound = roofline.bound_s(rec["work"])[0]
    assert read("pairhmm_roofline", rec) == pytest.approx(100 * bound / 0.4)


def test_a_trace_without_a_window_raises():
    with pytest.raises(ValueError):
        trace.reduce(events()[1:])


def test_bound_is_the_larger_time():
    work = {"ops": 67e12, "bytes": 3.35e12 / 2}
    assert roofline.bound_s(work) == (pytest.approx(1.0), "operations")
