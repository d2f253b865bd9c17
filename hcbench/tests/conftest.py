"""The benchmark's own tests: ``python -m pytest hcbench/tests -q`` from
the checkout's root.  Tests marked ``card`` need an NVIDIA card and skip
without one; they decide so inside the test."""

import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs the benchmark on an NVIDIA card; skips "
        "without one")


def small_shapes():
    """24 regions of the recorded mixes' kinds, small: mostly 2
    haplotypes of ~70 bp, a few of 4; 12 reads, 8 whole and 4 clipped."""
    rng = np.random.default_rng(3)
    shapes = []
    for k in range(24):
        n_haps = 4 if k % 6 == 5 else 2
        haps = [70] + [70 + int(d) for d in rng.integers(-4, 5, n_haps - 1)]
        reads = [30] * 8 + sorted(rng.integers(5, 30, 4).tolist(),
                                  reverse=True)
        shapes.append((haps, reads))
    return shapes


def small_cell():
    """A configuration and mix of the cells' kind at a size the CPU runs
    in seconds: 30 bp reads and ~70 bp haplotypes (``small_shapes``), and
    up to 12 substitutions a read, so that some pairs underflow and the
    sentinel rule is exercised."""
    with open(os.path.join(ROOT, "hcbench/configs/wgs30x_2x151.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "hcbench/traffic/wgs.json")) as f:
        traffic = json.load(f)
    config.update(read_length=30)
    traffic.update(regions_per_submit=3, max_in_flight=2, warmup_submits=2,
                   substitutions_per_read_max=12, check_regions=24,
                   shapes=small_shapes())
    return config, traffic


@pytest.fixture
def cell():
    return small_cell()
