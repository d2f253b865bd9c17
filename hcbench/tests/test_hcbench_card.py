"""The command itself on the card, one short run of each cell, plain and
traced: ``python -m pytest hcbench/tests -m card`` on a machine with an
NVIDIA card.  Skips without one."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from hcbench import run


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", ["hmm250.wgs"])
def test_a_short_run(workload, traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "-m", "hcbench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace",
         str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    spec = run.load_spec(ROOT)
    want = {m["name"] for m in run.metrics_of(spec, workload, bool(traced))}
    assert set(result["metrics"]) == want
    where = result["program"]["host"]
    assert {"bus_ids", "numa_nodes", "local_cpulist", "affinity",
            "bound_cpus", "loadavg", "cpu_mhz", "voluntary_cs",
            "involuntary_cs", "threads", "pool_s"} <= set(where)
    assert {"name", "cpu", "cpu_s"} <= set(where["threads"][0])
    if traced:
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
        assert result["metrics"]["pairhmm_roofline"]["value"] <= 100
    assert proc.stderr.strip().splitlines()[-1].startswith(
        "check missing_results")
