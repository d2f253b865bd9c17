"""One run of one cell of the port's benchmark, on the card.

    python3 -m hcbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is the entry of
``BENCHMARK.json``'s ``workloads`` named ``--workload``; its traffic
mix's ``driver`` (``hcbench/drivers/<driver>.py``) builds the system under
test, drives the measured window and checks what the window produced
against the plain reference.  Then each metric of the cell
(``end_to_end`` with ``--trace 0``, ``per_layer`` with ``--trace 1``,
those whose ``workloads`` list names the cell or that have none) is read
by its reader, ``hcbench/metrics/<name>.py``; a reader that finds
nothing to read returns None and its metric is left out.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``program`` (what the runner did) and last
``checks``, each number compared beside its limit, which are also the
last lines on standard error.

Before ``import torch`` the process is bound to the CPUs of its cards'
NUMA node where sysfs names one (``host.py``); ``program.host`` records
where the run ran and what its threads did in the window.

Exits 2 and prints no result when no card is visible or fewer than the
cell's chips, and 3 when ``jax``, ``jaxlib``, ``flax`` or the JAX package
(``gatk_hc_tpu``, whose name the port's begins with) is loaded once the
window has closed.  The kernel cache, torch's extension directory and
Triton's cache are fixed directories under ``.hcbench_cache/`` in the
checkout, so only a checkout's first run builds; the port's
``GATK_HC_TPU_TORCH_*`` settings are cleared, so that it runs its
defaults.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Dict, Optional

from hcbench import host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "hcbench")
CACHE = os.path.join(ROOT, ".hcbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gatk_hc_tpu")


def process_age_s() -> float:
    """Seconds since this process started (procfs)."""
    with open("/proc/self/stat") as handle:
        rest = handle.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as handle:
        uptime = float(handle.read().split()[0])
    return uptime - float(rest[19]) / os.sysconf("SC_CLK_TCK")


def load_spec(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as handle:
        return json.load(handle)


def load_json(kind: str, name: str) -> Dict:
    with open(os.path.join(HERE, kind, name + ".json")) as handle:
        return json.load(handle)


def load_module(kind: str, name: str):
    """``hcbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"hcbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(spec: Dict, workload: str, traced: bool):
    """The cell's metrics for this kind of run, in BENCHMARK.json order."""
    for metric in spec["per_layer" if traced else "end_to_end"]:
        if workload in metric.get("workloads", [workload]):
            yield metric


def read_metrics(spec: Dict, workload: str, traced: bool,
                 record: Dict) -> Dict[str, Dict]:
    out = {}
    for metric in metrics_of(spec, workload, traced):
        value: Optional[float] = load_module("metrics",
                                             metric["name"]).read(record)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def forbidden_modules():
    """Loaded modules of the JAX stack, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def judge(record: Dict):
    """-> (correct, {name: {"value", "limit"}}): the widest log10 gap of
    the checked pairs against its limit, and every region of the window
    answered (``missing_results`` 0); no pair checked is not correct."""
    checks = {
        "max_log10_gap": {"value": record["check"]["max_log10_gap"],
                          "limit": record["check"]["limit"]},
        "missing_results": {"value": record["missing"], "limit": 0},
    }
    correct = record["check"]["pairs"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def set_environment() -> None:
    """The port's defaults, and every cache at a fixed path in the
    checkout."""
    for key in list(os.environ):
        if key.startswith("GATK_HC_TPU_TORCH_"):
            del os.environ[key]
    os.environ["GATK_HC_TPU_TORCH_KERNEL_CACHE"] = os.path.join(CACHE,
                                                                "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"hcbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    set_environment()
    t_bind = time.perf_counter()
    where = host.bind(host.place(host.card_bus_ids(cell["chips"]),
                                 os.sched_getaffinity(0)))
    bind_s = time.perf_counter() - t_bind
    age_at_import = process_age_s()
    t_import = time.perf_counter()
    import torch

    import_s = time.perf_counter() - t_import
    if not torch.cuda.is_available():
        print("hcbench: no CUDA device is available; the benchmark runs "
              "only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"hcbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from hcbench import roofline

    config = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    driver = load_module("drivers", traffic["driver"])
    devices = [f"cuda:{i}" for i in range(cell["chips"])]
    traced = bool(args.trace)
    record = driver.run(config, traffic, args.seed, args.seconds, traced,
                        devices)
    record["setup_s"] = process_age_s() - (time.perf_counter()
                                           - record["window_start"])
    found = forbidden_modules()
    if found:
        print(f"hcbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    correct, checks = judge(record)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell["chips"],
        "memory_peak_bytes": record["memory_peak_bytes"],
    }
    result = {
        "correct": correct,
        "attempted": record["attempted"],
        "failed": record["missing"] + record["check"]["regions_past_limit"],
        "metrics": read_metrics(spec, cell["name"], traced, record),
        "device": device,
    }
    if traced and record["trace"] is not None:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = {
            "device_ops": record["trace"]["device_ops"],
            "idle_gaps": record["trace"]["idle_gaps"],
        }
    record["program"]["setup_parts"].update(
        import_torch_s=import_s, process_age_at_import_s=age_at_import,
        bind_s=bind_s)
    record["program"]["host"] = {**where, **record["program"]["host"]}
    result["program"] = {
        **record["program"],
        "spans_ms": record["spans_ms"],
        "stage_sums_ms": record["stage_sums_ms"],
        "card": roofline.card_header(),
        "torch": torch.__version__,
        "window_s": record["window_s"],
        "true_cells": record["work"]["cells"],
        "check": record["check"],
        "check_s": record["check_s"],
    }
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
