"""BENCHMARK.json against the rules its harness relies on, and the
harness's independence from the JAX package."""

import ast
import glob
import json
import os
import re
import sys

import pytest

from conftest import ROOT
from hcbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "gatk_hc_tpu"}


@pytest.fixture(scope="module")
def spec():
    return run.load_spec(ROOT)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["hcbench"]
    assert spec["command"][:3] == ["python3", "-m", "hcbench.run"]
    assert 1 <= spec["run_seconds"] <= 51


def test_names_and_units(spec):
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in spec[kind]}) == len(spec[kind])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    text = [w["why"] for w in spec["workloads"]]
    text += [c["source"] for c in spec["configs"]]
    text += [m["layer"] for m in spec["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in text)


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert set(e2e) == {"gcells_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] == "gcells_per_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_cells_name_their_files(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert all(k in body for k in c["reduced"])
    for w in spec["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        traffic = run.load_json("traffic", w["traffic"])
        assert os.path.exists(os.path.join(
            ROOT, "hcbench", "drivers", traffic["driver"] + ".py"))
    assert {w["config"] for w in spec["workloads"]} == set(configs)


def sources():
    return glob.glob(os.path.join(ROOT, "hcbench", "**", "*.py"),
                     recursive=True)


def test_no_module_imports_the_jax_stack():
    for path in sources():
        assert not set(imported(path)) & FORBIDDEN, path


def imported(path):
    """Top-level names of the modules a file imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_yardstick_imports_nothing_of_the_port():
    for name in ("gen", "reference", "roofline", "trace"):
        assert "gatk_hc_tpu_torch" not in set(
            imported(os.path.join(ROOT, "hcbench", name + ".py")))


def literals(path):
    """String constants of a file's code, docstrings left out."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_code_names_the_tpu_records():
    """Nothing reads the JAX package's top-level bench.py, its BENCH_* and
    MULTICHIP_* records or perf_artifacts/."""
    me = os.path.abspath(__file__)
    for path in sources():
        if os.path.abspath(path) == me:
            continue
        for text in literals(path):
            assert not re.search(
                r"perf_artifacts|BENCH_r|MULTICHIP_r|(^|/)bench\.py", text), (
                path, text)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gatk_hc_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.forbidden_modules() == ["jaxlib"]
