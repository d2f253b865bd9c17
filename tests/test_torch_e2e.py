"""The port end to end on the chrM fixture, against the golden VCF and the
reference package, plus the port's import hygiene."""

import ast
import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import pytest

from gatk_hc_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from gatk_hc_tpu.models.caller import call_batched as jax_call_batched
from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.models.caller import call_batched
from gatk_hc_tpu_torch.ops.runner import TorchPairHMMRunner
from tests.test_torch_runner import one_torch_thread  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")
SAM = os.path.join(FIXTURES, "chrM.sam")
FASTA = os.path.join(FIXTURES, "chrM.fa")
GOLDEN = os.path.join(FIXTURES, "chrM.golden.vcf")
PORT = os.path.join(REPO, "gatk_hc_tpu_torch")


def test_cuda_runner_on_cpu_matches_reference(tmp_path):
    """The cuda engine's runner (plain version on CPU tensors) over chrM
    regions i < 6 writes the reference package's VCF text."""
    flt = lambda i: i < 6  # noqa: E731
    ref = tmp_path / "ref.vcf"
    jax_call_batched(
        SAM, FASTA, str(ref),
        dataclasses.replace(JAX_DEFAULT_CONFIG, pairhmm_engine="native"),
        region_filter=flt,
    )
    out = tmp_path / "port.vcf"
    runner = TorchPairHMMRunner(DEFAULT_CONFIG, device="cpu")
    results = call_batched(
        SAM, FASTA, str(out), DEFAULT_CONFIG, region_filter=flt, runner=runner
    )
    assert out.read_text() == ref.read_text()
    assert sum(len(r.variants) for r in results) > 0
    assert runner.dispatch_counts["planes"] >= 1


def test_native_engine_matches_golden(tmp_path):
    cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")
    out = tmp_path / "chrM.vcf"
    results = call_batched(SAM, FASTA, str(out), cfg)
    assert out.read_text() == open(GOLDEN).read()
    assert sum(len(r.variants) for r in results) == 35


def test_cli_native_matches_golden(tmp_path):
    out = tmp_path / "cli.vcf"
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["-I", SAM, "-R", FASTA, "-O", str(out),
                       "--pairhmm", "native", "--stats"])
    assert rc == 0
    assert out.read_text() == open(GOLDEN).read()
    assert '"variants": 35' in stdout.getvalue()


def test_cuda_runner_raises_without_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPairHMMRunner(DEFAULT_CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        # the default engine through call_batched builds the cuda runner
        call_batched(SAM, FASTA, None, DEFAULT_CONFIG, region_filter=lambda i: i < 1)
    assert TorchPairHMMRunner(DEFAULT_CONFIG, device="cpu").device.type == "cpu"


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), REPO)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_import_hygiene_subprocess():
    """Importing every module of the port (and chip_smoke.py) loads neither
    jax nor any module of the reference package."""
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r} + ['chip_smoke']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'gatk_hc_tpu' or k.startswith('gatk_hc_tpu.'))\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_import_hygiene_source_scan():
    """No module of the port, and not chip_smoke.py, imports jax, the JAX
    package, or the reference's top-level bench.py and tools/."""
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(dirpath, name)
        for dirpath, _dirs, names in os.walk(PORT)
        for name in names
        if name.endswith(".py")
    ]
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gatk_hc_tpu", "bench",
                               "tools"), (path, name)
