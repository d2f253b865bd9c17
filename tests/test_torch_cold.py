"""The port's cold-start layer on the CPU: the host path stays torch-free as
the reference's stays JAX-free (gatk_hc_tpu/ops/runner.py, cli.py), torch
is imported on BackgroundRunner's build thread, and the kernel cache
(ops/_kernels.py, parallel/compile_cache.py, tools/warm_cache.py) keys,
builds, finds and refuses libraries as the counterpart of the reference's
ops/aot.py and parallel/compile_cache.py.

Every case where ``sys.modules`` matters runs in a fresh subprocess."""

import contextlib
import io
import json
import os
import stat
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from gatk_hc_tpu import cli as ref_cli
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.ops import _kernels
from gatk_hc_tpu_torch.ops import runner as runner_mod
from gatk_hc_tpu_torch.ops import torch_runner
from gatk_hc_tpu_torch.parallel import compile_cache
from gatk_hc_tpu_torch.tools import warm_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")
SAM = os.path.join(FIXTURES, "chrM.sam")
FASTA = os.path.join(FIXTURES, "chrM.fa")
GOLDEN = os.path.join(FIXTURES, "chrM.golden.vcf")

# a fresh process: records which threads first looked torch up, runs the
# code with its stdout captured, then prints {"torch_loaded",
# "torch_importers", "out"} as its last line ("out" is the code's stdout)
_PROLOGUE = """\
import contextlib, io, json, sys, threading
importers = []


class Spy:
    def find_spec(self, name, path=None, target=None):
        if name == "torch":
            importers.append(threading.current_thread().name)
        return None


sys.meta_path.insert(0, Spy())
out = io.StringIO()
with contextlib.redirect_stdout(out):
"""
_EPILOGUE = """
print(json.dumps({"torch_loaded": "torch" in sys.modules,
                  "torch_importers": importers, "out": out.getvalue()}))
"""


def fresh(body: str, env=None, timeout=300):
    """Run ``body`` under the harness in a fresh Python process -> the
    harness's JSON."""
    code = (_PROLOGUE + textwrap.indent(textwrap.dedent(body), "    ")
            + _EPILOGUE)
    full_env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    full_env.update(env or {})
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=full_env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def port_cli(argv, env=None):
    """The port's CLI in a fresh process -> (harness JSON, --stats dict)."""
    res = fresh(f"""\
        from gatk_hc_tpu_torch import cli
        assert cli.main({list(argv)!r}) == 0
        """, env=env)
    return res, json.loads(res["out"].splitlines()[0])


def reference_vcf(tmp_path, argv):
    out = tmp_path / "reference.vcf"
    with contextlib.redirect_stdout(io.StringIO()):
        assert ref_cli.main(["-I", SAM, "-R", FASTA, "-O", str(out)] + argv) == 0
    return out.read_text()


# -- the torch-free host path -------------------------------------------


@pytest.mark.parametrize("module", [
    "gatk_hc_tpu_torch.ops.runner", "gatk_hc_tpu_torch.cli",
    "gatk_hc_tpu_torch.models.caller", "gatk_hc_tpu_torch.ops._kernels",
    "gatk_hc_tpu_torch.parallel.compile_cache",
    "gatk_hc_tpu_torch.tools.host_profile",
    "gatk_hc_tpu_torch.tools.warm_cache",
])
def test_import_loads_no_torch(module):
    res = fresh(f"import {module}\n")
    assert not res["torch_loaded"], module


@pytest.mark.parametrize("engine,interval", [
    ("native", "chrM:0-3000"), ("python", "chrM:1000-1100"),
])
def test_host_engine_run_loads_no_torch(tmp_path, engine, interval):
    """A --pairhmm native / python CLI run, --stats included, never loads
    torch, and its VCF is the reference package's."""
    out = tmp_path / "port.vcf"
    res, stats = port_cli(["-I", SAM, "-R", FASTA, "-O", str(out), "-L",
                           interval, "--pairhmm", engine, "--stats"])
    assert not res["torch_loaded"] and not res["torch_importers"]
    assert stats["engine"] == engine and "kernel_launches" not in stats
    # the reference's native and python engines are bit-exact alike
    want = reference_vcf(tmp_path, ["-L", interval, "--pairhmm", "native"])
    assert out.read_text() == want


def test_host_profile_stub_loads_no_torch():
    res = fresh(f"""\
        from gatk_hc_tpu_torch.tools import host_profile
        host_profile.main([{SAM!r}, {FASTA!r}])
        """)
    assert not res["torch_loaded"]
    row = json.loads(res["out"].splitlines()[0])
    assert row["regions"] == 68 and row["reads_parsed"]


def test_background_runner_imports_torch_on_build_thread(tmp_path):
    """The default cuda engine on the CPU, through BackgroundRunner, with
    --genotyper cuda (the genotype thread also reaches torch: the import
    lock case): torch is first looked up on the "hc-build" thread, the
    stats carry the build thread's import time, and the VCF is golden."""
    out = tmp_path / "bg.vcf"
    res, stats = port_cli(["-I", SAM, "-R", FASTA, "-O", str(out),
                           "--device", "cpu", "--genotyper", "cuda",
                           "--stats"])
    assert res["torch_loaded"] and res["torch_importers"] == ["hc-build"]
    init = stats["init_profile"]
    assert init["torch_preloaded"] is False and init["torch_import_s"] > 0
    assert init["build_start_at_age_s"] > 0 and "runner_ctor_s" in init
    assert "kernel_cache" not in init  # the CPU builds no kernel
    with open(GOLDEN) as handle:
        assert out.read_text() == handle.read()


def test_background_runner_direct_build_thread():
    res = fresh("""\
        from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
        from gatk_hc_tpu_torch.ops.runner import BackgroundRunner
        bg = BackgroundRunner(DEFAULT_CONFIG, device="cpu")
        print(sorted(bg.runner.init_profile))
        """)
    assert res["torch_importers"] == ["hc-build"]
    assert "torch_import_s" in res["out"]


# names the tests, tools and chip_smoke.py import from ops.runner
RUNNER_NAMES = (
    "PairHMMJob", "DispatchPathController", "DeviceWedgedError",
    "BackgroundRunner", "NativePairHMMRunner", "TorchPairHMMRunner",
    "DiagPairHMMRunner", "local_devices", "join_payloads", "segments_of",
    "torch_pairhmm_engine", "STAGES", "_Unique", "_DaemonWorker",
)


@pytest.mark.parametrize("name", RUNNER_NAMES)
def test_runner_names_resolve(name):
    got = getattr(runner_mod, name)
    if hasattr(torch_runner, name):
        assert got is getattr(torch_runner, name)


def test_runner_unknown_name_raises():
    with pytest.raises(AttributeError, match="no_such_name"):
        runner_mod.no_such_name  # noqa: B018


def test_background_runner_built_never_waits(monkeypatch):
    """built() returns None at once while the build runs and after it
    raised (submit still raises the build's error), and the runner once
    a build ended without error."""
    release = threading.Event()

    class SlowBrokenRunner:
        def __init__(self, cfg, *a, **k):
            release.wait(30)
            raise RuntimeError("nvcc failed")

    monkeypatch.setattr(runner_mod, "TorchPairHMMRunner", SlowBrokenRunner)
    bg = runner_mod.BackgroundRunner(DEFAULT_CONFIG, device="cpu")
    t0 = time.perf_counter()
    assert bg.built() is None
    assert time.perf_counter() - t0 < 1.0 and bg._thread.is_alive()
    release.set()
    bg._thread.join(30)
    assert bg.built() is None
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bg.submit([])
    monkeypatch.undo()

    good = runner_mod.BackgroundRunner(DEFAULT_CONFIG, device="cpu")
    inner = good.runner  # joins the build
    assert inner is not None and good.built() is inner
    good.stop_prewarm()


def test_stats_without_jobs_skip_a_failed_build(tmp_path):
    """--pairhmm cuda --device cuda --stats with no card, on a window with
    no PairHMM job: the run never joins the failed build, exits 0 with the
    header-only VCF and no runner stats, and the build thread's torch
    import leaves no teardown tracebacks at exit."""
    out = tmp_path / "empty.vcf"
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "gatk_hc_tpu_torch.cli", "-I", SAM, "-R",
         FASTA, "-O", str(out), "-L", "chrM:16500-16569", "--pairhmm",
         "cuda", "--device", "cuda", "--stats"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.splitlines()[0])
    assert stats["regions"] == 1 and stats["variants"] == 0
    for key in ("init_profile", "dispatch_profile", "device_stages_ms",
                "cuda_max_memory_allocated_mb", "kernel_launches"):
        assert key not in stats, key
    lines = out.read_text().splitlines()
    assert lines and all(line.startswith("#") for line in lines)
    assert "Exception ignored" not in proc.stderr
    assert "Traceback" not in proc.stderr


# -- the kernel cache ----------------------------------------------------

_STUB_NVCC = """\
#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
if [ -n "$STUB_NVCC_FAIL" ]; then echo "stub: error" >&2; exit 1; fi
echo "library" > "$out"
"""


@pytest.fixture
def stub_toolkit(tmp_path, monkeypatch):
    """A toolkit whose nvcc is a script that writes its -o file, a csrc
    directory with one source that includes a local header, an empty
    cache directory and a fresh cache record."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_STUB_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    (home / "version.json").write_text('{"cuda": {"version": "12.4.0"}}')
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "toy.cu").write_text('#include "toy.h"\n__global__ void k() {}\n')
    (csrc / "toy.h").write_text("#define TOY 1\n")
    monkeypatch.setenv("PATH", f"{home / 'bin'}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_kernels, "CSRC", str(csrc))
    monkeypatch.setattr(_kernels, "_cache_dir", str(tmp_path / "cache"))
    monkeypatch.setattr(_kernels, "_record", {})
    monkeypatch.setattr(_kernels, "_nvcc_runs", 0)
    return {"home": home, "nvcc": nvcc, "csrc": csrc,
            "cache": tmp_path / "cache"}


def test_key_follows_sources_flags_toolkit_and_dir(stub_toolkit, monkeypatch,
                                                   tmp_path):
    csrc, home = stub_toolkit["csrc"], stub_toolkit["home"]
    assert _kernels.sources("toy") == [str(csrc / "toy.cu"),
                                       str(csrc / "toy.h")]
    keys = [_kernels.library_key("toy")]
    paths = [_kernels.library_path("toy")]
    assert paths[0].startswith(str(stub_toolkit["cache"]))
    assert _kernels.library_key("toy") == keys[0]  # deterministic

    def changed():
        keys.append(_kernels.library_key("toy"))
        assert len(set(keys)) == len(keys), keys

    (csrc / "toy.cu").write_text('#include "toy.h"\n__global__ void k() {;}\n')
    changed()  # a source byte
    (csrc / "toy.h").write_text("#define TOY 2\n")
    changed()  # a byte of a local include
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-G",))
    changed()  # a flag
    (home / "version.json").write_text('{"cuda": {"version": "12.8.0"}}')
    changed()  # the toolkit's version
    stub_toolkit["nvcc"].write_text(_STUB_NVCC + "\n")
    changed()  # another nvcc binary
    # the cache directory moves the library, not its key
    _kernels.set_cache_dir(str(tmp_path / "other"))
    assert _kernels.library_path("toy") == os.path.join(
        str(tmp_path / "other"), f"libtoy-{keys[-1]}.so")


def test_stub_build_then_hit(stub_toolkit, monkeypatch):
    path = _kernels.build("toy")
    assert os.path.exists(path) and path == _kernels.library_path("toy")
    rep = _kernels.cache_report()
    assert rep["nvcc_runs"] == 1
    assert rep["libraries"]["toy"]["status"] == "built"
    # the compile wrote a private temporary name, replaced into place
    assert os.listdir(stub_toolkit["cache"]) == [os.path.basename(path)]
    # a second process (a fresh record) finds it: a hit, no nvcc
    monkeypatch.setattr(_kernels, "_record", {})
    monkeypatch.setattr(_kernels, "_nvcc_runs", 0)
    assert _kernels.build("toy") == path
    rep = _kernels.cache_report()
    assert rep["nvcc_runs"] == 0 and rep["libraries"]["toy"]["status"] == "hit"


def test_stub_failed_build_raises_and_leaves_nothing(stub_toolkit,
                                                     monkeypatch):
    monkeypatch.setenv("STUB_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed for toy.cu"):
        _kernels.build("toy")
    assert os.listdir(stub_toolkit["cache"]) == []
    assert "toy" not in _kernels.cache_report()["libraries"]


def test_cached_library_that_fails_to_load_raises(stub_toolkit, monkeypatch):
    """The stub's "library" is not a shared object: load raises with its
    path, and does not rebuild it."""
    monkeypatch.setitem(_kernels._BINDERS, "toy", lambda lib: None)
    monkeypatch.setattr(_kernels, "_libs", {})
    path = _kernels.build("toy")
    with pytest.raises(RuntimeError, match="cannot load the kernel library") \
            as info:
        _kernels.load("toy")
    assert path in str(info.value)
    assert _kernels.cache_report()["nvcc_runs"] == 1


def test_no_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.library_key("pairhmm_ppe")


def test_compile_cache_env_and_enable(tmp_path):
    where = tmp_path / "kernels"
    res = fresh("""\
        from gatk_hc_tpu_torch.ops import _kernels
        from gatk_hc_tpu_torch.parallel import compile_cache
        print(compile_cache.DEFAULT_CACHE_DIR, _kernels.cache_report()["dir"])
        """, env={compile_cache.CACHE_ENV: str(where)})
    assert res["out"].split() == [str(where), str(where)]
    assert not res["torch_loaded"]
    default = os.path.join(REPO, "gatk_hc_tpu_torch", "_build")
    env = {k: v for k, v in os.environ.items() if k != compile_cache.CACHE_ENV}
    proc = subprocess.run(
        [sys.executable, "-c", "from gatk_hc_tpu_torch.parallel import "
         "compile_cache as c; print(c.DEFAULT_CACHE_DIR)"],
        cwd=REPO, env=dict(env, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=60)
    assert proc.stdout.strip() == default


def test_enable_compile_cache_points_kernels(stub_toolkit, tmp_path):
    where = tmp_path / "moved" / "cache"
    compile_cache.enable_compile_cache(str(where))
    assert _kernels.cache_report()["dir"] == str(where)
    assert not where.exists()  # made at the first build, not before
    assert os.path.dirname(_kernels.build("toy")) == str(where)


# -- tools/warm_cache.py ------------------------------------------------


def test_warm_cache_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        warm_cache.main(["--quick"])


def test_warm_cache_raises_without_card(stub_toolkit):
    import torch

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_cache.main([])
    assert _kernels.cache_report()["nvcc_runs"] == 0  # raised before a build


def test_warm_cache_instances_are_chip_smokes():
    """warm_cache launches every kernel instance the chip smoke test
    reports: the launch counters its instances move are chip_smoke.py's
    kernel names (every counter of LAUNCHES), and each machine-code
    instance it runs is one the compiler report requires."""
    import chip_smoke

    full = warm_cache.instances()
    counters = {c for inst in full for c in inst.counters}
    assert counters == set(chip_smoke.KERNEL_NAMES) == set(_kernels.LAUNCHES)
    required = set().union(*(chip_smoke.expected_instances(lib)
                             for lib in _kernels.KERNELS))
    assert {inst.machine_instance for inst in full} <= required
    assert len({inst.name for inst in full}) == len(full) == 21
    quick = warm_cache.instances(quick=True)
    assert {i.name for i in quick} == {"ppe4_front_planes", "ppe4_front_nib",
                                       "genotype_f64"}


def test_warm_cache_inputs_on_cpu():
    """The quick instances' seeded inputs through the kernels' plain
    versions on the CPU (the wrappers' CPU route and the plain version
    called directly agree bit for bit)."""
    import torch

    launcher = warm_cache._Launcher(torch.device("cpu"))
    for inst in warm_cache.instances(quick=True):
        kernel, plain = launcher.calls(inst)
        got = kernel()
        assert launcher.equal(got, plain())
        first = got[0] if isinstance(got, tuple) else got
        assert torch.isfinite(first).all() and (first != 0).any()
