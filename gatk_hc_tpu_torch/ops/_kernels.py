"""The package's CUDA kernel libraries (csrc/*.cu): build, cache, ctypes
binding, and the launch counts of their wrappers.

Each source is compiled with nvcc into a shared library with a plain C
interface, at first use, into the kernel cache directory
(parallel/compile_cache.py: ``gatk_hc_tpu_torch/_build/`` unless
GATK_HC_TPU_TORCH_KERNEL_CACHE or ``enable_compile_cache`` moves it).

These content-addressed libraries are the port's ahead-of-time artefacts,
its counterpart of gatk_hc_tpu/ops/aot.py (there is no aot.py here: a
wrapper module would only repeat this one).  A library's file name carries
its key, a hash of every source it is built from (the .cu file and each
local ``#include "..."``), the nvcc flags (the arch among them) and the
toolkit's identity (the resolved nvcc's path and stat, and
``version.json`` beside its ``bin/``), so an edited source or another
toolkit never loads a stale build; the key is computed without starting a
process.  A build compiles to a private temporary name that os.replace
moves into place (safe when several processes build at once).  Each
library's outcome in this process, ``hit`` (found in the cache) or
``built`` (nvcc ran), with its seconds, is in ``cache_report()``
(``init_profile["kernel_cache"]`` in the CLI's --stats).  A failed build
raises, and so does a cached library that fails to load, with its path:
there is no silent rebuild and no fallback (the reference's ``aot.load``
falls back to tracing instead).

Nothing here runs at import time and nothing imports torch: a machine
without nvcc or a card imports the package and uses the kernels' plain
PyTorch versions on CPU tensors, and a run that launches nothing reads
``LAUNCHES`` without loading torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

from ..parallel.compile_cache import DEFAULT_CACHE_DIR

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")

# -fmad=false: no mul+add contraction, f32 or f64 (bit-exactness vs the
# oracle and the host genotyper); -ftz=true: f32 results flush to zero like
# the reference's FTZ mode (the plain versions flush where the kernels do;
# f64 is never flushed).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-ftz=true",
)

# Kernel launches per instance ("ppe<NR>", "striped<H>"); each wrapper adds
# one where it launches its kernel and nowhere else (chip_smoke.py and the
# CLI's --stats read these).  A launch of the ppe kernel's unique-rows
# entry (ops/pairhmm_front.py) also counts under its source,
# "ppe_front_<planes|packed|nib>", so "ppe<NR>" less those is the
# pair-minor entry's launches.  The genotyper kernel (ops/genotyper_cuda.py)
# counts here too, per instance ("genotype_f64", "genotype_f32").
LAUNCHES: Dict[str, int] = {
    **{f"ppe{nr}": 0 for nr in (1, 2, 4, 8)},
    **{f"striped{h}": 0 for h in (8, 16, 32)},
    **{f"ppe_front_{path}": 0 for path in ("planes", "packed", "nib")},
    "genotype_f64": 0,
    "genotype_f32": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_cache_dir = os.path.abspath(DEFAULT_CACHE_DIR)
# this process's outcome per library: {"status": "hit" | "built", "s": ...}
_record: Dict[str, Dict[str, object]] = {}
_record_lock = threading.Lock()
_nvcc_runs = 0  # nvcc processes this process started


def set_cache_dir(path: str) -> None:
    """Build and look up the libraries in ``path`` from now on (the
    libraries this process already loaded stay loaded)."""
    global _cache_dir
    _cache_dir = os.path.abspath(path)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def toolkit_identity() -> bytes:
    """What names the toolkit in a key, read without starting a process:
    the resolved nvcc's path, size and mtime, and the toolkit's
    version.json (beside nvcc's bin/) when there is one."""
    nvcc = os.path.realpath(nvcc_path())
    st = os.stat(nvcc)
    ident = f"{nvcc}\0{st.st_size}\0{st.st_mtime_ns}\0".encode()
    version = os.path.join(os.path.dirname(os.path.dirname(nvcc)),
                           "version.json")
    if os.path.exists(version):
        with open(version, "rb") as handle:
            ident += handle.read()
    return ident


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every local file it includes (``#include
    "..."``, followed recursively, relative to the including file)."""
    out: List[str] = []
    todo = [os.path.join(CSRC, name + ".cu")]
    while todo:
        path = os.path.normpath(todo.pop())
        if path in out:
            continue
        out.append(path)
        with open(path, "rb") as handle:
            text = handle.read()
        todo.extend(os.path.join(os.path.dirname(path), inc.decode())
                    for inc in _INCLUDE.findall(text))
    return out


def library_key(name: str) -> str:
    """The library's key: a hash of its sources, the flags and the toolkit."""
    digest = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as handle:
            digest.update(os.path.relpath(path, CSRC).encode() + b"\0")
            digest.update(handle.read())
    digest.update(b"\0".join(f.encode() for f in NVCC_FLAGS))
    digest.update(toolkit_identity())
    return digest.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to in the cache (content-, flag- and
    toolkit-addressed)."""
    return os.path.join(_cache_dir, f"lib{name}-{library_key(name)}.so")


def _note(name: str, status: str, seconds: float) -> None:
    with _record_lock:
        _record.setdefault(name, {"status": status, "s": round(seconds, 3)})


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already cached."""
    t0 = time.perf_counter()
    out = library_path(name)
    if os.path.exists(out):
        _note(name, "hit", time.perf_counter() - t0)
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out), prefix=f".{name}-",
                               suffix=".so")
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, os.path.join(CSRC, name + ".cu"),
               "-o", tmp]
        global _nvcc_runs
        with _record_lock:
            _nvcc_runs += 1
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _note(name, "built", time.perf_counter() - t0)
    return out


def build_all() -> Dict[str, str]:
    """Compile every kernel library at once (one nvcc per source, all
    started together) -> {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


def cache_report() -> Dict[str, object]:
    """This process's kernel cache: its directory, the nvcc processes it
    started and, per library built or looked up, ``hit`` or ``built`` (its
    first outcome in this process) and the seconds that took."""
    with _record_lock:
        return {
            "dir": _cache_dir,
            "nvcc_runs": _nvcc_runs,
            "libraries": {name: dict(rec) for name, rec in _record.items()},
        }


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process.  A
    library that fails to load raises with its path."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise RuntimeError(
                    f"cannot load the kernel library {path}: {exc} (remove "
                    "it to rebuild)") from exc
            _BINDERS[name](lib)
            _libs[name] = lib
    return lib


def _bind_pairhmm_ppe(lib: ctypes.CDLL) -> None:
    """The warp-per-pair kernel: no scratch argument, its DP state stays
    in registers and shared memory; ``k`` is the read rows per lane.  Two
    entries share its instances: pair-minor inputs, and a launch unit's
    unique rows described by a host array of segment rows."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    trans = [f, f, f, f, f, f]  # p_mm, p_gapm, p_mx, p_xx, p_my, p_yy
    fn = lib.pairhmm_ppe_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [
        vp, vp, vp, vp, vp,  # rows, hap, rlen, clen, init_y
        vp,  # out
        i, i, i, i,  # B, r_pad, c_pad, k
        *trans,
        vp,  # cudaStream_t
    ]
    fn = lib.pairhmm_ppe_forward_unique
    fn.restype = ctypes.c_int
    fn.argtypes = [
        i, vp, i,  # src, segment rows (host int64), segments
        vp, vp,  # 768 table, out
        i, i, i,  # r_pad, c_pad, k
        *trans,
        vp,  # cudaStream_t
    ]
    shape = lib.pairhmm_ppe_launch_shape
    shape.restype = ctypes.c_int
    shape.argtypes = [i, i, i, vp]  # r_pad, c_pad, k, int[3] out


def _bind_pairhmm_striped(lib: ctypes.CDLL) -> None:
    """The striped kernel: pair-major inputs, ``stripe`` lanes per pair and
    ``k`` read rows per lane."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.pairhmm_striped_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [
        vp, vp, vp, vp,  # read codes, omq, q3, hap codes
        vp, vp, vp,  # rlen, clen, init_y
        vp,  # out
        i, i, i, i, i,  # B, r_pad, c_pad, stripe, k
        f, f, f, f, f, f,  # p_mm, p_gapm, p_mx, p_xx, p_my, p_yy
        vp,  # cudaStream_t
    ]
    shape = lib.pairhmm_striped_launch_shape
    shape.restype = ctypes.c_int
    shape.argtypes = [i, i, i, i, vp]  # r_pad, c_pad, stripe, k, int[3] out


def _bind_genotyper(lib: ctypes.CDLL) -> None:
    """The genotyper's reductions over one padded site tile; ``f64``
    picks the <double> or <float> instance."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.genotype_sites
    fn.restype = ctypes.c_int
    fn.argtypes = [
        i,  # f64
        vp, vp, vp, vp, vp, vp,  # lik, hap_to_allele, keep, hap_valid, ac, jac
        vp, vp, vp,  # gl, best, gq
        i, i, i, i,  # S, R, H, max_gq
        ctypes.c_double,  # log10(2)
        vp,  # cudaStream_t
    ]


_BINDERS = {
    "pairhmm_ppe": _bind_pairhmm_ppe,
    "pairhmm_striped": _bind_pairhmm_striped,
    "genotyper": _bind_genotyper,
}
KERNELS = tuple(_BINDERS)
