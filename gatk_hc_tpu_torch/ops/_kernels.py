"""Build and ctypes binding of the package's CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc into a shared library with a plain C
interface, at first use, into ``gatk_hc_tpu_torch/_build/``.  The library's
file name carries a hash of the source and the flags, so an edited source
never loads a stale build, and the compile goes to a private temporary name
that os.replace moves into place (safe when several processes build at
once).  Nothing here runs at import time: a machine without nvcc or a card
imports the package and uses the kernels' plain PyTorch versions on CPU
tensors.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# -fmad=false: no mul+add contraction, f32 or f64 (bit-exactness vs the
# oracle and the host genotyper); -ftz=true: f32 results flush to zero like
# the reference's FTZ mode (the plain versions flush where the kernels do;
# f64 is never flushed).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-ftz=true",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (content- and flag-addressed)."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as handle:
        digest = hashlib.sha1(handle.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, os.path.join(CSRC, name + ".cu"),
               "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> Dict[str, str]:
    """Compile every kernel library at once (one nvcc per source, all
    started together) -> {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
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
