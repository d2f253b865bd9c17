"""Persistent kernel cache: where the CUDA kernel libraries are built and
found (ops/_kernels.py).

The counterpart of gatk_hc_tpu/parallel/compile_cache.py.  nvcc takes tens
of seconds per source; the cache makes every later process on the same
sources, flags and toolkit load the libraries at once
(tools/warm_cache.py fills it ahead of a run).  Its entries are keyed on
those inputs, so one directory is safe across versions of the sources.
GATK_HC_TPU_TORCH_KERNEL_CACHE moves it, e.g. off a read-only install;
by default it is the package's own ``_build/`` directory.
"""

from __future__ import annotations

import os

CACHE_ENV = "GATK_HC_TPU_TORCH_KERNEL_CACHE"
DEFAULT_CACHE_DIR = os.environ.get(
    CACHE_ENV,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "_build"),
)


def enable_compile_cache(cache_dir: str = DEFAULT_CACHE_DIR) -> None:
    """Build and look up the kernel libraries in ``cache_dir`` (created at
    the first build)."""
    from ..ops import _kernels

    _kernels.set_cache_dir(cache_dir)
