"""State carried across from the reference package.

The system has no weights: its "parameters" are the configuration and the
numeric context (quality and base tables, the plane tables the kernel reads,
the transition constants).  Both packages must agree on them exactly for
their outputs to be byte-identical, so this module takes the reference
package's values as plain Python/numpy data (it imports nothing of it) and
returns the port's own objects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .config import HCConfig, SWParameters
from .ops.pairhmm_torch import TABLE_KEYS, plane_tables

# Reference HCConfig keys that only steer the TPU build: pair_batch is the
# lane width of a TPU tile, which the CUDA kernels do not have.  It is
# dropped by name; the dispatch keys (dispatch_mode, packed_nib,
# fuse_groups, fuse_auto, device_timeout_s) are carried across.
TPU_ONLY_KEYS = ("pair_batch",)

# Reference engine names -> the port's.  "pallas" is the device kernel
# engine on either side, "jax" the anti-diagonal jnp engine ("diag" here),
# "shardmap" the sharded step over a device grid on both; "auto" (a CLI
# choice, resolved before a config exists) is not ported.  The reference's
# device genotyper "jax" is the port's "cuda" genotyper.
_ENGINES = {"pallas": "cuda", "jax": "diag", "native": "native",
            "python": "python", "shardmap": "shardmap"}
_GENOTYPERS = {"host": "host", "jax": "cuda"}


def config_from_reference(d: Mapping[str, object]) -> HCConfig:
    """``dataclasses.asdict`` of the reference HCConfig -> the port's
    HCConfig.  Drops TPU_ONLY_KEYS, maps the engine names, and raises on
    any key it does not know and on settings that are not ported."""
    fields = {f.name for f in dataclasses.fields(HCConfig)}
    unknown = sorted(set(d) - fields - set(TPU_ONLY_KEYS))
    if unknown:
        raise ValueError(f"unknown reference config keys: {unknown}")
    kwargs = {k: v for k, v in d.items() if k in fields}
    engine = kwargs.get("pairhmm_engine")
    if engine is not None:
        if engine not in _ENGINES:
            raise NotImplementedError(
                f"pairhmm engine {engine!r} is not ported yet"
            )
        kwargs["pairhmm_engine"] = _ENGINES[engine]
    genotyper = kwargs.get("genotyper_engine")
    if genotyper is not None:
        if genotyper not in _GENOTYPERS:
            raise NotImplementedError(
                f"genotyper engine {genotyper!r} is not ported"
            )
        kwargs["genotyper_engine"] = _GENOTYPERS[genotyper]
    if isinstance(kwargs.get("sw_params"), Mapping):
        kwargs["sw_params"] = SWParameters(**kwargs["sw_params"])
    for key in ("read_pad_buckets", "hap_pad_buckets"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    return HCConfig(**kwargs)


def tables_from_reference(
    arrays: Mapping[str, np.ndarray], device
) -> Dict[str, torch.Tensor]:
    """The reference's numeric context -> the port's device tables (the
    ops/pairhmm_torch.py::make_tables layout).

    ``arrays`` holds ``PH2PR_F32``, ``BASE_TABLE``, the three plane tables
    ``mask``, ``omq_bits``, ``q3_bits`` (pairhmm_pallas.plane_tables) and
    the six transition constants as ``trans``.  The plane tables must be
    the ones these PH2PR/BASE tables imply, bit for bit: a mismatch means
    the two packages would not compute the same likelihoods, and raises."""
    expected = {"PH2PR_F32", "BASE_TABLE", "mask", "omq_bits", "q3_bits", "trans"}
    if set(arrays) != expected:
        raise ValueError(
            f"expected keys {sorted(expected)}, got {sorted(arrays)}"
        )
    ph2pr = np.asarray(arrays["PH2PR_F32"])
    base = np.asarray(arrays["BASE_TABLE"])
    if ph2pr.dtype != np.float32 or base.shape != (256,):
        raise ValueError("PH2PR_F32 must be float32 and BASE_TABLE (256,)")
    trans = np.asarray(arrays["trans"], dtype=np.float64)
    if trans.shape != (6,) or not np.array_equal(
        trans, trans.astype(np.float32).astype(np.float64)
    ):
        raise ValueError("trans must be six float32-representable values")
    derived = plane_tables(base, ph2pr)
    for name, table in zip(("mask", "omq_bits", "q3_bits"), derived):
        given = np.asarray(arrays[name])
        if given.dtype != np.int32 or not np.array_equal(given, table):
            raise ValueError(f"plane table {name!r} does not match PH2PR/BASE")
    out = {
        "base_table": base.astype(np.int32),
        "ph2pr": ph2pr,
        "mask": derived[0],
        "omq_bits": derived[1],
        "q3_bits": derived[2],
        "trans": trans.astype(np.float32),
    }
    return {
        k: torch.from_numpy(np.ascontiguousarray(out[k])).to(device)
        for k in TABLE_KEYS
    }
