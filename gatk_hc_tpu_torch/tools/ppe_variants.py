"""Time variants of the ppe kernel's source on one card, in turns.

    python -m gatk_hc_tpu_torch.tools.ppe_variants [--reps N]

Builds csrc/pairhmm_ppe.cu as it is ("built") and with one detail changed
("warps2", "warps8": pairs per block; "unroll1", "unroll2": the step loop
unrolled once or twice at every K; "prefetch": the next step's hap mask
loaded one step ahead; "capture_predicated": row rlen's place in its lane
at run time, not one loop instance per place), each with the package's
nvcc flags, holds every variant bit for bit against the package's kernel
on seeded main-path-like pairs (chip_smoke.py's), and prints one JSON line
per case with each variant's median ms per launch, timed in the order
built, v1, ..., vn, vn, ..., v1, built.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

# (r_pad, c_pad, ppe_rows): rows per lane 3, 4, 5, 8, 6, 7, 5 and 8 with
# a carried row
CASES = ((96, 448, 1), (96, 448, 4), (160, 448, 4), (160, 448, 8),
         (192, 448, 4), (224, 512, 4), (160, 768, 4), (288, 448, 4))
LOOP = ("#pragma unroll(K <= 5 ? 2 : 1)\n"
        "  for (int step = 1; step <= steps; ++step) {\n"
        "    const int hw = hs[step];")
WARPS = "constexpr int MAX_WARPS = 4;"
# row rlen's place in its lane as a runtime value, its capture adds
# predicated in every row, instead of one loop instance per place
CAPTURE = (
    ("float& acc_m, float& acc_x) {\n  float md[K]",
     "float& acc_m, float& acc_x, int qc = 0) {\n  float md[K]"),
    ("      if (q == QC) {", "      if (q == qc) {"),
    ("    sweep_at<K, CARRY>(qc, hs, rs, omq, q3, cm, cx, cy, s > 0, more, "
     "steps,\n                       cl, lane, iy, tr, acc_m, acc_x);",
     "    sweep<K, 0, CARRY>(hs, rs, omq, q3, cm, cx, cy, s > 0, more, "
     "steps,\n                       cl, lane, iy, tr, acc_m, acc_x, qc);"),
)


def variants(source: str):
    """{name: source} of every variant."""
    varied = [WARPS, LOOP] + [old for old, _ in CAPTURE]
    if any(source.count(text) != 1 for text in varied):
        raise RuntimeError("pairhmm_ppe.cu no longer has the varied lines")
    pragma = LOOP.split("\n")[0]
    predicated = source
    for old, new in CAPTURE:
        predicated = predicated.replace(old, new)
    return {
        "built": source,
        "warps2": source.replace(WARPS, "constexpr int MAX_WARPS = 2;"),
        "warps8": source.replace(WARPS, "constexpr int MAX_WARPS = 8;"),
        "unroll1": source.replace(pragma, "#pragma unroll 1"),
        "unroll2": source.replace(pragma, "#pragma unroll 2"),
        # the next step's hap mask loaded one step ahead (slot c_pad + 63
        # at most)
        "prefetch": source.replace(LOOP, (
            "int hw_next = hs[1];\n" + LOOP.replace(
                "const int hw = hs[step];",
                "const int hw = hw_next;\n    hw_next = hs[step + 1];"))),
        "capture_predicated": predicated,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ppe_variants: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.ops import _kernels
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt

    with open(os.path.join(_kernels.CSRC, "pairhmm_ppe.cu")) as handle:
        sources = variants(handle.read())
    libs = {}
    with tempfile.TemporaryDirectory(prefix="ppe_variants_") as tmp:
        procs = {}
        for name, source in sources.items():  # one nvcc each, together
            path = os.path.join(tmp, name + ".cu")
            with open(path, "w") as handle:
                handle.write(source)
            procs[name] = subprocess.Popen(
                [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, path, "-o",
                 os.path.join(tmp, f"lib{name}.so")])
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for variant {name}")
            libs[name] = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
            _kernels._BINDERS["pairhmm_ppe"](libs[name])

    trans = pt.transition_constants(DEFAULT_CONFIG.gop_char,
                                    DEFAULT_CONFIG.gcp_char)
    rng = np.random.default_rng(20261017)
    B = 65536
    print(cs.nvidia_smi(), flush=True)
    for r_pad, c_pad, nr in CASES:
        inputs = cs.kernel_inputs(*cs.make_pairs(rng, B, r_pad, c_pad), "cuda")
        k = pt.rows_per_lane(pt.select_rows(nr, r_pad), r_pad)
        want = pt.ppe_forward(*inputs, trans, nr)

        def launch(lib):
            out = torch.empty(B, dtype=torch.float32, device="cuda")
            err = lib.pairhmm_ppe_forward(
                *(a.data_ptr() for a in inputs), out.data_ptr(), B, r_pad,
                c_pad, k, *(float(t) for t in trans),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out

        for name, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"variant {name} differs at {r_pad, c_pad}")
        ms = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            ms[name].append(cs.time_ms(lambda: launch(libs[name]), args.reps))
        print(json.dumps({"r_pad": r_pad, "c_pad": c_pad, "B": B, "ppe_rows": nr,
                          "rows_per_lane": k, "bit_equal": True, "ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
