"""Time variants of a PairHMM kernel's source on one card, in turns.

    python -m gatk_hc_tpu_torch.tools.ppe_variants [--kernel ppe|striped]
                                                   [--reps N]

Builds the kernel's source as it is ("built") and with one detail changed,
each with the package's nvcc flags (one nvcc per variant, started
together), holds every variant bit for bit against the package's ppe
kernel on seeded main-path-like pairs (chip_smoke.py's), and prints one
JSON line per case with each variant's median ms per launch, timed in the
order built, v1, ..., vn, vn, ..., v1, built.  A first line per variant
gives its most registers per instance and its local memory and stack
(cuobjdump).  Needs one card.

csrc/pairhmm_ppe.cu ("ppe", the default): "warps2", "warps8" (pairs per
block); "unroll1", "unroll2" (the step loop unrolled once or twice at
every K); "prefetch" (the next step's hap mask loaded one step ahead);
"capture_predicated" (row rlen's place in its lane at run time, not one
loop instance per place).

csrc/pairhmm_striped.cu ("striped"): "kmax8" ... "kmax28" (the most rows
per lane at H 16 and 8, so K and the stripes change with it);
"min_rule" (the same source run at K = min(KMAX, r_pad / H), which fills
the last stripe only in part, instead of the package's rule); "warps2",
"warps8" (warps per block); "unroll1", "unroll2" (the step loop at every
H and K); "capture_select" (at H < 32, row qc's cell selected in every row
and added once per step, instead of the predicated adds).  Every variant
is also held against the ppe kernel (ppe_rows 4) on the same pairs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

# (r_pad, c_pad, ppe_rows): rows per lane 3, 4, 5, 8, 6, 7, 5 and 8 with
# a carried row
CASES = ((96, 448, 1), (96, 448, 4), (160, 448, 4), (160, 448, 8),
         (192, 448, 4), (224, 512, 4), (160, 768, 4), (288, 448, 4))
# (r_pad, c_pad, stripe height): the bucket r_pads at every H, reads
# longer than 256 rows (a carried row at H 32 and 8), and K 6 and 8 at H 32
STRIPED_CASES = tuple((r, 448, h) for h in (32, 16, 8)
                      for r in (96, 160, 224, 288)) + ((192, 448, 32),
                                                       (256, 448, 32))
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
STRIPED_LOOP = "#pragma unroll((H < 32 ? !(CARRY && K >= 19) : K <= (CARRY ? 5 : 7)) ? 2 : 1)"
STRIPED_KMAX = r"constexpr int KMAX_(16|8) = \d+;"  # the KMAX of H 16 and 8
# at H < 32: select row qc's cell in the row loop and add it once per step
# (predicated on the step), instead of predicated adds in every row
STRIPED_CAPTURE = (
    ("      if (QC >= 0 ? q == QC : q == qc && step <= cap_lim) {\n"
     "        acc_m = __fadd_rn(acc_m, M);\n"
     "        acc_x = __fadd_rn(acc_x, X);\n      }",
     "      if (QC >= 0 && q == QC) {\n"
     "        acc_m = __fadd_rn(acc_m, M);\n"
     "        acc_x = __fadd_rn(acc_x, X);\n"
     "      } else if (QC < 0 && q == qc) {\n"
     "        mc = M;\n        xc = X;\n      }"),
    ("#pragma unroll\n    for (int q = 0; q < K; ++q) {\n      const float dist",
     "    float mc = 0.0f, xc = 0.0f;\n"
     "#pragma unroll\n    for (int q = 0; q < K; ++q) {\n      const float dist"),
    ("    mo = MA;\n    xo = XA;\n    yo = YA;\n    if (CARRY && step >= H",
     "    if (QC < 0 && step <= cap_lim) {\n"
     "      acc_m = __fadd_rn(acc_m, mc);\n"
     "      acc_x = __fadd_rn(acc_x, xc);\n    }\n"
     "    mo = MA;\n    xo = XA;\n    yo = YA;\n    if (CARRY && step >= H"),
)


def _check(source: str, varied, kernel: str) -> None:
    if any(source.count(text) != 1 for text in varied):
        raise RuntimeError(f"{kernel} no longer has the varied lines")


def variants(source: str):
    """{name: source} of every variant of csrc/pairhmm_ppe.cu."""
    _check(source, [WARPS, LOOP] + [old for old, _ in CAPTURE],
           "pairhmm_ppe.cu")
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


def striped_variants(source: str):
    """{name: source} of every variant of csrc/pairhmm_striped.cu."""
    _check(source, [WARPS, STRIPED_LOOP]
           + [old for old, _ in STRIPED_CAPTURE], "pairhmm_striped.cu")
    if len(re.findall(STRIPED_KMAX, source)) != 2:
        raise RuntimeError("pairhmm_striped.cu no longer has the varied lines")

    def kmax(k):
        return re.sub(STRIPED_KMAX, rf"constexpr int KMAX_\1 = {k};", source)

    select = source
    for old, new in STRIPED_CAPTURE:
        select = select.replace(old, new)
    return {
        "built": source,
        **{f"kmax{k}": kmax(k) for k in (8, 12, 16, 20, 24, 28)
           if k != source_kmax(source, 8)},
        "min_rule": source,  # the same library, another K (variant_rows)
        "warps2": source.replace(WARPS, "constexpr int MAX_WARPS = 2;"),
        "warps8": source.replace(WARPS, "constexpr int MAX_WARPS = 8;"),
        "unroll1": source.replace(STRIPED_LOOP, "#pragma unroll 1"),
        "unroll2": source.replace(STRIPED_LOOP, "#pragma unroll 2"),
        "capture_select": select,
    }


def variant_rows(name: str, source: str, stripe: int, r_pad: int) -> int:
    """K that a striped variant runs at (stripe, r_pad): the package's rule
    (ops/pairhmm_striped.py::striped_rows_per_lane) under the variant's
    KMAX, or for "min_rule" min(KMAX, r_pad / stripe), which the source's
    carry instances (K > KMAX / 2) also cover."""
    from gatk_hc_tpu_torch.ops.pairhmm_striped import striped_rows_per_lane

    kmax = source_kmax(source, stripe)
    if name == "min_rule":
        return min(kmax, -(-r_pad // stripe))
    return striped_rows_per_lane(stripe, r_pad, kmax)


def source_kmax(source: str, stripe: int) -> int:
    """KMAX of stripe height ``stripe`` in a striped source."""
    return int(re.search(rf"constexpr int KMAX_{stripe} = (\d+);",
                         source).group(1))


def build_variants(sources, binder: str, tmp: str):
    """Compile every distinct source (one nvcc each, started together) ->
    {name: loaded and bound library}; variants with the same source share
    one library."""
    from gatk_hc_tpu_torch.ops import _kernels

    first = {}  # source -> the first variant's name
    procs = {}
    for name, source in sources.items():
        if source in first:
            continue
        first[source] = name
        path = os.path.join(tmp, name + ".cu")
        with open(path, "w") as handle:
            handle.write(source)
        procs[name] = subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, path, "-o",
             os.path.join(tmp, f"lib{name}.so")])
    built = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name}")
        built[name] = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        _kernels._BINDERS[binder](built[name])
    return {name: built[first[source]] for name, source in sources.items()}


def compare_and_time(libs, launch, want, where, reps: int):
    """Every variant bit for bit against ``want`` (raises on a
    difference), then each timed in turns -> {name: [ms, ms]}."""
    import torch

    import chip_smoke as cs

    for name, lib in libs.items():
        got = launch(name, lib)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"variant {name} differs at {where}")
    ms = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        ms[name].append(cs.time_ms(lambda: launch(name, libs[name]), reps))
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("ppe", "striped"), default="ppe")
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
    from gatk_hc_tpu_torch.ops import pairhmm_striped as ps
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt

    binder = f"pairhmm_{args.kernel}"
    with open(os.path.join(_kernels.CSRC, binder + ".cu")) as handle:
        source = handle.read()
    sources = (variants if args.kernel == "ppe" else striped_variants)(source)
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
        libs = build_variants(sources, binder, tmp)
        for name, lib in libs.items():
            report = cs.instance_report(_kernels, lib._name).values()
            print(json.dumps({"variant": name, "max_reg": max(
                r.get("reg", 0) for r in report), "local": max(
                r.get("local", 0) for r in report), "stack": max(
                r.get("stack", 0) for r in report)}), flush=True)

    trans = pt.transition_constants(DEFAULT_CONFIG.gop_char,
                                    DEFAULT_CONFIG.gcp_char)
    floats = [float(t) for t in trans]
    rng = np.random.default_rng(20261017)
    print(cs.nvidia_smi(), flush=True)
    if args.kernel == "ppe":
        B = 65536
        for r_pad, c_pad, nr in CASES:
            inputs = cs.kernel_inputs(*cs.make_pairs(rng, B, r_pad, c_pad),
                                      "cuda")
            k = pt.rows_per_lane(pt.select_rows(nr, r_pad), r_pad)

            def launch(name, lib):
                out = torch.empty(B, dtype=torch.float32, device="cuda")
                err = lib.pairhmm_ppe_forward(
                    *(a.data_ptr() for a in inputs), out.data_ptr(), B, r_pad,
                    c_pad, k, *floats, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return out

            ms = compare_and_time(libs, launch, pt.ppe_forward(*inputs, trans, nr),
                                  (r_pad, c_pad), args.reps)
            print(json.dumps({"r_pad": r_pad, "c_pad": c_pad, "B": B,
                              "ppe_rows": nr, "rows_per_lane": k,
                              "bit_equal": True, "ms": ms}), flush=True)
        return 0
    for r_pad, c_pad, h in STRIPED_CASES:
        B = 16384 if r_pad > 256 else 65536
        pairs = cs.make_pairs(rng, B, r_pad, c_pad)
        sargs = cs.striped_inputs(*pairs, "cuda")
        # rows per lane under each variant's KMAX
        ks = {name: variant_rows(name, sources[name], h, r_pad) for name in libs}

        def launch(name, lib):
            out = torch.empty(B, dtype=torch.float32, device="cuda")
            err = lib.pairhmm_striped_forward(
                *(a.data_ptr() for a in sargs), out.data_ptr(), B, r_pad, c_pad,
                h, ks[name], *floats, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out

        want = pt.ppe_forward(*cs.kernel_inputs(*pairs, "cuda"), trans, 4)
        ms = compare_and_time(libs, launch, want, (r_pad, c_pad, h), args.reps)
        print(json.dumps({"r_pad": r_pad, "c_pad": c_pad, "B": B, "stripe": h,
                          "rows_per_lane": ks, "built_shape":
                          ps.launch_shape(r_pad, c_pad, h),
                          "bit_equal_ppe4": True, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
