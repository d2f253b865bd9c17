"""The kernel libraries' build from an empty cache, for one or more
checkouts, in turns, and their machine code compared function by function.

    python -m gatk_hc_tpu_torch.tools.build_compare \\
        [--tree parent=DIR] [--tree change=.] [--out FILE]

Every library of each tree is built (its ops/_kernels.py ``build_all``:
one nvcc per source or per translation unit, all started together) into
a new empty cache directory, in a fresh process per build, trees forward
then backward (parent, change, change, parent for two trees).  One JSON line per build: the tree, the wall of
``build_all`` and each library's seconds from the tree's cache record.
Then, for each library, the kernels' machine code (``cuobjdump -sass``
of the first build of each tree) split by function and compared with the
first tree's: the functions each tree holds and those whose code differs
(with the first differing lines of one of them).
The last line is a summary: per tree and library the median seconds, and
whether every tree holds the same functions with the same code.

The card's name and power limit (nvidia-smi) lead.  Needs nvcc; builds
need no card, but the times are taken on the machine that runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from typing import Dict, List

_WORKER = """\
import json, sys, time
sys.path.insert(0, {tree!r})
from gatk_hc_tpu_torch.ops import _kernels
_kernels.set_cache_dir({cache!r})
t0 = time.perf_counter()
paths = _kernels.build_all()
s = time.perf_counter() - t0
report = _kernels.cache_report()
print(json.dumps({{"build_all_s": round(s, 3), "paths": paths,
                  "nvcc_runs": report["nvcc_runs"],
                  "libraries": report["libraries"]}}))
"""


def build_once(tree: str, cache: str) -> Dict[str, object]:
    """Every library of ``tree`` built into the empty directory ``cache``
    by a fresh process -> its report."""
    proc = subprocess.run(
        [sys.executable, "-c", _WORKER.format(tree=tree, cache=cache)],
        cwd=tree, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"build in {tree} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# the name of a source's anonymous namespace, which hashes the path it was
# compiled from (and so differs between checkouts and units)
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_[0-9a-f]{8}")


def sass_by_function(lib: str) -> Dict[str, str]:
    """{mangled function name: its SASS text} of a kernel library, with
    anonymous namespaces' names and the column padding made alike."""
    from ..ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    text = _ANON.sub("_GLOBAL__N_", subprocess.run(
        [tool, "-sass", lib], capture_output=True, text=True, check=True,
        timeout=300).stdout)
    out: Dict[str, List[str]] = {}
    fn = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = out.setdefault(m.group(1), [])
        elif fn is not None and line.strip().startswith("/*"):
            # cuobjdump pads its columns to the file's longest line
            fn.append(" ".join(line.split()))
    return {name: "\n".join(lines) for name, lines in out.items()}


def compare_code(libs: Dict[str, str]) -> Dict[str, object]:
    """The functions of each tree's library against the first tree's."""
    code = {tree: sass_by_function(path) for tree, path in libs.items()}
    first, *rest = code
    row = {"functions": {tree: len(fns) for tree, fns in code.items()}}
    for tree in rest:
        names = set(code[tree]) | set(code[first])
        row[tree] = {
            "missing": sorted(set(code[first]) - set(code[tree])),
            "extra": sorted(set(code[tree]) - set(code[first])),
            "differ": sorted(n for n in names if n in code[tree]
                             and n in code[first]
                             and code[tree][n] != code[first][n]),
        }
        if row[tree]["differ"]:  # the first lines that differ, of one
            name = row[tree]["differ"][0]
            pairs = zip(code[first][name].splitlines(),
                        code[tree][name].splitlines())
            row[tree]["first_lines_differing"] = [
                p for p in pairs if p[0] != p[1]][:4]
    row["identical"] = all(
        not (row[tree]["missing"] or row[tree]["extra"]
             or row[tree]["differ"]) for tree in rest)
    return row


def main(argv=None) -> int:
    from ._timing import nvidia_smi

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of a checkout (default: change=.)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree) or {"change": "."}
    trees = {name: os.path.abspath(path) for name, path in trees.items()}
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    print(nvidia_smi(), flush=True)
    turns = list(trees) + list(trees)[::-1]
    runs: Dict[str, List[Dict[str, object]]] = {name: [] for name in trees}
    with tempfile.TemporaryDirectory(prefix="build_compare_") as tmp:
        for i, name in enumerate(turns):
            cache = os.path.join(tmp, f"{i}-{name}")
            rep = build_once(trees[name], cache)
            runs[name].append(rep)
            emit({"tree": name, "turn": i, "build_all_s": rep["build_all_s"],
                  "nvcc_runs": rep["nvcc_runs"],
                  "libraries": {lib: rec["s"] for lib, rec
                                in rep["libraries"].items()}})
        libs = sorted(set().union(*(runs[n][0]["paths"] for n in trees)))
        code = {}
        for lib in libs:
            code[lib] = compare_code({n: runs[n][0]["paths"][lib]
                                      for n in trees
                                      if lib in runs[n][0]["paths"]})
            emit({"library": lib, **code[lib]})
    summary = {
        "summary": {
            name: {"build_all_s": statistics.median(
                       r["build_all_s"] for r in reps),
                   **{lib: statistics.median(
                       r["libraries"][lib]["s"] for r in reps)
                      for lib in reps[0]["libraries"]}}
            for name, reps in runs.items()},
        "code_identical": {lib: row["identical"] for lib, row in code.items()},
    }
    emit(summary)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
