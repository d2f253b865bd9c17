"""Where a run ran on its host: the card's place on the PCI bus and its
NUMA node, this process's CPUs, and what its threads did in the window.

Everything is read from sysfs and procfs, for this process alone, except
the cards' bus ids, which ``nvidia-smi`` gives.  Nothing here imports
torch, so that ``run.py`` can bind the process before it does:

* ``place`` finds the node of each card the run uses
  (``/sys/bus/pci/devices/<bus id>/numa_node``) and the CPUs local to it
  (``local_cpulist``), and what the process may run on now;
* ``bind`` narrows the process to those CPUs (``os.sched_setaffinity``),
  as a deployment does with ``numactl --cpunodebind`` or the affinity
  ``nvidia-smi topo -m`` prints.  Threads made later inherit it, and the
  pinned host buffers, first touched by them, land on that node.  It never
  widens an affinity set narrower, and does nothing where sysfs names no
  node (one socket, or ``-1``);
* ``snapshot`` at the window's start and end, and ``window`` between two
  of them: load, clock, steal, context switches, and per thread its name,
  the CPU it last ran on (``/proc/self/task/<tid>/stat`` field 39), its
  CPU seconds and its seconds waiting for a CPU (``schedstat``).
"""

from __future__ import annotations

import glob
import os
import resource
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence

SYS = "/sys"
PROC = "/proc"


def parse_cpulist(text: str) -> List[int]:
    """A kernel CPU list (``0-27,56-83``, ``3``, or empty) -> its CPUs."""
    cpus: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.extend(range(int(lo), int(hi or lo) + 1))
    return sorted(set(cpus))


def format_cpulist(cpus: Iterable[int]) -> str:
    """The inverse of ``parse_cpulist``: runs as ``lo-hi``."""
    runs: List[List[int]] = []
    for c in sorted(set(cpus)):
        if runs and runs[-1][1] == c - 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(f"{a}" if a == b else f"{a}-{b}" for a, b in runs)


def sysfs_bus_id(bus_id: str) -> str:
    """``nvidia-smi``'s ``00000000:18:00.0`` -> sysfs's ``0000:18:00.0``:
    a 4-digit PCI domain, lower case."""
    domain, rest = bus_id.strip().split(":", 1)
    return f"{int(domain, 16):04x}:{rest.lower()}"


def card_bus_ids(count: int) -> List[str]:
    """The sysfs bus ids of the first ``count`` cards ``nvidia-smi`` lists
    (of ``CUDA_VISIBLE_DEVICES`` where it is set); [] without it, and
    none for a card whose bus it does not show."""
    cmd = ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"]
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    if visible:
        cmd += ["-i", visible]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    ids = []
    for line in out.split()[:count]:
        try:
            ids.append(sysfs_bus_id(line))
        except ValueError:  # "[N/A]": the card's bus is not shown
            pass
    return ids


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as handle:
            return handle.read()
    except OSError:
        return None


def card_node(bus_id: str, sys_root: str = SYS):
    """-> (numa node, its local CPUs) of one card; (None, []) where sysfs
    has no such device or names no node (``-1``)."""
    dev = os.path.join(sys_root, "bus", "pci", "devices", bus_id)
    node = _read(os.path.join(dev, "numa_node"))
    if node is None or int(node) < 0:
        return None, []
    cpus = parse_cpulist(_read(os.path.join(dev, "local_cpulist")) or "")
    return int(node), cpus


def place(bus_ids: Sequence[str], affinity: Iterable[int],
          sys_root: str = SYS) -> Dict:
    """The cards' nodes and local CPUs, the process's affinity, and the
    binding to make: ``bound_cpus``, the cards' local CPUs within the
    affinity, and their ``bound_nodes``; both None where a card shows no
    node or none of its CPUs is allowed, so that a binding never widens."""
    nodes, local = [], set()
    for bus_id in bus_ids:
        node, cpus = card_node(bus_id, sys_root)
        nodes.append(node)
        local.update(cpus)
    allowed = sorted(affinity)
    bind_to = sorted(local & set(allowed))
    known = bool(nodes) and None not in nodes and bool(bind_to)
    return {
        "bus_ids": list(bus_ids),
        "numa_nodes": nodes,
        "local_cpulist": format_cpulist(local),
        "affinity": format_cpulist(allowed),
        "bound_cpus": format_cpulist(bind_to) if known else None,
        "bound_nodes": sorted(set(nodes)) if known else None,
    }


def bind(where: Dict) -> Dict:
    """Narrow this process to ``where["bound_cpus"]``, if any -> where."""
    if where["bound_cpus"] is not None:
        os.sched_setaffinity(0, parse_cpulist(where["bound_cpus"]))
    return where


def _task(task_dir: str, names: Dict[int, str]) -> Optional[Dict]:
    stat = _read(os.path.join(task_dir, "stat"))
    if stat is None:
        return None  # the thread ended
    name = names.get(int(os.path.basename(task_dir)),
                     stat[stat.index("(") + 1:stat.rindex(")")])
    rest = stat.rsplit(")", 1)[1].split()  # rest[k] is field k + 3
    tick = os.sysconf("SC_CLK_TCK")
    out = {"name": name, "cpu": int(rest[36]),
           "cpu_s": (int(rest[11]) + int(rest[12])) / tick}
    sched = (_read(os.path.join(task_dir, "schedstat")) or "").split()
    if len(sched) >= 2:
        out["wait_s"] = int(sched[1]) / 1e9
    for line in (_read(os.path.join(task_dir, "status")) or "").splitlines():
        key, _, value = line.partition(":")
        if key == "nonvoluntary_ctxt_switches":
            out["niv_cs"] = int(value)
    return out


def _steal_s(stat: str, cpus: Sequence[int]) -> float:
    """Summed steal time (field 8 of each ``cpuN`` line) of ``cpus``."""
    want = {f"cpu{c}" for c in cpus}
    ticks = sum(int(f[8]) for f in (line.split() for line in
                                    stat.splitlines())
                if f and f[0] in want and len(f) > 8)
    return ticks / os.sysconf("SC_CLK_TCK")


def _mhz(cpuinfo: str, cpus: Sequence[int]) -> Optional[float]:
    """Mean ``cpu MHz`` of ``cpus`` in ``/proc/cpuinfo``."""
    cpu, got = None, []
    for line in cpuinfo.splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        if key == "processor":
            cpu = int(value)
        elif key == "cpu MHz" and cpu in cpus:
            got.append(float(value))
    return sum(got) / len(got) if got else None


def snapshot(proc_root: str = PROC) -> Dict:
    """This process and its threads now, each thread that Python started
    by its Python name (the kernel's is the program's)."""
    self_dir = os.path.join(proc_root, "self")
    cpus = sorted(os.sched_getaffinity(0))
    ru = resource.getrusage(resource.RUSAGE_SELF)
    names = {t.native_id: t.name for t in threading.enumerate()}
    threads = {}
    for task_dir in glob.glob(os.path.join(self_dir, "task", "*")):
        t = _task(task_dir, names)
        if t is not None:
            threads[os.path.basename(task_dir)] = t
    return {
        "loadavg": (_read(os.path.join(proc_root, "loadavg"))
                    or "").split()[:3],
        "cpu_mhz": _mhz(_read(os.path.join(proc_root, "cpuinfo")) or "",
                        cpus),
        "steal_s": _steal_s(_read(os.path.join(proc_root, "stat")) or "",
                            cpus),
        "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw,
        "minflt": ru.ru_minflt,
        "threads": threads,
    }


def window(start: Dict, end: Dict) -> Dict:
    """What changed between two snapshots: load and clock at both ends,
    steal, the process's context switches and page faults, and per thread
    alive at both ends its name, last CPU, and the window's CPU seconds,
    seconds waiting for a CPU and involuntary switches."""
    threads = []
    for tid, t in sorted(end["threads"].items(), key=lambda kv: int(kv[0])):
        t0 = start["threads"].get(tid)
        if t0 is None:
            continue
        row = {"tid": int(tid), "name": t["name"], "cpu": t["cpu"],
               "cpu_s": t["cpu_s"] - t0["cpu_s"]}
        for key in ("wait_s", "niv_cs"):
            if key in t and key in t0:
                row[key] = t[key] - t0[key]
        threads.append(row)
    return {
        "loadavg": [start["loadavg"], end["loadavg"]],
        "cpu_mhz": [start["cpu_mhz"], end["cpu_mhz"]],
        "steal_s": end["steal_s"] - start["steal_s"],
        "voluntary_cs": end["nvcsw"] - start["nvcsw"],
        "involuntary_cs": end["nivcsw"] - start["nivcsw"],
        "minor_faults": end["minflt"] - start["minflt"],
        "threads": threads,
    }
