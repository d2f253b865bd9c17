"""Where a run ran: sysfs and procfs read from fake trees under tmp_path,
and the binding's rule, without touching this process's affinity."""

import os

import pytest

from hcbench import host

BUS = "0000:18:00.0"


def fake_sys(root, node="0\n", cpulist="0-27,56-83\n", bus=BUS):
    dev = root / "bus" / "pci" / "devices" / bus
    dev.mkdir(parents=True)
    (dev / "numa_node").write_text(node)
    (dev / "local_cpulist").write_text(cpulist)
    return str(root)


@pytest.mark.parametrize("text, cpus", [
    ("0-27,56-83\n", list(range(28)) + list(range(56, 84))),
    ("3\n", [3]),
    ("", []),
    ("\n", []),
    ("5,1-2", [1, 2, 5]),
])
def test_cpulist_forms(text, cpus):
    assert host.parse_cpulist(text) == cpus
    assert host.parse_cpulist(host.format_cpulist(cpus)) == cpus


def test_format_cpulist_runs():
    assert host.format_cpulist([0, 1, 2, 3, 7, 9, 10]) == "0-3,7,9-10"
    assert host.format_cpulist([]) == ""


@pytest.mark.parametrize("smi, sysfs", [
    ("00000000:18:00.0", "0000:18:00.0"),
    ("00000000:9A:00.0\n", "0000:9a:00.0"),
    ("00000001:C3:00.1", "0001:c3:00.1"),
])
def test_bus_id_mapping(smi, sysfs):
    assert host.sysfs_bus_id(smi) == sysfs


def test_binds_to_the_cards_local_cpus(tmp_path):
    where = host.place([BUS], range(112), fake_sys(tmp_path))
    assert where == {"bus_ids": [BUS], "numa_nodes": [0],
                     "local_cpulist": "0-27,56-83", "affinity": "0-111",
                     "bound_cpus": "0-27,56-83", "bound_nodes": [0]}


@pytest.mark.parametrize("node", ["-1\n", None])
def test_no_binding_without_a_node(tmp_path, node):
    """sysfs names no node (-1, one socket), or has no such device."""
    root = (fake_sys(tmp_path, node=node) if node is not None
            else str(tmp_path))
    where = host.place([BUS], range(8), root)
    assert where["numa_nodes"] == [None] and where["bound_cpus"] is None
    assert where["local_cpulist"] == "" and where["affinity"] == "0-7"


def test_no_binding_without_a_card(tmp_path):
    where = host.place([], range(8), fake_sys(tmp_path))
    assert where["bound_cpus"] is None and where["numa_nodes"] == []
    assert where["bound_nodes"] is None


@pytest.mark.parametrize("affinity, bound", [
    ({2, 3, 60}, "2-3,60"),  # set narrower: never widened
    ({28, 29}, None),  # none of the card's CPUs allowed: left as it is
])
def test_binding_never_widens(tmp_path, affinity, bound):
    where = host.place([BUS], affinity, fake_sys(tmp_path))
    assert where["bound_cpus"] == bound
    if bound:
        assert set(host.parse_cpulist(bound)) <= affinity


def test_two_cards_bind_to_both_nodes(tmp_path):
    root = fake_sys(tmp_path)
    fake_sys(tmp_path, node="1\n", cpulist="28-55\n", bus="0000:9a:00.0")
    where = host.place([BUS, "0000:9a:00.0"], range(84), root)
    assert where["numa_nodes"] == [0, 1]
    assert where["bound_cpus"] == "0-83"


def test_bind_sets_the_affinity_only_where_known(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(os, "sched_setaffinity",
                        lambda pid, cpus: calls.append((pid, sorted(cpus))))
    host.bind(host.place([BUS], range(112), fake_sys(tmp_path)))
    assert calls == [(0, list(range(28)) + list(range(56, 84)))]
    calls.clear()
    done = host.bind(host.place([BUS], range(112), str(tmp_path / "none")))
    assert calls == [] and done["bound_cpus"] is None


def task_stat(tid, name, cpu, utime, stime):
    fields = {14: utime, 15: stime, 39: cpu}
    rest = " ".join(str(fields.get(n, 0)) for n in range(4, 53))
    return f"{tid} ({name}) S {rest}\n"


def fake_proc(root, cpus, t, threads):
    """A /proc of this process at time t: threads {tid: (name, cpu,
    ticks, wait_ns, involuntary)}."""
    root.mkdir(exist_ok=True)
    (root / "loadavg").write_text(f"{t}.50 1.00 0.75 2/300 4242\n")
    (root / "cpuinfo").write_text("".join(
        f"processor\t: {c}\ncpu MHz\t\t: {2000 + 100 * t + c}.000\n\n"
        for c in cpus))
    (root / "stat").write_text(
        "cpu  1 2 3 4 5 6 7 999 0 0\n" + "".join(
            f"cpu{c} 1 2 3 4 5 6 7 {10 * t} 0 0\n" for c in cpus))
    me = root / "self"
    (me / "task").mkdir(parents=True, exist_ok=True)
    for tid, (name, cpu, ticks, wait_ns, niv) in threads.items():
        d = me / "task" / str(tid)
        d.mkdir(exist_ok=True)
        (d / "stat").write_text(task_stat(tid, name, cpu, ticks, ticks))
        (d / "schedstat").write_text(f"123 {wait_ns} 7\n")
        (d / "status").write_text(
            f"Name:\t{name}\nvoluntary_ctxt_switches:\t5\n"
            f"nonvoluntary_ctxt_switches:\t{niv}\n")
    return str(root)


def test_the_host_block(tmp_path):
    cpus = sorted(os.sched_getaffinity(0))
    tick = os.sysconf("SC_CLK_TCK")
    s0 = host.snapshot(fake_proc(tmp_path / "p0", cpus, 0, {
        101: ("python", 0, 0, 1_000, 1),
        102: ("hc (pack) 1", 1, 10, 0, 0),  # a name with ')' and spaces
        103: ("gone", 2, 0, 0, 0)}))
    s1 = host.snapshot(fake_proc(tmp_path / "p1", cpus, 1, {
        101: ("python", 3, tick, 500_001_000, 4),
        102: ("hc (pack) 1", 5, 10 + 2 * tick, 0, 2),
        104: ("new", 2, 0, 0, 0)}))
    w = host.window(s0, s1)
    where = host.bind(host.place([BUS], cpus, fake_sys(tmp_path / "sys")))
    block = {**where, **w, "pool_s": 2.5}
    assert set(block) == {
        "bus_ids", "numa_nodes", "local_cpulist", "affinity", "bound_cpus",
        "bound_nodes", "loadavg", "cpu_mhz", "steal_s", "voluntary_cs",
        "involuntary_cs", "minor_faults", "threads", "pool_s"}
    assert w["loadavg"] == [["0.50", "1.00", "0.75"], ["1.50", "1.00", "0.75"]]
    mean = sum(cpus) / len(cpus)
    assert w["cpu_mhz"] == [pytest.approx(2000 + mean),
                            pytest.approx(2100 + mean)]
    assert w["steal_s"] == pytest.approx(10 * len(cpus) / tick)
    # threads alive at both ends, by tid, each with its last CPU
    assert w["threads"] == [
        {"tid": 101, "name": "python", "cpu": 3, "cpu_s": pytest.approx(2.0),
         "wait_s": pytest.approx(0.5), "niv_cs": 3},
        {"tid": 102, "name": "hc (pack) 1", "cpu": 5,
         "cpu_s": pytest.approx(4.0), "wait_s": 0.0, "niv_cs": 2},
    ]
    for key in ("voluntary_cs", "involuntary_cs", "minor_faults"):
        assert isinstance(w[key], int) and w[key] >= 0


def test_a_python_thread_goes_by_its_python_name(tmp_path):
    import threading

    me = threading.current_thread()
    snap = host.snapshot(fake_proc(tmp_path, [0], 0, {
        me.native_id: ("python", 0, 0, 0, 0)}))
    assert snap["threads"][str(me.native_id)]["name"] == me.name


def test_card_bus_ids_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert host.card_bus_ids(1) == []


def test_a_bus_nvidia_smi_does_not_show(tmp_path, monkeypatch):
    """A sandboxed card reads "[N/A]": no bus id, so no binding."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho '[N/A]'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert host.card_bus_ids(1) == []
    with pytest.raises(ValueError):
        host.sysfs_bus_id("[N/A]")
