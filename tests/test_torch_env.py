"""The port's environment overrides of config defaults against the JAX
package's: the same seven defaults, validated at import as the reference
validates them, under the GATK_HC_TPU_TORCH_ prefix.  The validation runs
at import, so each case imports the config in a fresh process."""

import ast
import json
import os
import subprocess
import sys

import pytest

from gatk_hc_tpu_torch import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PREFIX, PORT_PREFIX = "GATK_HC_TPU_", "GATK_HC_TPU_TORCH_"

# variable -> (field, a valid value, the field it gives, a bad value)
CASES = {
    "GATK_HC_TPU_TORCH_FUSE_GROUPS": ("fuse_groups", "8", 8, "5"),
    "GATK_HC_TPU_TORCH_FUSE_AUTO": ("fuse_auto", "0", False, "yes"),
    "GATK_HC_TPU_TORCH_PALLAS_ALGO": ("pallas_algo", "striped", "striped",
                                      "pallas"),
    "GATK_HC_TPU_TORCH_DISPATCH": ("dispatch_mode", "packed", "packed",
                                   "nib"),
    "GATK_HC_TPU_TORCH_PACKED_NIB": ("packed_nib", "0", False, "false"),
    "GATK_HC_TPU_TORCH_PPE_ROWS": ("ppe_rows", "8", 8, "3"),
    "GATK_HC_TPU_TORCH_DEVICE_TIMEOUT": ("device_timeout_s", "0", 0.0,
                                         "-1"),
}

# what the config and the CLI's config give, printed by a fresh process
PROBE = """
import dataclasses, json
from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
args = cli.build_parser().parse_args(["-I", "x.sam", "-R", "x.fa", "-O", "x"])
run = cli.config_from_args(args, "cuda")
print(json.dumps({"default": dataclasses.asdict(DEFAULT_CONFIG),
                  "cli": dataclasses.asdict(run)}))
"""


def probe(env):
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith(PORT_PREFIX)}
    return subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                          env={**clean, **env}, capture_output=True,
                          text=True, timeout=60)


def env_calls(path):
    """{field: (variable, default, choices or minimum)} of the ``_env_*``
    calls that set HCConfig's fields in the config module at ``path``
    (a source scan: nothing is imported).  Names resolve against the port's
    config module (its FUSE_GROUPS)."""

    def value(node):
        if isinstance(node, ast.Name):
            return getattr(port_config, node.id)
        return ast.literal_eval(node)

    tree = ast.parse(open(path).read())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "HCConfig")
    calls = {}
    for stmt in cls.body:
        if not isinstance(stmt, ast.AnnAssign) or stmt.value is None:
            continue
        for node in ast.walk(stmt.value):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id.startswith("_env_")):
                args = [value(a) for a in node.args]
                kwargs = {k.arg: value(k.value) for k in node.keywords}
                limit = (args[2] if len(args) > 2
                         else kwargs.get("minimum", 0.0))
                calls[stmt.target.id] = (node.func.id, args[0], args[1], limit)
    return calls


@pytest.mark.parametrize("kind", ["valid", "bad"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_override_sets_field_or_raises_at_import(name, kind):
    """A valid value reaches DEFAULT_CONFIG and the CLI's config; a bad one
    raises ValueError at import, naming the variable."""
    field, good, want, bad = CASES[name]
    done = probe({name: good if kind == "valid" else bad})
    if kind == "valid":
        assert done.returncode == 0, done.stderr
        got = json.loads(done.stdout)
        assert got["default"][field] == want
        assert got["cli"][field] == want
    else:
        assert done.returncode != 0
        last = done.stderr.strip().splitlines()[-1]
        assert last.startswith("ValueError: " + name + "="), last


def test_unset_gives_the_defaults():
    """With no GATK_HC_TPU_TORCH_* variable (and the reference's names set,
    which the port does not read) the defaults are the reference's."""
    ref_env = {REF_PREFIX + "FUSE_GROUPS": "16", REF_PREFIX + "DISPATCH":
               "planes", REF_PREFIX + "DEVICE_TIMEOUT": "0"}
    done = probe(ref_env)
    assert done.returncode == 0, done.stderr
    got = json.loads(done.stdout)
    assert got["default"] == got["cli"]
    fields = {field for field, *_ in CASES.values()}
    assert {f: got["default"][f] for f in fields} == {
        "fuse_groups": 4, "fuse_auto": True, "pallas_algo": "ppe",
        "dispatch_mode": "adaptive", "packed_nib": True, "ppe_rows": 4,
        "device_timeout_s": 1200.0}


def test_every_reference_override_has_a_port_counterpart():
    """Each of the reference's seven ``_env_*`` calls
    (gatk_hc_tpu/config.py) has one in the port's config with the same
    validator, default and choices or minimum, named GATK_HC_TPU_TORCH_*."""
    ref = env_calls(os.path.join(REPO, "gatk_hc_tpu", "config.py"))
    port = env_calls(os.path.join(REPO, "gatk_hc_tpu_torch", "config.py"))
    assert len(ref) == 7
    assert sorted(port) == sorted(ref)
    for field, (fn, name, default, limit) in ref.items():
        assert name.startswith(REF_PREFIX)
        want = (fn, PORT_PREFIX + name[len(REF_PREFIX):], default,
                tuple(limit) if isinstance(limit, tuple) else limit)
        assert port[field] == want, field
    assert sorted(name for _, name, _, _ in port.values()) == sorted(CASES)
