"""The port's harness entry points (gatk_hc_tpu_torch/entry.py), the
counterparts of __graft_entry__.py: on the CPU through the kernels' plain
versions, against the reference package's entry() on the same batch (raw
f32 bit for bit with its jnp forward in FTZ mode), and the refusal to run
on fewer cards than asked for."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gatk_hc_tpu_torch import entry as port_entry
from tests.test_torch_runner import one_torch_thread  # noqa: F401


def test_dryrun_multichip_8_cpu_slots(capsys):
    summary = port_entry.dryrun_multichip(8, device="cpu")
    assert summary["grid"] == {"data": 4, "hap": 2}
    assert summary["raw_shape"] == [16, 4]
    assert summary["slots_hit"] == 8 == summary["launch_units"]
    assert "dryrun_multichip OK" in capsys.readouterr().out


@pytest.mark.parametrize("n,grid", [(1, {"data": 1, "hap": 1}),
                                    (3, {"data": 3, "hap": 1})])
def test_dryrun_multichip_odd_counts(n, grid):
    summary = port_entry.dryrun_multichip(n, device="cpu")
    assert summary["grid"] == grid
    assert summary["slots_hit"] == n


def test_entry_runs_and_matches_reference():
    """entry()'s fn on its example batch: finite (B,) raw f32, equal to
    the reference entry()'s jnp forward (FTZ mode) on the same batch."""
    import jax.numpy as jnp

    import __graft_entry__ as g
    from gatk_hc_tpu.ops.pairhmm_jax import (
        pairhmm_forward_batch,
        transition_constants,
    )

    fn, args = port_entry.entry(device="cpu")
    out = fn(*args).numpy()
    assert out.shape == (len(args[0]),) == (1024,)
    assert np.isfinite(out).all()
    _ref_fn, ref_args = g.entry()
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(pairhmm_forward_batch(
        *(jnp.asarray(np.asarray(b)) for b in ref_args),
        transition_constants(ord("I"), ord("+")), r_pad=32, c_pad=128,
        flush_denormals=True))
    np.testing.assert_array_equal(out, want)


def test_card_entry_points_raise_without_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


def test_module_main_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "gatk_hc_tpu_torch.entry", "4", "--device",
         "cpu"], capture_output=True, text=True, timeout=300,
        cwd=port_entry.__file__.rsplit("/gatk_hc_tpu_torch/", 1)[0])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun production runner OK: 4/4" in proc.stdout
    assert "entry() check: (1024,) True" in proc.stdout
