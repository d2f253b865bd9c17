"""A run's verdict with the timed path broken underneath.

The driver's whole run (set-up, window, check) on the CPU, where the
runner launches the kernels' plain versions, with no look for a card; the
verdict is ``run.judge``'s.  Each fault this cell can have has to come out
not correct: results left unchanged (never written), half of each submit
left out with the mean of the rest in its place, and one answer altered
where the kernel produces it.  The cell has one chip and no exchange
between chips, so that fault does not apply."""

import numpy as np
import pytest
import torch

from hcbench import run
from hcbench.drivers import runner_stream


def verdict(cell):
    config, traffic = cell
    record = runner_stream.run(config, traffic, 2 ** 31 + 7, 0.5, False,
                               ["cpu"])
    return run.judge(record)[0], record


@pytest.fixture
def runner_cls(monkeypatch):
    """Replace the runner the build thread makes (ops/runner.py takes a
    TorchPairHMMRunner set on it)."""
    from gatk_hc_tpu_torch.ops import runner as runner_mod
    from gatk_hc_tpu_torch.ops import torch_runner

    def install(cls):
        monkeypatch.setattr(runner_mod, "TorchPairHMMRunner", cls,
                            raising=False)

    return torch_runner.TorchPairHMMRunner, install


def test_sound_run_is_correct(cell):
    correct, record = verdict(cell)
    assert correct, record["check"]
    assert record["attempted"] > 0 and record["missing"] == 0
    assert record["check"]["regions"] > 1


def test_results_left_unchanged(cell, runner_cls):
    base, install = runner_cls

    class Unchanged(base):
        def drain(self, batches):
            for b in batches:
                b.result()  # the work is done; the results are not written

    install(Unchanged)
    correct, record = verdict(cell)
    assert not correct and record["missing"] == record["attempted"]


def test_half_the_batch_left_out(cell, runner_cls):
    base, install = runner_cls

    class Half(base):
        def submit(self, jobs):
            half = len(jobs) // 2
            handle = super().submit(jobs[:half])
            self.__dict__.setdefault("split", {})[id(handle)] = (
                jobs[:half], jobs[half:])
            return handle

        def drain(self, batches):
            super().drain(batches)
            for b in batches:
                kept, left_out = self.split.pop(id(b))
                mean = np.mean([j.result.mean() for j in kept])
                for job in left_out:
                    job.result = np.full((len(job.reads), len(job.haps)),
                                         mean)

    install(Half)
    correct, record = verdict(cell)
    assert not correct
    assert record["missing"] == 0  # every answer came, half of them wrong
    assert record["check"]["regions_past_limit"] > 0


def test_an_answer_altered_where_produced(cell, monkeypatch):
    from gatk_hc_tpu_torch.ops import pairhmm_front

    produce = pairhmm_front.ppe_forward_unique

    def altered(*args, **kwargs):
        out = produce(*args, **kwargs).clone()
        out[torch.argmax(out)] *= 2.0
        return out

    monkeypatch.setattr(pairhmm_front, "ppe_forward_unique", altered)
    correct, record = verdict(cell)
    assert not correct
    assert record["check"]["max_log10_gap"] == pytest.approx(
        np.log10(2.0), rel=1e-3)
