"""The faults a cell can have, planted underneath a run on the CPU at a
small size, and the control put in the program's place: each reads not
correct."""

import pytest
import torch

from gpubench import harness
from gpubench.test_gpubench_runs import CELLS, RES, one_thread, run, small

__all__ = ["one_thread"]


def _half_batch(y):
    y = y.clone()
    y[y.shape[0] // 2:] = 0
    return y


def _altered(y):
    y = y.clone()
    y[0, 0] += 1.0
    return y


@pytest.mark.parametrize("fault", [_half_batch, _altered],
                         ids=["half_batch_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_reads_not_correct(workload, fault):
    rec = run(small(workload), fault=fault)
    assert not rec["correct"], rec["checks"]
    assert rec["checks"]["logit_err"]["value"] > \
        rec["checks"]["logit_err"]["limit"]


def _altered_once(call: int):
    """The answer of the `call`-th call (from 1) altered, no other."""
    calls = [0]

    def fault(y):
        calls[0] += 1
        return _altered(y) if calls[0] == call else y
    return fault


@pytest.mark.parametrize("workload", [c for c in CELLS if ".offline." in c])
def test_one_altered_call_in_the_window_reads_not_correct(workload):
    # the pool's one batch is called once in warm-up, so call 3 is the
    # window's second: the window keeps each logit's extremes, not the
    # first call's logits
    rec = run(small(workload), fault=_altered_once(3), seconds=1.0)
    assert not rec["correct"], rec["checks"]
    assert rec["images"] >= 3 * rec["batch"]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_not_correct(workload, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control on the card runs there")
    cell = small(workload)
    err = harness.control_err(cell, 2**31 + 202, torch.device(device), RES)
    assert err > cell.limits["logit_err"]
