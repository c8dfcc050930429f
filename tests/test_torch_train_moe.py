"""The checks of tests/test_torch_train.py on the MoE and hybrid archs
(jamba, llama4-maverick, granite-moe) at their smoke configs: the loss and
every gradient leaf against the reference's, and one train step at
accum_steps 1 and 2 against its jitted step. Capacity-bounded routing on
both sides; jamba's 8-layer unit holds attention, Mamba, MoE and MLP
layers."""

import pytest

from test_torch_train import (MOE_ARCHS, check_loss_and_grads,  # noqa: F401
                              check_train_step, one_thread, reference)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(reference, arch):  # noqa: F811
    check_loss_and_grads(reference, arch)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference(reference, arch, accum):  # noqa: F811
    check_train_step(reference, arch, accum)
