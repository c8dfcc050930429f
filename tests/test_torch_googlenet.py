"""GoogleNet end to end on the CPU against the JAX package: the checks of
tests/test_torch_zoo.py (placement tables, fp32 and int8 logits) at res
32, batch 2. Its nine 5x5 layers run F(2, 5) and its 7x7 stride-2 stem the
stride-2 phase kernel's plain version at T = 7."""

import pytest

from test_torch_zoo import (TABLE_IDS, TABLES, check_int8, check_logits,
                            check_table)

NAME = "googlenet"


@pytest.mark.parametrize("algorithm,cd", TABLES, ids=TABLE_IDS)
def test_placement_table_equals_reference(algorithm, cd):
    check_table(NAME, algorithm, cd)


@pytest.mark.parametrize("oracle", ["winograd", "im2col"])
def test_logits_match_reference(oracle):
    check_logits(NAME, oracle)


def test_int8_logits_match_reference():
    check_int8(NAME)
