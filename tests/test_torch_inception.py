"""Inception-v3 end to end on the CPU against the JAX package: the checks
of tests/test_torch_zoo.py (placement tables, fp32 and int8 logits) at res
75, its smallest valid input, batch 2. Its 1x7 / 7x1 and 1x3 / 3x1 layers
run the single-axis `winograd_1d` executor under every Winograd algorithm
(tests/test_torch_winograd_1d.py holds it layer by layer)."""

import collections

import pytest
import torch

from repro_torch.core import compile as pt_compile
from repro_torch.models import cnn as pt_cnn
from test_torch_zoo import (TABLE_IDS, TABLES, check_int8, check_logits,
                            check_table)

NAME = "inception_v3"


@pytest.mark.parametrize("algorithm,cd", TABLES, ids=TABLE_IDS)
def test_placement_table_equals_reference(algorithm, cd):
    check_table(NAME, algorithm, cd)


@pytest.mark.parametrize("oracle", ["winograd", "im2col"])
def test_logits_match_reference(oracle):
    check_logits(NAME, oracle)


def test_int8_logits_match_reference():
    check_int8(NAME)


def test_placement_counts():
    """The pallas_winograd table by executor (the reference's counts at
    res 75): the 1x7 / 7x1 layers at F(2, 7) and the 1x3 / 3x1 ones at
    F(4, 3) on winograd_1d, the kxk layers on the streamed kernels, the
    1x1s on im2col."""
    specs = pt_cnn.inception_v3()
    params = pt_cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                             res=75, device="cpu")
    net = pt_compile.compile(params, specs, res=75, batch=1,
                             algorithm="pallas_winograd", device="cpu")
    kinds = collections.Counter(p.describe()["executor"]
                                for p in net.plans.values())
    assert kinds == {"winograd_1d": 34, "pallas_winograd": 15,
                     "pallas_winograd_strided": 5, "im2col": 40}
    tiles = collections.Counter(
        (p.describe()["filter"], p.describe()["tile"])
        for p in net.plans.values() if p.algorithm == "winograd_1d")
    assert {t for _, t in tiles} == {"2x2", "4x4"}
    assert all(t == ("2x2" if "7" in f else "4x4") for f, t in tiles)
