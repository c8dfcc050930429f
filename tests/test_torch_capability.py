"""The port's capability table and im2row read amplification against the
JAX package's (repro.core.registry.capability_table,
repro.core.im2col.read_amplification)."""

import pytest

from repro.core import im2col as ref_im2col
from repro.core import registry as ref_registry
from repro_torch.core import im2col as pt_im2col
from repro_torch.core import registry as pt_registry


def test_capability_table_equals_reference_row_for_row():
    want = ref_registry.capability_table().splitlines()
    got = pt_registry.capability_table().splitlines()
    assert len(got) == len(want) == len(pt_registry.CAPABILITIES) + 2
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, bad


def test_capability_table_is_the_registry():
    rows = pt_registry.capability_table().splitlines()[2:]
    assert [r.split("|")[1].strip() for r in rows] == \
        [f"`{c.executor}`" for c in pt_registry.CAPABILITIES]


@pytest.mark.parametrize("kh,kw", [(1, 1), (3, 3), (5, 5), (7, 7), (1, 7),
                                   (7, 1), (3, 1)])
@pytest.mark.parametrize("stride", [(1, 1), (2, 2), (1, 2)])
def test_read_amplification_matches_reference(kh, kw, stride):
    assert pt_im2col.read_amplification(kh, kw, stride) == \
        ref_im2col.read_amplification(kh, kw, stride)
