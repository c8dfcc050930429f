"""A cell's run on the CPU at a small size, with the card's look skipped:
the reference against the port's plain path, a sound run read `correct`,
the control and each fault the cells can have read not correct."""

import dataclasses
import time

import pytest
import torch

from gpubench import harness
from gpubench.reference import cnn as reference

CELLS = ("vgg16.offline.b32", "mobilenet_v2.offline.b256",
         "vgg16.serve.poisson")
RES = 32


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(workload: str) -> harness.Cell:
    """The cell at a size a test holds: batches of 2 from one pool batch,
    or a few requests a second behind buckets 1 and 2."""
    cell = harness.load_cell(workload)
    if cell.mix["kind"] == "offline":
        mix = dict(cell.mix, batch=2, pool_batches=1)
    else:
        mix = dict(cell.mix, image_rate_per_s=30.0, pool_images=8)
    return dataclasses.replace(
        cell, mix=mix, config=dict(cell.config, serve_buckets=[1, 2]))


def run(cell, fault=None, seconds=0.25):
    return harness.run_cell(cell, 2**31 + 101, seconds, False,
                            torch.device("cpu"),
                            [("process start", time.perf_counter())],
                            res=RES, fault=fault)


@pytest.mark.parametrize("name", ["vgg16", "mobilenet_v2"])
def test_reference_matches_the_ports_plain_path(name):
    from repro_torch.core.compile import compile as port_compile
    cell = small(f"{name}.offline.b{32 if name == 'vgg16' else 256}")
    rows, params, pool, res = harness.draw(cell, 7, torch.device("cpu"),
                                           RES)
    net = port_compile(params, harness.port_specs(cell.config), res=res,
                       batch=2, algorithm="pallas_winograd", device="cpu")
    with torch.inference_mode():
        y = net.apply(pool[0])
    ref = reference.forward(cell.config["layers"], params, pool[0])
    assert y.shape == ref.shape == (2, 1000)
    assert harness.logit_err(harness.row_gaps(y, ref), ref) < 1e-5
    assert rows[-1]["out"] == (1, 1, 1000)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    rec = run(small(workload))
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert set(rec["metrics"]) == set(small(workload).end_to_end)
    assert all(m["value"] > 0 for m in rec["metrics"].values())
    assert rec["setup_s"] == pytest.approx(
        sum(rec["setup_phases"].values()), abs=1e-9)
