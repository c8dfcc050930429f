"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on the CUDA device unless the caller
asks for the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import configs as pt_cfgs
from repro_torch.core import compile as pt_compile
from repro_torch.core import plan as pt_plan
from repro_torch.models import cnn as pt_cnn
from repro_torch.models import transformer as pt_tf

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE_FILES = sorted((ROOT / "examples" / "torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + EXAMPLE_FILES


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    # one torch script per JAX example, under the same name
    assert [p.name for p in EXAMPLE_FILES] == sorted(
        p.name for p in (ROOT / "examples").glob("*.py"))
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    for name in ("winograd_streamed.cu", "winograd_strided_streamed.cu",
                 "depthwise_strided_streamed.cu", "separable_streamed.cu",
                 "matmul.cu", "depthwise_streamed.cu", "winograd_fused.cu",
                 "conv1d_ct_fused.cu", "selective_scan.cu", "common.cuh",
                 "winograd_tc.cuh", "mma_tf32x3.cuh", "depthwise_common.cuh"):
        assert (csrc / name).exists(), name


def test_entry_points_default_to_cuda(tmp_path):
    """Without CUDA, an entry point called without device= raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    specs = pt_cnn.vgg16()
    w = torch.zeros(3, 3, 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_plan.plan_conv2d((1, 8, 8, 4), w)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_cnn.init_cnn(torch.Generator(), specs, 3, res=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_cnn.params_from_reference({"a": {"w": np.zeros(2)}})
    params = pt_cnn.init_cnn(torch.Generator(), specs, 3, res=32,
                             device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_compile.compile(params, specs, res=32)
    cfg = pt_cfgs.get_smoke_config("falcon_mamba_7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_tf.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_tf.init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_tf.params_from_reference({"embed": np.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_plan.plan_depthwise_conv1d((1, 8, 4), torch.zeros(4, 4))
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("qwen2_5_3b", steps=1, batch=2, seq=8, smoke=True,
              ckpt_dir=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointManager(str(tmp_path)).restore(0, {})
    state = adamw.AdamWState(np.int32(0), {"w": np.zeros(2, np.float32)},
                             {"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        adamw.opt_state_from_reference(state)
    assert adamw.opt_state_from_reference(state, device="cpu").m[
        "w"].device.type == "cpu"


def test_new_modules_fall_under_the_import_scan():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("obs/__init__.py", "obs/metrics.py", "obs/trace.py",
                "obs/profile.py", "runtime/__init__.py", "runtime/fault.py",
                "runtime/inject.py", "runtime/serve.py", "tree.py",
                "optim/adamw.py", "optim/adafactor.py",
                "optim/compression.py", "launch/steps.py", "launch/train.py",
                "data/pipeline.py", "checkpoint/manager.py",
                "launch/opcost.py", "launch/dryrun.py",
                "launch/profile_cell.py", "launch/sweep.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_server_defaults_to_cuda():
    """Without CUDA the server, and a plan load, raise unless the caller
    asks for the CPU; nothing is compiled before the device is settled."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.runtime.serve import ServeConfig, Server
    specs = [pt_cnn.Conv("c1", 3, 3, 4)]
    params = pt_cnn.init_cnn(torch.Generator(), specs, 3, res=8,
                             device="cpu")
    cfg = ServeConfig(buckets=(1,), verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(params, specs, res=8, config=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_compile.NetworkPlan.load("no-such-file.npz")
    srv = Server(params, specs, res=8, config=cfg, device="cpu")
    assert srv.device == torch.device("cpu")
    assert all(p.u.device.type == "cpu" for p in srv.nets[1].plans.values())


def test_kernel_wrapper_counts_no_launch_on_cpu():
    """On a CPU tensor the wrapper runs the plain version, counted as no
    launch; the CUDA library is never built or loaded."""
    from repro_torch.kernels import build
    from repro_torch.kernels import winograd as kw
    from repro_torch.core.transforms import cook_toom
    ct = cook_toom(2, 3)
    before = kw.winograd_streamed.LAUNCHES
    y = kw.winograd_streamed(torch.ones(1, 6, 6, 8), torch.ones(16, 8, 16),
                             None, ct_h=ct, ct_w=ct, bh=2, bw=2, block_c=8,
                             block_m=16)
    assert y.shape == (1, 4, 4, 16)
    assert kw.winograd_streamed.LAUNCHES == before
    assert build.load.cache_info().currsize == 0


def test_conv_plan_moves_with_to():
    plan = pt_plan.plan_conv2d((1, 8, 8, 4), torch.randn(3, 3, 4, 5),
                               algorithm="pallas_winograd",
                               compute_dtype="int8", device="cpu")
    names = dict(plan.named_buffers())
    assert set(names) == {"u", "scale"}
    assert names["u"].dtype == torch.int8
    moved = plan.to(torch.float64)       # int8 buffers keep their dtype
    assert moved.u.dtype == torch.int8


def _roadmap_queue1_items() -> dict[int, str]:
    """Item number -> text of ROADMAP.md's queue 1 ("Modules to port")."""
    import re
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text.split("### 1. Modules to port", 1)[1].split("\n### 2.", 1)[0]
    parts = re.split(r"^(\d+)\. ", queue, flags=re.M)
    return {int(n): body for n, body in zip(parts[1::2], parts[2::2])}


#: One layer of each kind the registry's capabilities cover: (x_shape,
#: w_shape, stride, groups) -- dense, 1x7, depthwise and grouped at stride
#: 1, dense and depthwise at stride 2, and a 1x1.
LAYER_KINDS = [((1, 12, 12, 8), (3, 3, 8, 8), 1, 1),
               ((1, 12, 12, 8), (1, 7, 8, 8), 1, 1),
               ((1, 12, 12, 8), (3, 3, 1, 8), 1, 8),
               ((1, 12, 12, 8), (3, 3, 2, 8), 1, 4),
               ((1, 12, 12, 8), (3, 3, 8, 8), 2, 1),
               ((1, 12, 12, 8), (3, 3, 1, 8), 2, 8),
               ((1, 12, 12, 8), (1, 1, 8, 8), 1, 1)]


def registry_executors_build_on_cpu() -> set[str]:
    """Plan every layer kind under every family that covers it, on the CPU,
    and return the executors that built a spec (and transformed a
    filter)."""
    from repro_torch.core import registry as pt_registry
    built = set()
    for x_shape, w_shape, stride, groups in LAYER_KINDS:
        q = pt_registry.as_query(w_shape[0], w_shape[1], stride,
                                 groups=groups, c_in=x_shape[3],
                                 c_out=w_shape[3])
        for fam in pt_registry.FAMILIES:
            if not pt_registry.supported(fam, q):
                continue
            p = pt_plan.plan_conv2d(x_shape, torch.zeros(w_shape),
                                    stride=stride, groups=groups,
                                    algorithm=fam, device="cpu")
            assert p.u is not None
            built.add(p.algorithm)
    return built


def test_not_ported_messages_name_existing_roadmap_items():
    """Every "queue 1 item N" the port names exists in ROADMAP.md, and
    every executor the registry declares builds a spec on the CPU."""
    import re
    from repro_torch.core import registry as pt_registry
    items = _roadmap_queue1_items()
    named = {int(n) for path in PORT_FILES
             for n in re.findall(r"queue 1 item (\d+)", path.read_text())}
    assert named <= set(items), sorted(named - set(items))
    assert not hasattr(pt_plan, "NOT_PORTED")
    assert registry_executors_build_on_cpu() == {
        c.executor for c in pt_registry.CAPABILITIES}
