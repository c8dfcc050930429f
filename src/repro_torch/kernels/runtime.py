"""Shared kernel-runtime policy: device resolution and the fused epilogue
vocabulary.

`apply_activation` is the epilogue vocabulary shared by the CUDA kernels'
plain versions and the pure-PyTorch executors (bias add +
none/relu/relu6/gelu), so every conv backend exposes the same
fused-epilogue contract. GELU is the tanh approximation, as in the JAX
package. `check_operands` holds the checks every kernel wrapper makes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Epilogue activations the fused kernels support. relu6 is the
#: MobileNet-v2 nonlinearity (clipped ReLU).
ACTIVATIONS = ("none", "relu", "relu6", "gelu")


def pick_block(dim: int, target: int, quantum: int = 8) -> int:
    """Block size <= target; tiny dims round up to the quantum. The JAX
    package's blocking-granularity rule, for the kernels of later slices
    (the streaming kernel's blocking is chosen in core/winograd.py)."""
    return target if dim >= target else -(-dim // quantum) * quantum


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the CUDA device.
    Without CUDA, only an explicit `device="cpu"` runs (the plain
    versions); nothing falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def apply_activation(y: torch.Tensor, activation: str) -> torch.Tensor:
    """Elementwise epilogue activation; `y` is the fp32 accumulator."""
    if activation == "none":
        return y
    if activation == "relu":
        return F.relu(y)
    if activation == "relu6":
        return torch.clamp(F.relu(y), max=6.0)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    raise ValueError(
        f"unknown epilogue activation {activation!r}; expected {ACTIVATIONS}")


def check_activations(*activations: str) -> None:
    """Raise ValueError unless every activation is in ACTIVATIONS."""
    for act in activations:
        if act not in ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}; expected one of "
                             f"{ACTIVATIONS}")


def kernel_epilogue(y: torch.Tensor, bias: torch.Tensor | None,
                    scale: torch.Tensor | None,
                    activation: str) -> torch.Tensor:
    """The CUDA kernels' fused epilogue in plain PyTorch, on the fp32
    accumulator `y` (..., Mp): x scale (the int8 dequantization row, or
    None), + bias (at most Mp entries; the missing channels get none),
    activation. The plain versions of the kernels end with it."""
    if scale is not None:
        y = y * scale.reshape(-1).float()
    if bias is not None:
        y = y + F.pad(bias.float(), (0, y.shape[-1] - bias.shape[0]))
    return apply_activation(y, activation)


def check_operands(device: torch.device, operands) -> None:
    """Raise ValueError unless every (name, tensor, dtypes) operand that is
    not None is contiguous on `device` with one of `dtypes` (a tuple of
    torch dtypes): the checks every kernel wrapper makes before a launch."""
    for name, t, dtypes in operands:
        if t is None:
            continue
        if (t.device != device or not t.is_contiguous()
                or t.dtype not in dtypes):
            names = " / ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"{name} must be contiguous {names} on {device}, "
                             f"got {t.dtype} on {t.device}")


def epilogue(y: torch.Tensor, bias: torch.Tensor | None,
             activation: str) -> torch.Tensor:
    """Bias + activation for executors without a fused kernel epilogue:
    fp32 math, output in y's dtype."""
    if bias is None and activation == "none":
        return y
    out = y.float()
    if bias is not None:
        out = out + bias.float()
    return apply_activation(out, activation).to(y.dtype)
