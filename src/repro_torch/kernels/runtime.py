"""Shared kernel-runtime policy: device resolution and the fused epilogue
vocabulary.

`apply_activation` is the epilogue vocabulary shared by the CUDA kernel's
plain version and the pure-PyTorch executors (bias add +
none/relu/relu6/gelu), so every conv backend exposes the same
fused-epilogue contract. GELU is the tanh approximation, as in the JAX
package.
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
