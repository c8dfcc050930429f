"""yi-34b [dense] -- llama-architecture GQA. [arXiv:2403.04652]

60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000.
A copy of the JAX package's configs/yi_34b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
