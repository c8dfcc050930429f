"""nemotron-4-340b [dense] -- GQA + squared-ReLU MLP. [arXiv:2402.16819]

96L d_model=18432 96H (kv=8) d_ff=73728 vocab=256000.
A copy of the JAX package's configs/nemotron_4_340b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    act="squared_relu",
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
