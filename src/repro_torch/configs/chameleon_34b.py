"""chameleon-34b [vlm] -- early-fusion, VQ image tokens, qk-norm. [arXiv:2405.09818]

48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536 (unified text + VQ image
token vocabulary). The VQ-VAE image tokenizer is outside the backbone,
which consumes tokens. Chameleon's qk-norm stabilizer is on.
A copy of the JAX package's configs/chameleon_34b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
