"""qwen2.5-3b [dense] -- GQA kv=2, QKV bias, tied embeddings. [hf:Qwen/Qwen2.5-*]

36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936.
A copy of the JAX package's configs/qwen2_5_3b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
