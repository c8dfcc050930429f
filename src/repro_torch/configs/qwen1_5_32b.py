"""qwen1.5-32b [dense] -- MHA with QKV bias. [hf:Qwen/Qwen1.5-*]

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064, SwiGLU, RoPE.
A copy of the JAX package's configs/qwen1_5_32b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
