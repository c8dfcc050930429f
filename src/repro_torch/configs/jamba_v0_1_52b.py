"""jamba-v0.1-52b [hybrid] -- Mamba + attention 1:7, MoE 16e top-2. [arXiv:2403.19887]

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536. Period of 8 layers: one
attention layer per period (index 4), MoE on every second layer. The Mamba
layers' short conv1d is a 1D Cook-Toom conv (the paper's technique).
A copy of the JAX package's configs/jamba_v0_1_52b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every_k_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, scan_chunk=256),
    attn_every=8,
    scan_unit=8,
    subquadratic=True,
    max_seq=524_288,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
