"""llama4-maverick-400b-a17b [moe] -- 128-expert top-1 MoE, early fusion.
[hf:meta-llama/Llama-4-*]

48L d_model=5120 40H (kv=8) expert d_ff=8192 vocab=202048. Early-fusion
multimodality arrives as tokens (vocab covers image tokens) -- no frontend in
the backbone. Experts shard over the model axis (EP: 128 / 16 = 8 per chip).
MoE on every other layer (interleaved dense:MoE 1:1), which reproduces the
published ~400B total / ~17B active split.
A copy of the JAX package's configs/llama4_maverick_400b_a17b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  every_k_layers=2, shard_mode="ep"),
    scan_unit=2,
    rope_theta=500_000.0,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
