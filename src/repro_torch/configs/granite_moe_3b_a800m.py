"""granite-moe-3b-a800m [moe] -- 40-expert top-8 MoE. [hf:ibm-granite/granite-3.0-*]

32L d_model=1536 24H (kv=8) expert d_ff=512 vocab=49155. 40 experts do not
divide the 16-way model axis, so experts use tensor-parallel sharding on the
FFN dim instead of EP (shard_mode="tp", see distributed/sharding.py).
A copy of the JAX package's configs/granite_moe_3b_a800m.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, shard_mode="tp"),
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
