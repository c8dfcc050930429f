"""falcon-mamba-7b [ssm] -- pure Mamba-1, attention-free. [arXiv:2410.05355]

64L d_model=4096, no FFN (d_ff=0: the Mamba mixer is the whole layer),
vocab=65024, ssm_state=16. The paper's technique applies here: the depthwise
causal conv1d (k=4) in every block is a 1D Cook-Toom conv. A copy of the
JAX package's configs/falcon_mamba_7b.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=32,            # nominal; attention-free
    n_kv_heads=32,
    head_dim=128,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, scan_chunk=256),
    subquadratic=True,
    max_seq=524_288,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
