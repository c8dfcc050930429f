"""Architecture registry, copied from the JAX package's configs/ (data):
one module per architecture of ARCH_IDS.

get_config(name)        -> full published config
get_smoke_config(name)  -> reduced same-family config for CPU tests
SHAPES                  -> the assigned input-shape set (shared by all archs)
cells(name)             -> the (shape -> step kind) cells this arch runs
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ArchConfig, MoEConfig

ARCH_IDS = (
    "falcon_mamba_7b",
    "whisper_tiny",
    "qwen1_5_32b",
    "nemotron_4_340b",
    "qwen2_5_3b",
    "yi_34b",
    "jamba_v0_1_52b",
    "llama4_maverick_400b_a17b",
    "granite_moe_3b_a800m",
    "chameleon_34b",
)

#: assigned LM shapes: name -> (seq_len, global_batch, step kind)
SHAPES: Dict[str, tuple] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    key = canonical(name)
    if key not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; expected one of "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke()


def cells(name: str):
    """(shape_name, seq, batch, kind) cells for this arch. long_500k runs
    only with sub-quadratic attention (SSM / hybrid); for the pure
    full-attention archs it is an explicit skip."""
    cfg = get_config(name)
    out = []
    for shape, (seq, batch, kind) in SHAPES.items():
        if shape == "long_500k" and not cfg.subquadratic:
            out.append((shape, seq, batch, "skip"))
        else:
            out.append((shape, seq, batch, kind))
    return out


def _shrink_moe(m: MoEConfig | None) -> MoEConfig | None:
    if m is None:
        return None
    return dataclasses.replace(
        m, n_experts=min(m.n_experts, 8), top_k=min(m.top_k, 2),
        d_ff_expert=min(m.d_ff_expert, 128))


def shrink(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced same-family config: same layer pattern, tiny dims."""
    kv_ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    base = dict(
        n_layers=cfg.scan_unit * 2,
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=512,
        moe=_shrink_moe(cfg.moe),
        ssm=dataclasses.replace(cfg.ssm, d_state=8, scan_chunk=16)
        if cfg.ssm else None,
        encoder=dataclasses.replace(cfg.encoder, n_layers=2, n_ctx=16)
        if cfg.encoder else None,
        max_seq=256,
        logits_chunk=32,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
