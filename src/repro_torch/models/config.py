"""Architecture configuration dataclasses, copied from the JAX package's
models/config.py (plain data; the port keeps its own copy so it imports
nothing of `repro`).

One frozen dataclass describes every architecture of the LM pool (dense,
MoE, SSM, hybrid, enc-dec, early-fusion VLM backbones). Configs are data,
models are functions (models/transformer.py).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Activation = Literal["swiglu", "gelu", "squared_relu"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every_k_layers: int = 1          # MoE on layers where idx % every_k == 0
    capacity_factor: float = 1.25
    #: "ep" shards the expert axis over the model mesh axis; "tp" shards the
    #: per-expert FFN dim instead (used when n_experts % mesh_model != 0).
    shard_mode: Literal["ep", "tp"] = "ep"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 block hyperparameters."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default d_model // 16
    #: chunk length of the plain chunked scan (the reference's
    #: memory/parallelism trade-off; the CUDA kernel steps through L in
    #: order and needs none).
    scan_chunk: int = 256
    #: route the depthwise conv through the Cook-Toom plan (the paper's
    #: technique applied to this arch family) vs direct conv.
    conv_algorithm: Literal["cook_toom", "direct"] = "cook_toom"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder (conv stem stubbed at the input boundary)."""
    n_layers: int
    n_ctx: int = 1500                 # post-conv frame count


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    act: Activation = "swiglu"
    qkv_bias: bool = False
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    #: hybrid (jamba): one attention layer per `attn_every` layers, rest Mamba.
    attn_every: Optional[int] = None
    encoder: Optional[EncoderConfig] = None
    rope_theta: float = 10_000.0
    pos_emb: Literal["rope", "learned", "none"] = "rope"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 32_768
    #: layers repeat in units of this many layers (jamba's period is 8);
    #: n_layers % scan_unit == 0.
    scan_unit: int = 1
    #: sub-quadratic attention available => long_500k shape is runnable.
    subquadratic: bool = False
    #: vocab chunk for the memory-bounded cross-entropy.
    logits_chunk: int = 512

    def __post_init__(self):
        if self.n_layers % self.scan_unit:
            raise ValueError("n_layers must divide into scan units")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_units(self) -> int:
        return self.n_layers // self.scan_unit

    def layer_kind(self, idx_in_unit: int) -> str:
        """'attn' | 'mamba' for position idx within a unit."""
        if self.family in ("ssm",):
            return "mamba"
        if self.attn_every:
            # jamba places its attention layer in the middle of each period.
            return "attn" if idx_in_unit == self.attn_every // 2 else "mamba"
        return "attn"

    def layer_is_moe(self, idx_in_unit: int) -> bool:
        return self.moe is not None and idx_in_unit % self.moe.every_k_layers == 0

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_unit = 0
        for i in range(self.scan_unit):
            kind = self.layer_kind(i)
            if kind == "attn":
                per_unit += d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
                    self.n_heads * hd * d
            else:
                s = self.ssm
                d_in = s.expand * d
                dt_rank = s.dt_rank or d // 16
                per_unit += d * 2 * d_in + s.d_conv * d_in + \
                    d_in * (dt_rank + 2 * s.d_state) + dt_rank * d_in + \
                    d_in * s.d_state + d_in * d
            mult = 3 if self.act == "swiglu" else 2
            if self.layer_is_moe(i):
                m = self.moe
                per_unit += m.n_experts * mult * d * m.d_ff_expert + d * m.n_experts
            else:
                per_unit += mult * d * self.d_ff
        total += per_unit * self.n_units
        if self.encoder:
            per_enc = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
                self.n_heads * hd * d + 2 * d * self.d_ff
            total += per_enc * self.encoder.n_layers
        return total

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.n_params
        m = self.moe
        mult = 3 if self.act == "swiglu" else 2
        inactive_per_moe_layer = (m.n_experts - m.top_k) * mult * \
            self.d_model * m.d_ff_expert
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.scan_unit)) \
            * self.n_units
        return self.n_params - inactive_per_moe_layer * n_moe_layers
