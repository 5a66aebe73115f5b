"""Model configuration (port of ``repro.configs.base``).

Only the fields a served or trained model (a decoder: dense GQA, MLA,
MoE, the VLM backbone, the mamba2 SSM or the hymba hybrid; or the whisper
enc-dec) reads are carried; each has the reference's name, default and
meaning, and a test holds them equal field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.sparsity import DENSE, SparsityConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-v2 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    mlp_act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # tokens; None = full attention
    attn_chunk: int = 1024  # query-chunked attention above this seq len
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    m_rope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    # enc-dec (whisper): encoder layer count + frame count for the stub
    n_enc_layers: int = 0
    n_frames: int = 1500
    sparsity: SparsityConfig = DENSE
    # MoE dispatch groups: routing and capacity are local to each group
    # of tokens (see models/moe.py)
    moe_groups: int = 1
    # embedding / lm_head rows are padded to a multiple of this
    vocab_pad_multiple: int = 256
    dtype: str = "bfloat16"
    # per-layer activation checkpointing of the training forward
    remat: str = "full"  # none | full | dots

    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    def kv_dim(self) -> int:
        """Width of one token's cached K row: the latent ``(c_kv ‖ k_rope)``
        under MLA, all KV heads otherwise."""
        if self.mla is not None:
            return self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
        return self.n_kv_heads * self.head_dim()

    def param_count(self) -> int:
        """Approximate parameter count (dense equivalent), the reference's
        arithmetic."""
        d, f, v, n_l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim()
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            per = d * (2 * di + 2 * s.ngroups * s.d_state + s.n_heads(d)) + di * d
            return v * d + n_l * per + d
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        mlp = 3 * d * f if self.mlp_act == "swiglu" else 2 * d * f
        if self.moe is not None:
            mlp = mlp * self.moe.n_experts + d * self.moe.n_experts
        total = v * d + n_l * (attn + mlp) + d
        if not self.tie_embeddings:
            total += v * d
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp)
        if self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            total += n_l * (d * (2 * di + 2 * s.ngroups * s.d_state + s.n_heads(d)) + di * d)
        return total

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (6·N_active·D convention)."""
        if self.moe is None:
            return self.param_count()
        d, f, n_l = self.d_model, self.d_ff, self.n_layers
        mlp = 3 * d * f if self.mlp_act == "swiglu" else 2 * d * f
        base = dataclasses.replace(self, moe=None).param_count() - n_l * mlp
        return base + n_l * self.moe.top_k * mlp


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One dry-run input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
