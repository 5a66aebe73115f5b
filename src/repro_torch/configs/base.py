"""Model configuration (port of ``repro.configs.base.ModelConfig``).

Only the fields a dense GQA decoder reads are carried; each has the
reference's name, default and meaning, and a test holds them equal
field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.sparsity import DENSE, SparsityConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # only dense GQA is ported
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
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    sparsity: SparsityConfig = DENSE
    # embedding / lm_head rows are padded to a multiple of this
    vocab_pad_multiple: int = 256
    dtype: str = "bfloat16"

    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim()
