"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, QKV bias — the same published configuration as
``repro``'s (arXiv:2409.12191; hf).

Backbone only, as in the reference: the vision frontend is a stub, and
continuous serving takes text tokens with three equal position streams."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mlp_act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    m_rope_sections=(16, 24, 24),
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    mlp_act="swiglu",
    qkv_bias=True,
    m_rope_sections=(8, 4, 4),
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
