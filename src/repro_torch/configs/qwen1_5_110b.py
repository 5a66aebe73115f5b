"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias — the same published configuration as
``repro``'s (hf:Qwen/Qwen1.5-0.5B; hf)."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    mlp_act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=320,
    vocab=512,
    mlp_act="swiglu",
    qkv_bias=True,
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
