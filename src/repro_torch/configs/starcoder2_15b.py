"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — gelu MLP, QKV bias, a 4096-token sliding window — the
same published configuration as ``repro``'s (arXiv:2402.19173; hf)."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    mlp_act="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
    sliding_window=4096,
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="starcoder2-15b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    mlp_act="gelu",
    qkv_bias=True,
    sliding_window=32,
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
