"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — the same published configuration as ``repro``'s."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    mlp_act="swiglu",
    rope_theta=10_000.0,
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    mlp_act="swiglu",
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
