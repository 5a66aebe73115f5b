"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 — the same published configuration as
``repro``'s (hf:ibm-granite/granite-3.0-1b-a400m-base)."""

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    mlp_act="swiglu",
    moe=MoEConfig(n_experts=32, top_k=8, capacity_factor=1.25),
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab=512,
    mlp_act="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.5),
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
