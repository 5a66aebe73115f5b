"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2 — the same published configuration as
``repro``'s (hf:microsoft/Phi-3.5-MoE-instruct)."""

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    mlp_act="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, capacity_factor=1.25),
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    mlp_act="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.5),
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
