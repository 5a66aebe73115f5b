"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention and mamba heads, the
attention over a sliding window — the same published configuration as
``repro``'s."""

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    mlp_act="swiglu",
    sliding_window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=64, ngroups=1, chunk=128),
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    mlp_act="swiglu",
    sliding_window=32,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=32, ngroups=1, chunk=16),
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
