"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) — the same published
configuration as ``repro``'s."""

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=1, chunk=256),
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=32, ngroups=1, chunk=16),
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
