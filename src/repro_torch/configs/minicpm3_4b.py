"""minicpm3-4b [dense, MLA]: 62L d_model=2560 40H d_ff=6400 vocab=73448
— the same published configuration as ``repro``'s
(hf:openbmb/MiniCPM3-4B)."""

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    mlp_act="swiglu",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    mlp_act="swiglu",
    mla=MLAConfig(
        q_lora_rank=64,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
