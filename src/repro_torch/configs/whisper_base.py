"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 —
encoder-decoder, the conv frontend a stub (callers pass frame
embeddings) — the same published configuration as ``repro``'s."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import AWDBB_4_8

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    n_enc_layers=6,  # encoder layers
    n_frames=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp_act="gelu",
    sparsity=AWDBB_4_8,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    n_frames=64,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    mlp_act="gelu",
    sparsity=AWDBB_4_8,
    attn_chunk=64,
)
