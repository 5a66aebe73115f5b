"""Pre-norm decoder block (port of ``repro.models.blocks.decoder_block``):
GQA or MLA attention over the paged cache, the ring cache or no cache,
then a dense MLP or, under ``cfg.moe``, the MoE FFN."""

from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import mlp_forward, rmsnorm


def decoder_block(p, x, cfg, positions, *, layer_idx=None, cache_layer=None,
                  decode_pos=None, rope_cs=None, page_tables=None):
    """``x + attn(ln1(x))``, then ``+ mlp(ln2(.))``.  The MoE load-balance
    loss is dropped: serving has no use for it.

    ``cache_layer`` holds this layer's cache, written in place: with
    ``page_tables`` its page pools and the already-updated shared slot
    table, otherwise its ring (``decode_pos`` None: the prompt fills it;
    an int: one decode step at that position)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a_out = attn.mla_forward(
            p["attn"], h, cfg, positions, layer_idx=layer_idx,
            cache_layer=cache_layer, decode_pos=decode_pos, page_tables=page_tables,
        )
    else:
        a_out = attn.gqa_forward(
            p["attn"], h, cfg, positions, layer_idx=layer_idx, cache_layer=cache_layer,
            decode_pos=decode_pos, rope_cs=rope_cs, page_tables=page_tables,
        )
    x = x + a_out
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        m_out, _ = moe_mod.moe_forward(
            p["moe"], h2, cfg, layer_idx=layer_idx, n_groups=cfg.moe_groups
        )
    else:
        m_out = mlp_forward(
            p["mlp"], h2, act=cfg.mlp_act, sparsity=cfg.sparsity, layer_idx=layer_idx
        )
    return x + m_out
