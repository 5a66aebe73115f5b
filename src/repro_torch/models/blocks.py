"""Per-layer blocks (port of ``repro.models.blocks``): the pre-norm
decoder block (GQA or MLA attention over the paged cache, the ring cache
or no cache; then a dense MLP or, under ``cfg.moe``, the MoE FFN), with
hymba's hybrid branch (a mamba2 mixer beside the attention), and
whisper's encoder and cross-attending decoder blocks."""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    DATA,
    MODEL,
    layernorm,
    linear_specs,
    make_linear,
    make_norm,
    mlp_forward,
    norm_specs,
    rmsnorm,
)
from repro_torch.sharding.partition import P

# a cache layer's attention planes (a hybrid's also holds ssm_state/ssm_conv)
_ATTN_PLANES = ("k", "v", "pos", "k_scale", "v_scale")


def make_mlp(gen, d: int, f: int, *, act: str, dtype, device, pack=lambda p: p):
    """Seeded MLP linears (``gate`` and ``up`` under swiglu, ``up`` under
    gelu, then ``down``), each through ``pack``."""

    def lin(d_in, d_out):
        return pack(make_linear(gen, d_in, d_out, dtype=dtype, device=device))

    mlp = {"gate": lin(d, f), "up": lin(d, f)} if act == "swiglu" else {"up": lin(d, f)}
    mlp["down"] = lin(f, d)
    return mlp


def mlp_specs(act: str) -> dict:
    """:func:`make_mlp`'s spec intent."""
    specs = {"gate": linear_specs(), "up": linear_specs()} if act == "swiglu" else {
        "up": linear_specs()}
    specs["down"] = linear_specs(P(MODEL, DATA))
    return specs


def make_decoder_block(gen, cfg, *, dtype, device, pack=lambda p: p):
    """One decoder layer's seeded parameters: norms, attention (MLA or
    GQA), the hybrid's mixer and branch norms, then the MoE FFN or MLP."""
    d = cfg.d_model
    layer = {"ln1": make_norm(d, device=device), "ln2": make_norm(d, device=device)}
    if cfg.mla is not None:
        layer["attn"] = attn.make_mla(gen, cfg, dtype=dtype, device=device, pack=pack)
    else:
        layer["attn"] = attn.make_gqa(gen, cfg, dtype=dtype, device=device, pack=pack)
    if cfg.family == "hybrid":
        layer["ssm"] = ssm_mod.make_mamba2(gen, cfg, dtype=dtype, device=device, pack=pack)
        layer["ln_attn_out"] = make_norm(d, device=device)
        layer["ln_ssm_out"] = make_norm(d, device=device)
    if cfg.moe is not None:
        layer["moe"] = moe_mod.make_moe(gen, cfg, dtype=dtype, device=device)
    else:
        layer["mlp"] = make_mlp(gen, d, cfg.d_ff, act=cfg.mlp_act, dtype=dtype, device=device,
                                pack=pack)
    return layer


def decoder_block_specs(cfg) -> dict:
    """:func:`make_decoder_block`'s spec intent (one layer, no layer
    axis)."""
    specs = {"ln1": norm_specs(), "ln2": norm_specs(),
             "attn": attn.mla_specs(cfg) if cfg.mla is not None else attn.gqa_specs(cfg)}
    if cfg.family == "hybrid":
        specs.update(ssm=ssm_mod.mamba2_specs(), ln_attn_out=norm_specs(),
                     ln_ssm_out=norm_specs())
    if cfg.moe is not None:
        specs["moe"] = moe_mod.moe_specs()
    else:
        specs["mlp"] = mlp_specs(cfg.mlp_act)
    return specs


def decoder_block(p, x, cfg, positions, *, layer_idx=None, cache_layer=None,
                  decode_pos=None, rope_cs=None, page_tables=None, with_aux=False):
    """``x + attn(ln1(x))``, then ``+ mlp(ln2(.))``; a hybrid adds
    ``0.5 * (rmsnorm(attn) + rmsnorm(mixer))`` instead, the mixer taking
    the same dense ``ln1(x)`` (its ``in_proj`` prunes its own input).
    With ``with_aux`` returns ``(x, aux)``: the MoE load-balance loss
    (f32 zero without MoE), which training adds to its loss; serving
    drops it.

    ``cache_layer`` holds this layer's cache, written in place: with
    ``page_tables`` its page pools and the already-updated shared slot
    table, otherwise its ring (``decode_pos`` None: the prompt fills it;
    an int: one decode step at that position), and for a hybrid its
    ``ssm_state``/``ssm_conv``.  A prompt fill leaves the recurrent state
    untouched (the chunked scan has no exact one-shot state fill: engines
    step hybrids) while the attention ring fills exactly."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    attn_cache = cache_layer
    if cache_layer is not None and cfg.family == "hybrid":
        attn_cache = attn.ring_layer(cache_layer, names=_ATTN_PLANES)
    if cfg.mla is not None:
        a_out = attn.mla_forward(
            p["attn"], h, cfg, positions, layer_idx=layer_idx,
            cache_layer=attn_cache, decode_pos=decode_pos, page_tables=page_tables,
        )
    else:
        a_out = attn.gqa_forward(
            p["attn"], h, cfg, positions, layer_idx=layer_idx, cache_layer=attn_cache,
            decode_pos=decode_pos, rope_cs=rope_cs, page_tables=page_tables,
        )
    if cfg.family == "hybrid":
        prefill_fill = cache_layer is not None and decode_pos is None and page_tables is None
        ssm_cache = None
        if cache_layer is not None and not prefill_fill:
            ssm_cache = {"state": cache_layer["ssm_state"], "conv": cache_layer["ssm_conv"]}
        s_out = ssm_mod.mamba2_forward(p["ssm"], h, cfg, layer_idx=layer_idx,
                                       cache_layer=ssm_cache)
        x = x + 0.5 * (rmsnorm(a_out, p["ln_attn_out"], cfg.norm_eps)
                       + rmsnorm(s_out, p["ln_ssm_out"], cfg.norm_eps))
    else:
        x = x + a_out
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if cfg.moe is not None:
        m_out, aux = moe_mod.moe_forward(
            p["moe"], h2, cfg, layer_idx=layer_idx, n_groups=cfg.moe_groups
        )
    else:
        m_out = mlp_forward(
            p["mlp"], h2, act=cfg.mlp_act, sparsity=cfg.sparsity, layer_idx=layer_idx
        )
    if not with_aux:
        return x + m_out
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m_out, aux


# ----------------------------------------------------------------- whisper


def make_encoder_block(gen, cfg, *, dtype, device, pack=lambda p: p):
    """Seeded encoder layer: biased layernorms, GQA, a gelu MLP."""
    d = cfg.d_model
    return {
        "ln1": make_norm(d, device=device, bias=True),
        "ln2": make_norm(d, device=device, bias=True),
        "attn": attn.make_gqa(gen, cfg, dtype=dtype, device=device, pack=pack),
        "mlp": make_mlp(gen, d, cfg.d_ff, act="gelu", dtype=dtype, device=device, pack=pack),
    }


def encoder_block_specs(cfg) -> dict:
    """:func:`make_encoder_block`'s spec intent."""
    return {"ln1": norm_specs(bias=True), "ln2": norm_specs(bias=True),
            "attn": attn.gqa_specs(cfg), "mlp": mlp_specs("gelu")}


def encoder_block(p, x, cfg, positions, *, layer_idx=None):
    """Pre-layernorm encoder layer: unmasked self-attention, gelu MLP."""
    h = layernorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_forward(p["attn"], h, cfg, positions, layer_idx=layer_idx, causal=False)
    h2 = layernorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_forward(p["mlp"], h2, act="gelu", sparsity=cfg.sparsity, layer_idx=layer_idx)


def make_xdecoder_block(gen, cfg, *, dtype, device, pack=lambda p: p):
    """Seeded cross-attending decoder layer: three biased layernorms,
    causal GQA, cross-attention, a gelu MLP."""
    d = cfg.d_model
    return {
        "ln1": make_norm(d, device=device, bias=True),
        "ln_x": make_norm(d, device=device, bias=True),
        "ln2": make_norm(d, device=device, bias=True),
        "attn": attn.make_gqa(gen, cfg, dtype=dtype, device=device, pack=pack),
        "xattn": attn.make_cross_attn(gen, cfg, dtype=dtype, device=device, pack=pack),
        "mlp": make_mlp(gen, d, cfg.d_ff, act="gelu", dtype=dtype, device=device, pack=pack),
    }


def xdecoder_block_specs(cfg) -> dict:
    """:func:`make_xdecoder_block`'s spec intent."""
    return {"ln1": norm_specs(bias=True), "ln_x": norm_specs(bias=True),
            "ln2": norm_specs(bias=True), "attn": attn.gqa_specs(cfg),
            "xattn": attn.cross_attn_specs(), "mlp": mlp_specs("gelu")}


def xdecoder_block(p, x, enc_out, cfg, positions, *, layer_idx=None, cache_layer=None,
                   decode_pos=None):
    """Decoder layer: causal self-attention (over the ring ``cache_layer``
    at ``decode_pos``, written in place, or cache-less), cross-attention to
    ``enc_out``, gelu MLP; each behind its layernorm."""
    h = layernorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_forward(p["attn"], h, cfg, positions, layer_idx=layer_idx,
                             cache_layer=cache_layer, decode_pos=decode_pos)
    hx = layernorm(x, p["ln_x"], cfg.norm_eps)
    x = x + attn.cross_attn_forward(p["xattn"], hx, enc_out, cfg, layer_idx=layer_idx)
    h2 = layernorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_forward(p["mlp"], h2, act="gelu", sparsity=cfg.sparsity, layer_idx=layer_idx)
