"""Whisper-style encoder-decoder (port of ``repro.models.encdec``).  The
conv frontend is a stub in the reference too: callers pass frame
embeddings ``[B, T, d_model]``.

Parameters are ``{"embed": {"w"}, "enc_layers": [...], "dec_layers":
[...], "enc_norm", "dec_norm", "lm_head"}`` — the reference's tree with
its stacked encoder and decoder layers unstacked into lists
(``convert.params_from_numpy``).  The decoder's self-attention cache is
``lm.make_cache``'s ring (its ``n_layers`` are the decoder's), written
in place.

As in the reference, :func:`forward` adds the sinusoidal table to the
decoder's token embeddings and :func:`decode_step` does not, so stepped
decoding is not :func:`forward` (the positions reach the decoder only
through RoPE there); and the cross-attention projects the encoder output
anew at every step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention, blocks, rope
from repro_torch.models.common import (
    DATA,
    MODEL,
    checkpointed,
    dtype_of,
    layernorm,
    linear,
    linear_specs,
    make_linear,
    make_norm,
    norm_specs,
    pack_linear_params,
)
from repro_torch.sharding.partition import P


def init_params(cfg, generator: torch.Generator, device, wire_dtype: Optional[str] = None):
    """Seeded random parameters with ``encdec.init_encdec``'s rules:
    linears ``N(0, 1/d_in)``, embedding ``N(0, 0.02^2)``, layernorm scales
    one and biases zero.  With ``wire_dtype`` every DBB-eligible linear is
    packed to that wire as it is drawn."""
    if cfg.family != "encdec":
        raise ValueError(f"encdec.init_params needs family 'encdec', got {cfg.family!r}")
    dtype = dtype_of(cfg.dtype)
    sp = cfg.sparsity

    def pack(p):
        if wire_dtype is not None and p["w"].shape[0] % sp.bz == 0:
            return pack_linear_params(p, sp, wire_dtype)
        return p

    d = cfg.d_model
    kw = dict(dtype=dtype, device=device, pack=pack)
    emb = torch.randn((cfg.padded_vocab, d), generator=generator, device=device)
    params = {"embed": {"w": (emb * 0.02).to(dtype)}}
    del emb
    params["enc_layers"] = [blocks.make_encoder_block(generator, cfg, **kw)
                            for _ in range(cfg.n_enc_layers)]
    params["dec_layers"] = [blocks.make_xdecoder_block(generator, cfg, **kw)
                            for _ in range(cfg.n_layers)]
    params["enc_norm"] = make_norm(d, device=device, bias=True)
    params["dec_norm"] = make_norm(d, device=device, bias=True)
    params["lm_head"] = pack(make_linear(generator, d, cfg.padded_vocab, dtype=dtype,
                                         device=device))
    return params


def param_specs(cfg) -> dict:
    """The spec intent of every leaf of :func:`init_params`'s dense tree:
    the reference's ``init_encdec`` specs, each layer's unstacked."""
    return {"embed": {"w": P(None, MODEL)},
            "enc_layers": [blocks.encoder_block_specs(cfg)] * cfg.n_enc_layers,
            "dec_layers": [blocks.xdecoder_block_specs(cfg)] * cfg.n_layers,
            "enc_norm": norm_specs(bias=True), "dec_norm": norm_specs(bias=True),
            "lm_head": linear_specs(P(DATA, MODEL))}


def _enc_cfg(cfg):
    """The encoder's view of the config: ``n_enc_layers`` layers."""
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers)


def encode(params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """``frames [B, T, d_model]`` (stub embeddings) -> the encoder output:
    the sinusoidal table added, unmasked self-attention layers, the final
    layernorm."""
    b, t, _ = frames.shape
    x = frames + rope.sinusoidal_embedding(t, cfg.d_model, frames.device).to(frames.dtype)[None]
    positions = torch.arange(t, dtype=torch.int32, device=frames.device).expand(b, t)
    enc_cfg = _enc_cfg(cfg)
    for layer_p in params["enc_layers"]:
        x = blocks.encoder_block(layer_p, x, enc_cfg, positions)
    return layernorm(x, params["enc_norm"], cfg.norm_eps)


def _embed(params, tokens):
    return F.embedding(tokens.long(), params["embed"]["w"])


def _head(params, x, cfg):
    x = layernorm(x, params["dec_norm"], cfg.norm_eps)
    return linear(params["lm_head"], x)


def forward(params, frames: torch.Tensor, tokens: torch.Tensor, cfg, *,
            with_aux: bool = False):
    """Teacher-forced forward: ``frames [B, T, d]``, ``tokens [B, S]`` ->
    logits ``[B, S, V_padded]``, or with ``with_aux`` the reference's
    ``(logits, aux)`` with ``aux`` an f32 zero.  While a gradient is taken
    each decoder layer is checkpointed (``"dots"`` as ``"full"``, as the
    reference does); the encoder is not."""
    enc_out = encode(params, frames, cfg)
    b, s = tokens.shape
    x = _embed(params, tokens)
    x = x + rope.sinusoidal_embedding(s, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def layer(h, layer_p):
        return blocks.xdecoder_block(layer_p, h, enc_out, cfg, positions)

    remat = "full" if cfg.remat == "dots" else cfg.remat
    for layer_p in params["dec_layers"]:
        x = checkpointed(layer, remat, x, layer_p)
    logits = _head(params, x, cfg)
    if not with_aux:
        return logits
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def decode_step(params, cache, enc_out: torch.Tensor, tokens: torch.Tensor, pos: int, cfg):
    """One decoder step over the ring ``cache``: ``tokens [B, 1]`` at
    position ``pos``, cross-attending ``enc_out``.  No positional table is
    added (the reference's behaviour).  Returns ``(logits [B, 1,
    V_padded], cache)``; the cache is written in place."""
    b = tokens.shape[0]
    x = _embed(params, tokens)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for i, layer_p in enumerate(params["dec_layers"]):
        cache_layer = attention.ring_layer(cache, i)
        x = blocks.xdecoder_block(layer_p, x, enc_out, cfg, positions, cache_layer=cache_layer,
                                  decode_pos=pos)
    return _head(params, x, cfg), cache
