"""Attention over the paged KV cache (port of the paged half of
``repro.models.attention``).

Per layer the cache holds ``k/v [N_pages, PS, KV*D]`` pools — int8 with
per-token ``k_scale/v_scale [N_pages, PS]`` planes under the int8 KV wire
— and one slot-position table ``pos [N_pages, PS]`` shared by all layers.
Logical position ``p`` of a request lives at
``(page_table[p // PS], p % PS)``; page 0 is the null page that pads every
table and absorbs padding writes with ``pos = -1``.  Masking derives from
the slot positions only.

Unlike the reference's functional updates, :func:`paged_update` and
:func:`paged_update_pos` write the cache tensors **in place**: the pools
are the largest state on the card, and no caller needs the old version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import ops
from repro_torch.models import common, rope
from repro_torch.models.common import linear

NEG_INF = -1e30
NULL_PAGE = 0


def _paged_flat_idx(positions, page_tables, page_size: int):
    """``[B, S]`` absolute positions (-1 = padding) -> flat page-pool slots;
    padding goes to (null page, slot 0)."""
    valid = positions >= 0
    p_safe = torch.clamp_min(positions, 0).long()
    logical = torch.clamp_max(p_safe // page_size, page_tables.shape[1] - 1)
    page = torch.gather(page_tables.long(), 1, logical)
    page = torch.where(valid, page, torch.full_like(page, NULL_PAGE))
    slot = torch.where(valid, p_safe % page_size, torch.zeros_like(p_safe))
    return (page * page_size + slot).reshape(-1), valid


def paged_update(cache_layer, new_k, new_v, positions, page_tables) -> None:
    """Scatter a ``[B, S, D]`` chunk of new K/V into its pages, in place.
    Int8 caches quantize each token row here (write time) and store its
    scale in the same flat slot."""
    ps = cache_layer["k"].shape[1]
    flat, _ = _paged_flat_idx(positions, page_tables, ps)
    for name, new in (("k", new_k), ("v", new_v)):
        c = cache_layer[name]
        sname = name + "_scale"
        if sname in cache_layer:
            new, sc = quant.quantize_rows(new)
            cache_layer[sname].view(-1)[flat] = sc.reshape(-1)
        c.view(-1, c.shape[-1])[flat] = new.reshape(-1, new.shape[-1]).to(c.dtype)


def paged_update_pos(pos_tbl, positions, page_tables) -> None:
    """Record the step's token positions in the shared slot table, in
    place; padding writes land on the null page with -1."""
    ps = pos_tbl.shape[1]
    flat, valid = _paged_flat_idx(positions, page_tables, ps)
    vals = torch.where(valid, positions, torch.full_like(positions, -1))
    pos_tbl.view(-1)[flat] = vals.reshape(-1).to(torch.int32)


def paged_read(cache_layer, pos_tbl, page_tables, dtype=torch.float32):
    """The gather path's read boundary: each request's pages as a
    contiguous window ``(k [B, P*PS, Dk], v [B, P*PS, Dv], pos [B, P*PS])``
    in ``dtype`` (int8 planes dequantized).  The serving path never
    materializes this window (it runs kernel #6); tests hold kernel #6's
    plain version against this path."""
    b, p = page_tables.shape
    ps = cache_layer["k"].shape[1]
    tables = page_tables.long()

    def read(name):
        c = cache_layer[name]
        win = c[tables].reshape(b, p * ps, c.shape[-1])
        sname = name + "_scale"
        if sname in cache_layer:
            s_win = cache_layer[sname][tables].reshape(b, p * ps)
            return quant.dequantize_rows(win, s_win, dtype)
        return win.to(dtype)

    return read("k"), read("v"), pos_tbl[tables].reshape(b, p * ps)


def _mask_bias(q_pos, k_pos, window: Optional[int]):
    """``[B, S, T]`` float32 bias from absolute positions (-1 k_pos: invalid)."""
    valid = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    return torch.where(valid, 0.0, NEG_INF).float()


def mha(q, k, v, q_pos, k_pos, *, window: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention with position-derived masking; KV heads are
    never repeated.  q ``[B, S, H, D]``, k/v ``[B, T, KV, D]``."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kv, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    logits = logits + _mask_bias(q_pos, k_pos, window)[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btke->bskge", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def gqa_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor, *, layer_idx=None,
                cache_layer=None, rope_cs=None, page_tables=None):
    """GQA over the paged cache: project (one shared DAP+pack for Q/K/V),
    RoPE, write this step's K/V into the pages, attend with the fused
    paged-attention kernel (#6), project out.  ``cache_layer["pos"]``
    already holds this step's positions (``lm.paged_step`` writes the
    shared table once before the layer loop)."""
    if page_tables is None or cache_layer is None:
        raise NotImplementedError(
            "only the paged-cache path of GQA is ported (ROADMAP queue 1, item 8)"
        )
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    sp, li = cfg.sparsity, layer_idx
    xin = common.maybe_pack_input(x, (p["wq"], p["wk"], p["wv"]), sp, li)
    q = linear(p["wq"], xin, sparsity=sp, layer_idx=li).reshape(b, s, h, dh)
    k = linear(p["wk"], xin, sparsity=sp, layer_idx=li).reshape(b, s, kvh, dh)
    v = linear(p["wv"], xin, sparsity=sp, layer_idx=li).reshape(b, s, kvh, dh)
    cos, sin = rope_cs if rope_cs is not None else rope.rope_cos_sin(
        positions, dh, cfg.rope_theta
    )
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    paged_update(
        cache_layer, k.reshape(b, s, kvh * dh), v.reshape(b, s, kvh * dh),
        positions, page_tables,
    )
    out = ops.paged_attention(
        q, cache_layer["k"], cache_layer["v"], cache_layer["pos"], page_tables,
        positions, kv_heads=kvh, window=cfg.sliding_window,
        k_scale=cache_layer.get("k_scale"), v_scale=cache_layer.get("v_scale"),
        out_dtype=x.dtype,
    )
    return linear(p["wo"], out.reshape(b, s, h * dh), sparsity=sp, layer_idx=li)
