"""Attention over the paged KV cache (port of the paged half of
``repro.models.attention``): GQA and MLA.

Per layer the cache holds ``k/v [N_pages, PS, D]`` pools — int8 with
per-token ``k_scale/v_scale [N_pages, PS]`` planes under the int8 KV wire
— and one slot-position table ``pos [N_pages, PS]`` shared by all layers.
GQA pages hold ``KV*D`` per plane; MLA's k pages hold the
``(c_kv ‖ k_rope)`` latent and its v pages a 1-wide zero dummy (only the
latent is quantized).  Logical position ``p`` of a request lives at
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
from repro_torch.models.common import linear, make_linear, make_norm, rmsnorm

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
    scale in the same flat slot.

    Every padding token writes (null page, slot 0), and rows with no
    valid key read that slot (kernel #6's uniform mean).  A sequential
    scatter, as the reference's on the CPU, leaves the last padding
    token's row there; CUDA scatters duplicates in no fixed order, so
    every padding token writes the last one's row, and the slot's bytes
    never depend on the order."""
    ps = cache_layer["k"].shape[1]
    flat, valid = _paged_flat_idx(positions, page_tables, ps)
    valid = valid.reshape(-1)
    order = torch.arange(valid.numel(), device=valid.device)
    last_pad = torch.where(valid, -1, order).amax().clamp_min(0)
    src = torch.where(valid, order, last_pad)
    for name, new in (("k", new_k), ("v", new_v)):
        c = cache_layer[name]
        sname = name + "_scale"
        if sname in cache_layer:
            new, sc = quant.quantize_rows(new)
            cache_layer[sname].view(-1)[flat] = sc.reshape(-1)[src]
        c.view(-1, c.shape[-1])[flat] = new.reshape(-1, new.shape[-1])[src].to(c.dtype)


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


# ------------------------------------------------------------------- MLA


def make_mla(gen: torch.Generator, cfg, *, dtype, device, pack):
    """Seeded MLA projections with the reference's shapes and key order;
    ``pack`` is applied to each linear as it is drawn, except ``kv_up``,
    which the absorbed attention reads dense, per head."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def lin(d_in, d_out):
        return make_linear(gen, d_in, d_out, dtype=dtype, device=device)

    return {
        "q_down": pack(lin(d, m.q_lora_rank)),
        "q_norm": make_norm(m.q_lora_rank, device=device),
        "q_up": pack(lin(m.q_lora_rank, h * qk)),
        "kv_down": pack(lin(d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": make_norm(m.kv_lora_rank, device=device),
        "kv_up": lin(m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
        "wo": pack(lin(h * m.v_head_dim, d)),
    }


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with the reference's f32 result (``preferred_element_type
    =float32``), multiplied in float64 and rounded once: the library picks
    its summation order from the shapes, and float64 keeps a row's rounded
    result independent of how many rows share the call."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _mla_absorb_q(q_nope, w_kv_up, m, out_dtype):
    """q absorbed through the k half of ``kv_up`` per head:
    ``[B, S, H, lora]``."""
    wk = w_kv_up[..., : m.qk_nope_head_dim]  # [lora, H, nope]
    return _einsum_f32("bshn,lhn->bshl", q_nope, wk.to(q_nope.dtype)).to(out_dtype)


def _mla_up_project(ctx, w_kv_up, m, out_dtype):
    """The latent context through the v half of ``kv_up``:
    ``[B, S, H, dv]``."""
    wv = w_kv_up[..., m.qk_nope_head_dim:]  # [lora, H, dv]
    return _einsum_f32("bshl,lhv->bshv", ctx.to(out_dtype), wv.to(out_dtype)).to(out_dtype)


def _mla_absorbed_fused(q_nope, q_rope, cache_layer, page_tables, q_pos, w_kv_up, m,
                        scale, out_dtype):
    """Absorbed-form MLA through the fused paged kernel's latent mode (#6):
    the ``(q_abs ‖ q_rope)`` concat scores against the raw
    ``(c_kv ‖ k_rope)`` latent pages (``kv_heads=1``), and the context
    reuses the latent prefix of the same k page as v, so the 1-wide dummy
    v pages are never read."""
    lora = m.kv_lora_rank
    q_abs = _mla_absorb_q(q_nope, w_kv_up, m, out_dtype)
    q_cat = torch.cat([q_abs, q_rope.to(out_dtype)], dim=-1)
    ctx = ops.paged_attention(
        q_cat, cache_layer["k"], cache_layer["v"], cache_layer["pos"], page_tables, q_pos,
        kv_heads=1, softmax_scale=scale, k_scale=cache_layer.get("k_scale"),
        latent_dv=lora, out_dtype=out_dtype,
    )  # [B, S, H, lora]
    return _mla_up_project(ctx, w_kv_up, m, out_dtype)


def mla_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor, *, layer_idx=None,
                cache_layer=None, page_tables=None):
    """MLA over the paged latent cache: the two down-projections share one
    DAP+pack, RoPE rotates the ``qk_rope`` dims with one shared k head,
    this step's ``(c_kv ‖ k_rope)`` latent goes into the k pages (a zero
    1-wide row into the v pages), and the absorbed attention runs through
    the fused kernel's latent mode.  Logits scale by
    ``1/sqrt(qk_nope + qk_rope)``."""
    if page_tables is None or cache_layer is None:
        raise NotImplementedError(
            "only the paged-cache path of MLA is ported (ROADMAP queue 1, item 8)"
        )
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    sp, li = cfg.sparsity, layer_idx
    qk_rope, qk_nope, dv = m.qk_rope_head_dim, m.qk_nope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)

    xin = common.maybe_pack_input(x, (p["q_down"], p["kv_down"]), sp, li)
    cq = rmsnorm(linear(p["q_down"], xin, sparsity=sp, layer_idx=li), p["q_norm"])
    q = linear(p["q_up"], cq, sparsity=sp, layer_idx=li).reshape(b, s, h, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    cos, sin = rope.rope_cos_sin(positions, qk_rope, cfg.rope_theta)
    q_rope = rope.apply_rope(q_rope, cos, sin)

    kv = linear(p["kv_down"], xin, sparsity=sp, layer_idx=li)
    c_kv = rmsnorm(kv[..., : m.kv_lora_rank], p["kv_norm"])
    k_rope = rope.apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :], cos, sin)[:, :, 0, :]

    w_kv_up = p["kv_up"]["w"].reshape(m.kv_lora_rank, h, qk_nope + dv)
    latent = torch.cat([c_kv, k_rope], dim=-1)
    paged_update(cache_layer, latent, torch.zeros((b, s, 1), dtype=latent.dtype,
                                                  device=latent.device),
                 positions, page_tables)
    out = _mla_absorbed_fused(
        q_nope, q_rope, cache_layer, page_tables, positions, w_kv_up, m, scale, x.dtype,
    )
    return linear(p["wo"], out.reshape(b, s, h * dv), sparsity=sp, layer_idx=li)
