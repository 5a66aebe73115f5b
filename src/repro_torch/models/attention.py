"""Attention (port of ``repro.models.attention``): GQA and MLA over the
ring-buffer KV cache (one-shot and stepped serving), over the paged KV
cache (continuous serving), and cache-less; whisper's cross-attention.

**Ring cache.**  Per layer ``k/v [B, W, KV*D]`` plus absolute slot
positions ``pos [B, W]`` (-1: empty); a full-attention cache has
``W = max_seq`` (slot == position), a windowed one ``W = window`` (slot
== position % W).  Under the int8 KV wire the planes are int8 with
per-token ``k_scale/v_scale [B, W]`` planes, quantized at write time
(:func:`fill_ring`, :func:`_update_ring`) and dequantized at the read
boundary (:func:`ring_window`).  Prefill quantizes its K/V once and
attends over the dequantization, so it sees the bytes stepped decode will
read back.  The ring helpers write in place, like the paged ones.

Under a distribution context ``lm.make_cache`` may build the ring
window-sharded instead (:class:`ShardedRing`): each rank holds its rows
and its ``W / n_model`` slots, and decode runs the sequence-parallel
:func:`flash_decode`.

**Paged cache.**  Per layer the cache holds ``k/v [N_pages, PS, D]`` pools — int8 with
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
``cfg.sparsity.paged_attn`` picks the paged read: ``"fused"`` runs the
fused kernel (#6), ``"gather"`` materializes each request's window
(:func:`paged_read`) and attends with :func:`mha` or
:func:`_mla_absorbed`, plain PyTorch as in the reference; ``"auto"``
resolves per shape as the reference's does (:func:`_paged_attn_impl`:
the autotune cache, then fused on a CUDA device and gather elsewhere).

:func:`mha`, :func:`_mla_absorbed` and MLA's einsums sum in float64 and
round once: a library einsum picks its summation order from the shapes,
and float64 keeps a row's rounded result independent of how many rows
share the call (batched prefill is batch-invariant on CUDA too).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import quant
from repro_torch.kernels import autotune, ops
from repro_torch.models import common, rope
from repro_torch.models.common import (
    DATA,
    MODEL,
    einsum_f32,
    linear,
    linear_specs,
    make_linear,
    make_norm,
    norm_specs,
    rmsnorm,
)
from repro_torch.sharding.context import (
    from_local,
    local_shard,
    reduce_over,
    region_placements,
    shard_reshape,
    split_dims,
)
from repro_torch.sharding.partition import P

NEG_INF = -1e30
NULL_PAGE = 0


# ---------------------------------------------------------------- ring cache


def make_kv_cache(batch: int, window: int, kv_dim: int, n_layers: int, dtype, device):
    """The bare stacked ring ``k/v [L, B, W, kv_dim]``, ``pos [L, B, W]``
    (empty); ``lm.make_cache`` builds the model-aware one (int8 planes,
    MLA's 1-wide v)."""
    return {
        "k": torch.zeros((n_layers, batch, window, kv_dim), dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, window, kv_dim), dtype=dtype, device=device),
        "pos": torch.full((n_layers, batch, window), -1, dtype=torch.int32, device=device),
    }


def kv_is_int8(cache_layer) -> bool:
    """True when the cache dict stores the int8 KV wire (scale planes)."""
    return "k_scale" in cache_layer


def quantize_kv(x: torch.Tensor):
    """Write-side KV quantization: one symmetric scale per token row."""
    return quant.quantize_rows(x)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    """Read-side KV dequantization (inverse of :func:`quantize_kv`)."""
    return quant.dequantize_rows(q, scale, dtype)


def kv_roundtrip(x: torch.Tensor, dtype=None):
    """``dequantize(quantize(x))`` per token row: what a cache write then
    a cache read returns."""
    q, s = quantize_kv(x)
    return dequantize_kv(q, s, dtype or x.dtype)


def ring_window(cache_layer, dtype):
    """The ring's read boundary: ``(k [B, W, Dk], v [B, W, Dv])`` in
    ``dtype``, each plane dequantized iff it carries a scale plane (MLA
    quantizes only the latent k)."""
    k, v = cache_layer["k"], cache_layer["v"]
    if "k_scale" in cache_layer:
        k = dequantize_kv(k, cache_layer["k_scale"], dtype)
    if "v_scale" in cache_layer:
        v = dequantize_kv(v, cache_layer["v_scale"], dtype)
    return k, v


def _write_slot(plane, slot: int, value) -> None:
    """``plane[:, slot] = value`` in place.  A ``DTensor`` plane is written
    on its local shard, by the rank whose window slice holds ``slot``,
    with ``value`` (``plane[:, slot]``'s shape) brought to the plane's
    placements."""
    if isinstance(plane, DTensor):
        mesh, pl = plane.device_mesh, plane.placements
        local = plane.to_local()
        w_l, shard = local.shape[1], 0
        for m, p in enumerate(pl):
            if p == Shard(1):
                shard = shard * mesh.size(m) + mesh.get_local_rank(m)
        if not shard * w_l <= slot < (shard + 1) * w_l:
            return
        if isinstance(value, torch.Tensor):
            v_pl = [Replicate() if not isinstance(p, Shard) or p.dim == 1
                    else Shard(p.dim - (p.dim > 1)) for p in pl]
            value = local_shard(value, mesh, v_pl)
        plane, slot = local, slot - shard * w_l
    plane[:, slot] = value


def _update_ring(cache_layer, new_k, new_v, pos: int, window: int) -> None:
    """Write one step (``[B, 1, D]``) at slot ``pos % window``, in place;
    under the int8 KV wire the row quantizes here."""
    slot = pos % window
    for name, new in (("k", new_k), ("v", new_v)):
        sname = name + "_scale"
        if sname in cache_layer:
            new, sc = quantize_kv(new)
            _write_slot(cache_layer[sname], slot, sc[:, 0])
        _write_slot(cache_layer[name], slot, new[:, 0].to(cache_layer[name].dtype))
    _write_slot(cache_layer["pos"], slot, pos)


def fill_ring(cache_layer, new_k, new_v, s: int, quantized=None) -> None:
    """Write a whole prompt (positions ``0..s-1``, ``[B, S, D]``) into the
    ring, in place: the last ``min(window, s)`` tokens at slots
    ``pos % window``, the state per-token stepping leaves behind.
    ``quantized`` maps a plane name to its precomputed ``(q, scale)``
    (prefill quantizes once and attends over the dequantization)."""
    window = cache_layer["k"].shape[1]
    take = min(window, s)
    sel = torch.arange(s - take, s, device=new_k.device)
    slots = sel % window
    for name, new in (("k", new_k), ("v", new_v)):
        sname = name + "_scale"
        if sname in cache_layer:
            if quantized is not None and name in quantized:
                new, sc = quantized[name]
            else:
                new, sc = quantize_kv(new)
            cache_layer[sname][:, slots] = sc[:, sel]
        cache_layer[name][:, slots] = new[:, sel].to(cache_layer[name].dtype)
    cache_layer["pos"][:, slots] = sel.to(torch.int32)


# ------------------------------------------ the window-sharded ring (flash-decode)


class ShardedRing(dict):
    """A ring cache, or one layer of it, whose attention planes hold this
    rank's shard ``[B / n_batch, W / n_model, ...]`` under ``ctx`` (the
    reference's ``cache_specs`` on the rank; a hybrid's ``ssm_state`` and
    ``ssm_conv`` stay whole, as its mixer runs outside the region).
    ``lm.make_cache`` decides the layout once (:func:`window_shards`);
    the attention ring paths follow the cache: prefill fills the rank's
    shard and decode runs :func:`flash_decode`."""

    def __init__(self, planes, ctx):
        super().__init__(planes)
        self.ctx = ctx


def ring_layer(cache, i: Optional[int] = None, names=None) -> dict:
    """Layer ``i``'s planes of a stacked ring cache (``i`` None: the
    planes as they are), only ``names`` when given, in the cache's
    layout (a :class:`ShardedRing` stays one)."""
    planes = {n: (p if i is None else p[i]) for n, p in cache.items()
              if names is None or n in names}
    return ShardedRing(planes, cache.ctx) if isinstance(cache, ShardedRing) else planes


def window_shards(cfg, ctx, batch: int, window: int) -> bool:
    """The reference's flash-decode guard (``repro/models/attention.py``,
    ``gqa_forward``), on the global shapes: a context is set, the
    attention is GQA over a full-precision ring, ``window`` divides over
    the model axis (at least one slot a shard) and ``batch`` over the
    batch axes.  Decode's ``s == 1`` always holds on the ring."""
    if ctx is None or cfg.family == "ssm" or cfg.mla is not None:
        return False
    if cfg.sparsity.kv_dtype == "int8":  # sharded int8 windows: not in the reference
        return False
    n = ctx.size(ctx.expert_axis)
    return window % n == 0 and window >= n and batch % ctx.size(ctx.batch_axes) == 0


def _shard_rows(cache_layer):
    """``(ctx, first global row, first global slot, global window)`` of a
    :class:`ShardedRing` layer."""
    ctx = cache_layer.ctx
    b_l, w_l = cache_layer["k"].shape[:2]
    n = ctx.size(ctx.expert_axis)
    return ctx, ctx.index(ctx.batch_axes) * b_l, ctx.index(ctx.expert_axis) * w_l, w_l * n


def fill_ring_shard(cache_layer, new_k, new_v, s: int) -> None:
    """:func:`fill_ring` of the global prompt ``[B, S, D]`` into this
    rank's shard: its rows, and of the last ``min(W, S)`` tokens those
    whose slot ``pos % W`` it holds."""
    ctx, r0, lo, w = _shard_rows(cache_layer)
    b_l, w_l = cache_layer["k"].shape[:2]
    sel = [p for p in range(max(0, s - w), s) if lo <= p % w < lo + w_l]
    if not sel:
        return
    idx = torch.tensor(sel, device=new_k.device)
    slots = idx % w - lo
    for name, new in (("k", new_k), ("v", new_v)):
        cache_layer[name][:, slots] = new[r0:r0 + b_l][:, idx].to(cache_layer[name].dtype)
    cache_layer["pos"][:, slots] = idx.to(torch.int32)


def flash_decode(q, cache_layer, new_k, new_v, decode_pos: int, window_mask):
    """Sequence-parallel decode attention over a :class:`ShardedRing`
    layer (the reference's ``flash_decode``; no kernel, as there).

    ``q [B, 1, H, D]``, ``new_k/new_v [B, 1, KV*D]`` are global; this rank
    takes its rows, writes the step's K/V if it owns slot ``pos % W``
    (``owner = slot // W_l``), attends over its ``W_l`` local slots with
    float32 logits and accumulators, and merges the partial softmax over
    the model axis with three reductions of ``[B_l, KV, G]``-sized
    tensors: the max, then the sums of ``l`` and of the output.  The
    output ``[B_l, 1, H, Dv]`` is all-gathered over the batch axes, so
    the caller gets the global ``[B, 1, H, Dv]``.

    On ``DTensor`` planes (the ring placed by ``lm.cache_specs``) the
    region works on their local shards and takes its rows of ``q`` and
    the step's K/V by their placements; the output leaves as a
    ``DTensor`` with its batch sharded, and is not gathered."""
    k_c, v_c, pos_c = cache_layer["k"], cache_layer["v"], cache_layer["pos"]
    dt = isinstance(k_c, DTensor)
    if dt:
        ctx, mesh, b_glob = cache_layer.ctx, k_c.device_mesh, q.shape[0]
        rows_pl = [Shard(0) if p == Shard(0) else Replicate() for p in k_c.placements]
        q, new_k, new_v = (local_shard(t, mesh, rows_pl) for t in (q, new_k, new_v))
        k_c, v_c, pos_c = k_c.to_local(), v_c.to_local(), pos_c.to_local()
        w_l = k_c.shape[1]
        r0, lo, w = 0, ctx.index(ctx.expert_axis) * w_l, w_l * ctx.size(ctx.expert_axis)
    else:
        ctx, r0, lo, w = _shard_rows(cache_layer)
    b_l, w_l, kvd = k_c.shape
    h, d = q.shape[2], q.shape[3]
    kv = kvd // d
    g = h // kv
    rows = slice(r0, r0 + b_l)
    slot = decode_pos % w
    if lo <= slot < lo + w_l:  # the owning shard writes the step
        k_c[:, slot - lo] = new_k[rows, 0].to(k_c.dtype)
        v_c[:, slot - lo] = new_v[rows, 0].to(v_c.dtype)
        pos_c[:, slot - lo] = decode_pos
    kk = k_c.reshape(b_l, w_l, kv, d)
    vv = v_c.reshape(b_l, w_l, kv, v_c.shape[-1] // kv)
    qg = q[rows].reshape(b_l, 1, kv, g, d)
    logits = einsum_f32("bskgd,btkd->bkgst", qg, kk) * (1.0 / math.sqrt(d))
    qpos = torch.full((b_l, 1), decode_pos, dtype=torch.int32, device=q.device)
    logits = logits + _mask_bias(qpos, pos_c, window_mask)[:, None, None, :, :]
    m = ctx.all_reduce(logits.amax(dim=-1, keepdim=True), dist.ReduceOp.MAX, ctx.expert_axis)
    p = torch.exp(logits - m)
    l_sum = ctx.all_reduce(p.sum(dim=-1, keepdim=True), dist.ReduceOp.SUM, ctx.expert_axis)
    o = ctx.all_reduce(einsum_f32("bkgst,btke->bskge", p.to(vv.dtype), vv),
                       dist.ReduceOp.SUM, ctx.expert_axis)  # [B_l, 1, KV, G, Dv]
    out = o / torch.clamp_min(l_sum[..., 0].permute(0, 3, 1, 2)[..., None], 1e-30)
    out = out.reshape(b_l, 1, h, -1).to(q.dtype)
    if dt:
        return from_local(out, mesh, rows_pl, (b_glob,) + tuple(out.shape[1:]))
    return ctx.all_gather(out, ctx.batch_axes, dim=0)


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
    in ``dtype`` (int8 planes dequantized).  Serving on a CUDA device
    does not materialize this window (``"auto"`` runs kernel #6 there);
    tests hold kernel #6's plain version against this path."""
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


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in f32: ``exp(x - max) / sum``,
    the sum in float64 on CUDA (a row's result then does not depend on the
    batch), in f32 on the CPU as in the reference."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    if e.device.type == "cuda":
        return e / e.double().sum(dim=-1, keepdim=True).float()
    return e / e.sum(dim=-1, keepdim=True)


def mha(q, k, v, q_pos, k_pos, *, window: Optional[int] = None,
        chunk: Optional[int] = None, softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention with position-derived causal/window masking;
    KV heads are never repeated.  q ``[B, S, H, D]``, k/v ``[B, T, KV, D]``,
    q_pos ``[B, S]``, k_pos ``[B, T]``.  Query-chunked above ``chunk``
    (when it divides S) to bound the ``[S, T]`` logits working set."""
    if isinstance(q, DTensor):
        return _mha_region(q, k, v, q_pos, k_pos, window=window, chunk=chunk,
                           softmax_scale=softmax_scale)
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = softmax_scale or 1.0 / math.sqrt(d)

    def block(qc, qp):
        sc = qc.shape[1]
        qg = qc.reshape(b, sc, kv, g, d)
        logits = einsum_f32("bskgd,btkd->bkgst", qg, k) * scale
        logits = logits + _mask_bias(qp, k_pos, window)[:, None, None, :, :]
        probs = _softmax(logits)
        out = einsum_f32("bkgst,btke->bskge", probs.to(v.dtype), v)
        return out.reshape(b, sc, h, v.shape[-1]).to(q.dtype)

    if chunk is None or s <= chunk or s % chunk != 0:
        return block(q, q_pos)
    return torch.cat([block(q[:, i:i + chunk], q_pos[:, i:i + chunk])
                      for i in range(0, s, chunk)], dim=1)


def _key_shards(t, dims=(1,)) -> list:
    """The mesh dims that shard ``t``'s key (window) dim, or any of
    ``dims``."""
    if not isinstance(t, DTensor):
        return []
    return [m for m, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim in dims]


def _softmax_merge(logits, values, mesh, pl, keys):
    """A softmax over keys split across the mesh dims ``keys`` (each rank
    holds its slice of the last dim of ``logits``): the max, the sum and
    ``values(p)`` combined over them, flash-decode's merge.  Returns
    ``(values(p) summed, the sum of p)``, both still to be divided.  The
    max is a shift the quotient does not depend on, taken without a
    gradient (each rank would see only its own keys' part of it)."""
    m = reduce_over(logits.detach().amax(dim=-1, keepdim=True), mesh, pl, keys, "max")
    p = torch.exp(logits - m)
    return (reduce_over(values(p), mesh, pl, keys, "sum"),
            reduce_over(p.sum(dim=-1, keepdim=True), mesh, pl, keys, "sum"))


def _mha_keys_region(q, k, v, q_pos, k_pos, keys, *, window=None, softmax_scale=None,
                     chunk=None):
    """:func:`mha` with the keys sharded over the mesh dims ``keys`` (a
    window-sharded ring that the flash-decode guard does not take): each
    rank attends over its own slots and the partial softmaxes merge
    (:func:`_softmax_merge`), so no K/V moves; the queries keep their
    batch shards and are whole on the key dims."""
    mesh = q.device_mesh
    qp = [Replicate() if m in keys or q.placements[m] != Shard(0) else Shard(0)
          for m in range(mesh.ndim)]
    kp = [Shard(1) if m in keys else qp[m] for m in range(mesh.ndim)]
    split = split_dims(qp, kp)
    ql, kl, vl = (local_shard(t, mesh, pl, split) for t, pl in ((q, qp), (k, kp), (v, kp)))
    b, s, h, d = ql.shape
    kv = kl.shape[2]
    logits = einsum_f32("bskgd,btkd->bkgst", ql.reshape(b, s, kv, h // kv, d), kl)
    logits = logits * (softmax_scale or 1.0 / math.sqrt(d)) + _mask_bias(
        local_shard(q_pos, mesh, qp), local_shard(k_pos, mesh, kp), window)[:, None, None]
    o, l_sum = _softmax_merge(
        logits, lambda p: einsum_f32("bkgst,btke->bskge", p.to(vl.dtype), vl), mesh, qp, keys)
    out = o / torch.clamp_min(l_sum[..., 0].permute(0, 3, 1, 2)[..., None], 1e-30)
    return from_local(out.reshape(b, s, h, -1).to(q.dtype), mesh, qp, q.shape[:3] + v.shape[3:])


def _mha_region(q, k, v, q_pos, k_pos, **kw):
    """:func:`mha` on ``DTensor`` queries as a region on local shards (as
    a ``shard_map`` runs it): the batch keeps its shards, the queries'
    sequence takes the other mesh dims where it divides (else they are
    replicated), keys, values and their positions are whole on every
    rank of those dims.  The output leaves the region with its heads
    over those dims where they divide (an all-to-all), else whole (an
    all-gather): the layouts the output projection takes."""
    mesh = q.device_mesh
    keys = _key_shards(k)
    if keys:
        out = _mha_keys_region(q, k, v, q_pos, k_pos, keys, **kw)
        return out.redistribute(mesh, region_placements(out, mesh, seq_dim=2))
    qp = region_placements(q, mesh, seq_dim=1)
    kp = region_placements(q, mesh)
    split = split_dims(qp, kp)
    out = mha(local_shard(q, mesh, qp, split), local_shard(k, mesh, kp, split),
              local_shard(v, mesh, kp, split), local_shard(q_pos, mesh, qp),
              local_shard(k_pos, mesh, kp), **kw)
    out = from_local(out, mesh, qp, q.shape[:3] + v.shape[3:])
    return out.redistribute(mesh, region_placements(out, mesh, seq_dim=2))


def _paged_attn_impl(sp, b: int, sg: int, ps: int, dk: int, device) -> str:
    """The paged read of this call site (the reference's
    ``_paged_attn_impl``): the explicit knob (``SparsityConfig.paged_attn``,
    threaded from ``ServeConfig.paged_attn``) wins; ``"auto"`` asks
    ``kernels/autotune`` (benchmark cache, then the device heuristic:
    fused on a CUDA device, gather elsewhere).  ``device`` is the cache's;
    a ``DTensor``'s is its local shard's."""
    mode = sp.paged_attn if sp is not None else "auto"
    if mode != "auto":
        return mode
    return autotune.get_paged_attn_impl(b, sg, ps, dk, device)


def _local_device(t: torch.Tensor) -> torch.device:
    return t.to_local().device if isinstance(t, DTensor) else t.device


def paged_attend(impl: str, q, cache_layer, page_tables, positions, *, kv_heads: int,
                 window: Optional[int], dtype) -> torch.Tensor:
    """GQA queries ``q [B, S, H, D]`` attend over their pages (this
    step's K/V and positions already written) by ``impl``: ``"gather"``
    materializes each row's window (:func:`paged_read`) for :func:`mha`,
    ``"fused"`` runs kernel #6 (``ops.paged_attention``)."""
    if impl == "gather":
        b, dh = q.shape[0], q.shape[-1]
        k_win, v_win, pos_win = paged_read(cache_layer, cache_layer["pos"], page_tables,
                                           dtype=dtype)
        t = k_win.shape[1]
        return mha(q, k_win.reshape(b, t, kv_heads, dh), v_win.reshape(b, t, kv_heads, dh),
                   positions, pos_win, window=window)
    return ops.paged_attention(
        q, cache_layer["k"], cache_layer["v"], cache_layer["pos"], page_tables, positions,
        kv_heads=kv_heads, window=window, k_scale=cache_layer.get("k_scale"),
        v_scale=cache_layer.get("v_scale"), out_dtype=dtype,
    )


def make_gqa(gen: torch.Generator, cfg, *, dtype, device, pack=lambda p: p):
    """Seeded GQA projections ``wq``/``wk``/``wv`` (with ``cfg.qkv_bias``)
    and ``wo``, each passed through ``pack`` as it is drawn."""
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()

    def lin(d_in, d_out, bias=False):
        return pack(make_linear(gen, d_in, d_out, bias=bias, dtype=dtype, device=device))

    return {"wq": lin(d, h * dh, cfg.qkv_bias), "wk": lin(d, kvh * dh, cfg.qkv_bias),
            "wv": lin(d, kvh * dh, cfg.qkv_bias), "wo": lin(h * dh, d)}


def gqa_specs(cfg) -> dict:
    """:func:`make_gqa`'s spec intent: Q/K/V over (data, model), ``wo``
    over (model, data)."""
    return {"wq": linear_specs(bias=cfg.qkv_bias), "wk": linear_specs(bias=cfg.qkv_bias),
            "wv": linear_specs(bias=cfg.qkv_bias), "wo": linear_specs(P(MODEL, DATA))}


def gqa_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor, *, layer_idx=None,
                cache_layer=None, decode_pos: Optional[int] = None, rope_cs=None,
                causal: bool = True, page_tables=None):
    """GQA: project (one shared DAP+pack for Q/K/V), RoPE, attend, project
    out.  The cache modes, as in the reference:

    * ``page_tables`` set: write this step's K/V into the pages, attend
      with the fused paged-attention kernel (#6) or, where the read
      resolves to gather (:func:`_paged_attn_impl`), :func:`paged_read` +
      :func:`mha`
      (``cache_layer["pos"]`` already holds this step's positions);
    * ring cache, no ``decode_pos``: single-pass prefill, full-sequence
      attention over the fresh K/V while they fill the ring;
    * ring cache and ``decode_pos``: write one step at its slot, attend
      over the ring window; over a window-sharded ring
      (:class:`ShardedRing`, made under a context) through
      :func:`flash_decode`, whose prefill fills the rank's shard;
    * no cache: full-sequence attention (``causal=False`` unmasks it)."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    sp, li = cfg.sparsity, layer_idx
    xin = common.maybe_pack_input(x, (p["wq"], p["wk"], p["wv"]), sp, li)
    q = shard_reshape(linear(p["wq"], xin, sparsity=sp, layer_idx=li), b, s, h, dh)
    k = shard_reshape(linear(p["wk"], xin, sparsity=sp, layer_idx=li), b, s, kvh, dh)
    v = shard_reshape(linear(p["wv"], xin, sparsity=sp, layer_idx=li), b, s, kvh, dh)
    cos, sin = rope_cs if rope_cs is not None else rope.rope_cos_sin(
        positions, dh, cfg.rope_theta
    )
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    k_flat, v_flat = k.reshape(b, s, kvh * dh), v.reshape(b, s, kvh * dh)
    chunk = cfg.attn_chunk if s > cfg.attn_chunk else None

    if page_tables is not None:
        paged_update(cache_layer, k_flat, v_flat, positions, page_tables)
        impl = _paged_attn_impl(sp, b, s * (h // kvh), cache_layer["k"].shape[1], dh,
                                _local_device(cache_layer["k"]))
        out = paged_attend(impl, q, cache_layer, page_tables, positions, kv_heads=kvh,
                           window=cfg.sliding_window, dtype=x.dtype)
    elif cache_layer is not None and decode_pos is None:
        pre = None
        if kv_is_int8(cache_layer):
            # quantize once: the ring stores these planes and attention
            # reads their dequantization, as stepped decode will
            qk, sk = quantize_kv(k_flat)
            qv, sv = quantize_kv(v_flat)
            pre = {"k": (qk, sk), "v": (qv, sv)}
            k = dequantize_kv(qk, sk, x.dtype).reshape(b, s, kvh, dh)
            v = dequantize_kv(qv, sv, x.dtype).reshape(b, s, kvh, dh)
        if isinstance(cache_layer, ShardedRing):
            fill_ring_shard(cache_layer, k_flat, v_flat, s)
        else:
            fill_ring(cache_layer, k_flat, v_flat, s, quantized=pre)
        out = mha(q, k, v, positions, positions, window=cfg.sliding_window, chunk=chunk)
    elif isinstance(cache_layer, ShardedRing):
        if s != 1:
            raise ValueError(f"a window-sharded ring decodes one token a step, got {s}")
        out = flash_decode(q, cache_layer, k_flat, v_flat, decode_pos, cfg.sliding_window)
    elif cache_layer is not None:
        window = cache_layer["k"].shape[1]
        _update_ring(cache_layer, k_flat, v_flat, decode_pos, window)
        kk, vv = ring_window(cache_layer, x.dtype)
        out = mha(q, shard_reshape(kk, b, window, kvh, dh), shard_reshape(vv, b, window, kvh, dh),
                  positions, cache_layer["pos"], window=cfg.sliding_window)
    else:
        k_pos = positions if causal else torch.zeros_like(positions)
        out = mha(q, k, v, positions, k_pos,
                  window=cfg.sliding_window if causal else None, chunk=chunk)
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


def mla_specs(cfg) -> dict:
    """:func:`make_mla`'s spec intent."""
    return {"q_down": linear_specs(P(DATA, None)), "q_norm": norm_specs(),
            "q_up": linear_specs(P(None, MODEL)), "kv_down": linear_specs(P(DATA, None)),
            "kv_norm": norm_specs(), "kv_up": linear_specs(P(None, MODEL)),
            "wo": linear_specs(P(MODEL, DATA))}


def _mla_absorb_q(q_nope, w_kv_up, m, out_dtype):
    """q absorbed through the k half of ``kv_up`` per head:
    ``[B, S, H, lora]``."""
    wk = w_kv_up[..., : m.qk_nope_head_dim]  # [lora, H, nope]
    return einsum_f32("bshn,lhn->bshl", q_nope, wk.to(q_nope.dtype)).to(out_dtype)


def _mla_up_project(ctx, w_kv_up, m, out_dtype):
    """The latent context through the v half of ``kv_up``:
    ``[B, S, H, dv]``."""
    wv = w_kv_up[..., m.qk_nope_head_dim:]  # [lora, H, dv]
    return einsum_f32("bshl,lhv->bshv", ctx.to(out_dtype), wv.to(out_dtype)).to(out_dtype)


def _mla_absorbed(q_nope, q_rope, lat, q_pos, k_pos, w_kv_up, m, scale, out_dtype):
    """Absorbed-form MLA over a latent window ``lat [B, T, lora+rope]``
    (the ``(c_kv ‖ k_rope)`` latent, from the ring or gathered from pages)
    with slot positions ``k_pos [B, T]``: q absorbs through ``kv_up`` per
    head, so the latent is never expanded.  Returns ``[B, S, H, dv]``.
    A ``DTensor`` window runs as a region (:func:`_mla_absorbed_region`)."""
    if isinstance(lat, DTensor):
        return _mla_absorbed_region(q_nope, q_rope, lat, q_pos, k_pos, w_kv_up, m, scale,
                                    out_dtype)
    lora = m.kv_lora_rank
    c_all, kr_all = lat[..., :lora], lat[..., lora:]
    q_abs = _mla_absorb_q(q_nope, w_kv_up, m, out_dtype)
    logits = (einsum_f32("bshl,btl->bhst", q_abs, c_all)
              + einsum_f32("bshr,btr->bhst", q_rope, kr_all)) * scale
    probs = _softmax(logits + _mask_bias(q_pos, k_pos, None)[:, None, :, :])
    ctx = einsum_f32("bhst,btl->bshl", probs.to(c_all.dtype), c_all)
    return _mla_up_project(ctx, w_kv_up, m, out_dtype)


def _mla_absorbed_region(q_nope, q_rope, lat, q_pos, k_pos, w_kv_up, m, scale, out_dtype):
    """:func:`_mla_absorbed` over a ``DTensor`` latent window as a region:
    a latent sharded on its latent dim (the reference's ``cache_specs``)
    moves to its window dim (an all-to-all: the ``c_kv ‖ k_rope`` split
    cuts across latent shards), each rank scores its own slots, and the
    partial softmaxes and contexts merge (:func:`_softmax_merge`).  The
    queries keep their batch shards; ``kv_up`` is whole on every rank."""
    mesh = lat.device_mesh
    keys = _key_shards(lat, dims=(1, 2))
    n = 1
    for mm in keys:
        n *= mesh.size(mm)
    if lat.shape[1] % n:
        keys = []
    qp = [Shard(0) if p == Shard(0) else Replicate() for p in lat.placements]
    kp = [Shard(1) if mm in keys else qp[mm] for mm in range(mesh.ndim)]
    split = split_dims(qp, kp)
    latl = local_shard(lat, mesh, kp, split)
    qn, qr = local_shard(q_nope, mesh, qp, split), local_shard(q_rope, mesh, qp, split)
    w = local_shard(w_kv_up, mesh, [Replicate()] * mesh.ndim, split)
    lora = m.kv_lora_rank
    c_all, kr_all = latl[..., :lora], latl[..., lora:]
    q_abs = _mla_absorb_q(qn, w, m, out_dtype)
    logits = (einsum_f32("bshl,btl->bhst", q_abs, c_all)
              + einsum_f32("bshr,btr->bhst", qr, kr_all)) * scale
    logits = logits + _mask_bias(local_shard(q_pos, mesh, qp), local_shard(k_pos, mesh, kp),
                                 None)[:, None, :, :]
    ctx, l_sum = _softmax_merge(
        logits, lambda p: einsum_f32("bhst,btl->bshl", p.to(c_all.dtype), c_all), mesh, qp,
        keys)
    out = _mla_up_project(ctx / l_sum.permute(0, 2, 1, 3), w, m, out_dtype)
    b_glob = q_nope.shape[0]
    return from_local(out, mesh, qp, (b_glob,) + tuple(out.shape[1:]))


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


def paged_attend_latent(impl: str, q_nope, q_rope, cache_layer, page_tables, positions,
                        w_kv_up, m, scale: float, dtype) -> torch.Tensor:
    """MLA's absorbed attention over latent pages by ``impl``: ``"gather"``
    materializes each row's latent window (:func:`paged_read`) for
    :func:`_mla_absorbed`, ``"fused"`` runs kernel #6's latent mode
    (:func:`_mla_absorbed_fused`)."""
    if impl == "gather":
        lat, _, pos_win = paged_read(cache_layer, cache_layer["pos"], page_tables, dtype=dtype)
        return _mla_absorbed(q_nope, q_rope, lat, positions, pos_win, w_kv_up, m, scale, dtype)
    return _mla_absorbed_fused(q_nope, q_rope, cache_layer, page_tables, positions, w_kv_up, m,
                               scale, dtype)


def mla_forward(p, x: torch.Tensor, cfg, positions: torch.Tensor, *, layer_idx=None,
                cache_layer=None, decode_pos: Optional[int] = None, page_tables=None):
    """MLA.  The two down-projections share one DAP+pack, RoPE rotates the
    ``qk_rope`` dims with one shared k head, and the cache stores the
    ``(c_kv ‖ k_rope)`` latent (a 1-wide zero dummy in the v planes).
    Logits scale by ``1/sqrt(qk_nope + qk_rope)``.  The cache modes:

    * ``page_tables`` set: write the latent into the pages, attend
      absorbed through the fused kernel's latent mode (#6) or, where the
      read resolves to gather (:func:`_paged_attn_impl`), over the
      gathered window;
    * ring cache, no ``decode_pos``: fill the ring with the latent, then
      the materialized attention (under int8 KV over the latent's
      round trip);
    * ring cache and ``decode_pos``: write one step, attend absorbed over
      the ring window;
    * no cache: materialized per-head K/V and :func:`mha`."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    sp, li = cfg.sparsity, layer_idx
    qk_rope, qk_nope, dv = m.qk_rope_head_dim, m.qk_nope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)

    xin = common.maybe_pack_input(x, (p["q_down"], p["kv_down"]), sp, li)
    cq = rmsnorm(linear(p["q_down"], xin, sparsity=sp, layer_idx=li), p["q_norm"])
    q = shard_reshape(linear(p["q_up"], cq, sparsity=sp, layer_idx=li), b, s, h, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    cos, sin = rope.rope_cos_sin(positions, qk_rope, cfg.rope_theta)
    q_rope = rope.apply_rope(q_rope, cos, sin)

    kv = linear(p["kv_down"], xin, sparsity=sp, layer_idx=li)
    c_kv = rmsnorm(kv[..., : m.kv_lora_rank], p["kv_norm"])
    k_rope = rope.apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :], cos, sin)[:, :, 0, :]

    w_kv_up = shard_reshape(p["kv_up"]["w"], m.kv_lora_rank, h, qk_nope + dv)
    latent = torch.cat([c_kv, k_rope], dim=-1)
    dummy_v = torch.zeros((b, s, 1), dtype=latent.dtype, device=latent.device)

    if page_tables is not None:
        paged_update(cache_layer, latent, dummy_v, positions, page_tables)
        impl = _paged_attn_impl(sp, b, s * h, cache_layer["k"].shape[1],
                                m.kv_lora_rank + qk_rope, _local_device(cache_layer["k"]))
        out = paged_attend_latent(impl, q_nope, q_rope, cache_layer, page_tables, positions,
                                  w_kv_up, m, scale, x.dtype)
        return linear(p["wo"], out.reshape(b, s, h * dv), sparsity=sp, layer_idx=li)

    if cache_layer is not None and decode_pos is not None:
        window = cache_layer["k"].shape[1]
        _update_ring(cache_layer, latent, dummy_v, decode_pos, window)
        lat_win, _ = ring_window(cache_layer, x.dtype)
        out = _mla_absorbed(q_nope, q_rope, lat_win, positions, cache_layer["pos"],
                            w_kv_up, m, scale, x.dtype)
        return linear(p["wo"], out.reshape(b, s, h * dv), sparsity=sp, layer_idx=li)

    if cache_layer is not None:
        pre = None
        if kv_is_int8(cache_layer):
            # quantize the latent once: the ring stores it and the
            # materialized attention reads its dequantization
            ql, sl = quantize_kv(latent)
            pre = {"k": (ql, sl)}
            lat_rt = dequantize_kv(ql, sl, x.dtype)
            c_kv, k_rope = lat_rt[..., : m.kv_lora_rank], lat_rt[..., m.kv_lora_rank:]
        fill_ring(cache_layer, latent, dummy_v, s, quantized=pre)

    kv_up = einsum_f32("btl,lhe->bthe", c_kv, w_kv_up.to(c_kv.dtype)).to(c_kv.dtype)
    k_nope, v = kv_up[..., :qk_nope], kv_up[..., qk_nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qk_rope)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    out = mha(qq, k, v, positions, positions,
              chunk=cfg.attn_chunk if s > cfg.attn_chunk else None, softmax_scale=scale)
    return linear(p["wo"], out.reshape(b, s, h * dv), sparsity=sp, layer_idx=li)


# --------------------------------------------------------------- cross-attn


def make_cross_attn(gen: torch.Generator, cfg, *, dtype, device, pack=lambda p: p):
    """Seeded cross-attention projections (no bias), each through ``pack``."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim()

    def lin(d_in, d_out):
        return pack(make_linear(gen, d_in, d_out, dtype=dtype, device=device))

    return {"wq": lin(d, h * dh), "wk": lin(d, h * dh), "wv": lin(d, h * dh),
            "wo": lin(h * dh, d)}


def cross_attn_specs() -> dict:
    """:func:`make_cross_attn`'s spec intent."""
    return {"wq": linear_specs(), "wk": linear_specs(), "wv": linear_specs(),
            "wo": linear_specs(P(MODEL, DATA))}


def cross_attn_forward(p, x: torch.Tensor, enc_kv: torch.Tensor, cfg, *,
                       layer_idx=None) -> torch.Tensor:
    """``x [B, S, d]`` attends to the encoder output ``enc_kv [B, T, d]``,
    unmasked.  ``wk`` and ``wv`` share one DAP+pack of ``enc_kv``; the
    encoder output is projected anew at every call, as in the reference."""
    b, s, _ = x.shape
    t = enc_kv.shape[1]
    h, dh = cfg.n_heads, cfg.head_dim()
    sp, li = cfg.sparsity, layer_idx
    kvin = common.maybe_pack_input(enc_kv, (p["wk"], p["wv"]), sp, li)
    q = shard_reshape(linear(p["wq"], x, sparsity=sp, layer_idx=li), b, s, h, dh)
    k = shard_reshape(linear(p["wk"], kvin, sparsity=sp, layer_idx=li), b, t, h, dh)
    v = shard_reshape(linear(p["wv"], kvin, sparsity=sp, layer_idx=li), b, t, h, dh)
    qp = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kp = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    out = mha(q, k, v, qp, kp)
    return linear(p["wo"], out.reshape(b, s, h * dh), sparsity=sp, layer_idx=li)
