"""Mixture-of-Experts FFN with group-local capacity dispatch (port of
``repro.models.moe``): the grouped path on one process, the
expert-parallel region under a distribution context.

Routing runs independently per token group (``n_groups``, 1 on one
device).  DAP prunes the input once before the router (kernel #5 on CUDA
tensors); the router scores in float32, each token takes its ``top_k``
experts (ties to the lower expert index) with renormalized weights, and
slot ``s`` of expert ``e`` goes to the ``s``-th (token, k) pair routed to
``e`` in flat order — pairs past the capacity are dropped.  So a token's
output depends on the tokens it is batched with: compare MoE outputs only
at identical batch shapes.  The expert products are dense batched
einsums over ``[E, d, f]`` weights, outside any kernel, as in the
reference.  Under a context each rank holds its ``E / n`` experts and the
dispatched rows cross ranks in two all-to-alls.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.dap import apply_dap
from repro_torch.kernels.epilogue import apply_act
from repro_torch.models.common import DATA, MODEL
from repro_torch.sharding import context
from repro_torch.sharding.context import get_context
from repro_torch.sharding.partition import P


def make_moe(gen: torch.Generator, cfg, dtype=torch.bfloat16, device="cuda"):
    """Seeded ``{"router": {"w" [d, E] f32}, "gate"/"up" [E, d, f],
    "down" [E, f, d]}`` with the reference's scale rules; the expert
    weights stay dense in ``dtype`` (serving never packs them)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def draw(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w * scale

    return {
        "router": {"w": draw((d, e), 1.0 / math.sqrt(d))},
        "gate": draw((e, d, f), 1.0 / math.sqrt(d)).to(dtype),
        "up": draw((e, d, f), 1.0 / math.sqrt(d)).to(dtype),
        "down": draw((e, f, d), 1.0 / math.sqrt(f)).to(dtype),
    }


def moe_specs() -> dict:
    """:func:`make_moe`'s spec intent: the experts over ``model`` (expert
    parallelism), their ``d`` dims over ``data``; the router replicated."""
    return {"router": {"w": P(None, None)}, "gate": P(MODEL, DATA, None),
            "up": P(MODEL, DATA, None), "down": P(MODEL, None, DATA)}


def expert_local_specs() -> dict:
    """What a rank holds of :func:`make_moe`'s tree under a context: the
    expert leaves as its slice of ``model`` (the in-specs of the
    expert-parallel region), the router whole."""
    e = P(MODEL, None, None)
    return {"gate": e, "up": e, "down": e}


def capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)  # pad to 8 for tiling


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index.
    ``torch.topk`` promises no tie order; a stable descending sort keeps
    equal values in index order, so routing depends on the probabilities
    alone."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(xt, top_e, top_p, e: int, k: int, cap: int):
    """Every group at once: ``xt [G, T, d]``, ``top_e/top_p [G, T, K]`` ->
    ``(buf [G, E*C, d], dest [G, T*K], keep [G, T*K], w [G, T*K])``."""
    g, t, d = xt.shape
    flat_e = top_e.reshape(g, t * k)
    onehot = F.one_hot(flat_e, e)  # [G, T*K, E] int64
    ranks = torch.cumsum(onehot, dim=1) - onehot  # earlier same-expert pairs
    slot = (onehot * ranks).sum(dim=-1)
    keep = slot < cap
    dest = torch.where(keep, flat_e * cap + slot, torch.full_like(slot, e * cap))
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    # the reference adds each row onto a zero buffer (0 + x: a -0.0 lands
    # as +0.0); destinations are unique except the overflow slot, which
    # only ever receives zeros, so a plain scatter is exact and
    # deterministic
    rows = torch.where(keep[..., None], xt[:, tok] + 0.0, 0.0)
    buf = torch.zeros((g, e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.scatter_(1, dest[..., None].expand(g, t * k, d), rows)
    return buf[:, : e * cap], dest, keep, top_p.reshape(g, t * k)


def moe_forward(p, x: torch.Tensor, cfg, *, layer_idx=None, n_groups: int = 1):
    """``x [B, S, d]`` -> ``(y [B, S, d], aux_loss scalar)``; ``n_groups``
    must divide B (it is lowered until it does).  Under a distribution
    context the expert-parallel region runs instead
    (:func:`_moe_forward_expert_parallel`)."""
    ctx = get_context()
    if ctx is not None:
        return _moe_forward_expert_parallel(p, x, cfg, ctx, layer_idx=layer_idx)
    m = cfg.moe
    b, s, d = x.shape
    g = max(1, min(n_groups, b))
    while b % g:
        g -= 1
    t = b * s // g  # tokens per group
    e, k = m.n_experts, m.top_k
    sp = cfg.sparsity

    xt = x.reshape(g, t, d)
    if sp is not None and sp.mode == "awdbb":
        spec = sp.a_spec(layer_idx)
        if spec is not None and d % spec.bz == 0:
            xt = apply_dap(xt, spec)

    logits = torch.matmul(xt.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)  # [G, T, K]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    cap = capacity(t, cfg)
    buf, dest, keep, w_flat = _dispatch(xt, top_e, top_p, e, k, cap)
    buf = buf.reshape(g, e, cap, d)

    if cfg.mlp_act == "swiglu":
        gate = torch.einsum("gecd,edf->gecf", buf, p["gate"].to(buf.dtype))
        up = torch.einsum("gecd,edf->gecf", buf, p["up"].to(buf.dtype))
        h = apply_act(gate, "silu") * up
    else:
        h = apply_act(torch.einsum("gecd,edf->gecf", buf, p["up"].to(buf.dtype)), "gelu")
    out_buf = torch.einsum("gecf,efd->gecd", h, p["down"].to(h.dtype))
    out_flat = out_buf.reshape(g, e * cap, d)

    # combine: a gather back to the (token, k) pairs, then a sum over k
    idx = torch.clamp_max(dest, e * cap - 1)
    gathered = torch.gather(out_flat, 1, idx[..., None].expand(g, t * k, d))
    gathered = torch.where(keep[..., None], gathered, 0.0)
    gathered = gathered * w_flat[..., None].to(out_flat.dtype)
    y = gathered.reshape(g, t, k, d).sum(dim=2)

    # switch-style load-balance aux loss
    frac_tokens = F.one_hot(top_e, e).float().sum(dim=2).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens / k * frac_probs) * m.router_aux_weight
    return y.reshape(b, s, d).to(x.dtype), aux


def _experts(p, buf, cfg):
    """The expert FFN over ``buf [E_loc, C, d]`` (dense einsums)."""
    if cfg.mlp_act == "swiglu":
        g_ = torch.einsum("ecd,edf->ecf", buf, p["gate"].to(buf.dtype))
        u_ = torch.einsum("ecd,edf->ecf", buf, p["up"].to(buf.dtype))
        h = apply_act(g_, "silu") * u_
    else:
        h = apply_act(torch.einsum("ecd,edf->ecf", buf, p["up"].to(buf.dtype)), "gelu")
    return torch.einsum("ecf,efd->ecd", h, p["down"].to(h.dtype))


def _moe_forward_expert_parallel(p, x: torch.Tensor, cfg, ctx, *, layer_idx=None):
    """Expert parallelism (the reference's ``_moe_forward_shard_map``):
    DAP on the global ``x``, then on this rank's tokens (its batch rows,
    and its sequence slice over the expert axis when ``S`` divides)
    local routing, top-k and ``capacity(t_l)`` dispatch; an all-to-all
    over the expert axis turns ``[E, C, d]`` into ``[E_loc, n*C, d]``
    (source ranks concatenated in order); the local experts; the reverse
    all-to-all; the combine as a scatter-add over the tokens.  The aux
    loss is averaged over every rank, and ``y`` all-gathered back to the
    global ``[B, S, d]``.  ``p``'s expert leaves are this rank's
    ``E / n`` slice (``lm.local_specs``).

    On ``DTensor`` operands (leaves placed by ``moe_specs``) the region
    takes local shards instead: its batch rows of ``x``, its experts
    (gathered over the other mesh dims), the router whole; ``y`` leaves
    as a ``DTensor`` with its batch sharded (its sequence gathered over
    the expert axis by DTensor), ``aux`` replicated."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    ea, ba = ctx.expert_axis, ctx.batch_axes
    n, nb = ctx.size(ea), ctx.size(ba)
    e_loc = e // n
    if e_loc * n != e:
        raise ValueError(f"{e} experts do not divide over {n} expert shards")
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    if mesh is not None:
        names = mesh.mesh_dim_names
        rows_pl = [Shard(0) if a in ba else Replicate() for a in names]
        exp_pl = [Shard(0) if a == ea else Replicate() for a in names]
        split = context.split_dims(rows_pl, exp_pl)
        whole = [Replicate()] * len(names)
        p = {"router": {"w": context.local_shard(p["router"]["w"], mesh, whole, split)},
             **{w: context.local_shard(p[w], mesh, exp_pl, split)
                for w in ("gate", "up", "down") if w in p}}
    if p["up"].shape[0] != e_loc:
        raise ValueError(f"expert leaves hold {p['up'].shape[0]} experts, this rank's slice is "
                         f"{e_loc}: place them with partition.local_tree(lm.local_specs(cfg))")
    if b % nb:
        raise ValueError(f"batch {b} does not divide over {nb} batch shards")
    sp = cfg.sparsity
    if sp is not None and sp.mode == "awdbb":
        spec = sp.a_spec(layer_idx)
        if spec is not None and d % spec.bz == 0:
            x = apply_dap(x, spec)

    # the sequence too is sliced over the expert axis, so every rank
    # dispatches distinct tokens (else each expert shard would dispatch
    # the same ones and the all-to-all carry n duplicates)
    seq_split = s % n == 0 and s >= n
    b_l, r = b // nb, ctx.index(ba)
    x_l = (context.local_shard(x, mesh, rows_pl, split) if mesh is not None
           else x[r * b_l:(r + 1) * b_l])
    if seq_split:
        s_l, j = s // n, ctx.index(ea)
        x_l = x_l[:, j * s_l:(j + 1) * s_l]
    sl = x_l.shape[1]
    t_l = b_l * sl
    xt = x_l.reshape(1, t_l, d)
    logits = torch.matmul(xt.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    cap = capacity(t_l, cfg)
    buf, dest, keep, w_flat = _dispatch(xt, top_e, top_p, e, k, cap)
    # [E, C, d] -> [n (source), E_loc, C, d] -> [E_loc, n*C, d]
    buf = ctx.all_to_all(buf.reshape(e, cap, d), ea)
    buf = buf.reshape(n, e_loc, cap, d).transpose(0, 1).reshape(e_loc, n * cap, d)
    out = _experts(p, buf, cfg)
    # [E_loc, n*C, d] -> [n (destination), E_loc, C, d] -> every expert's rows: [E*C, d]
    out = ctx.all_to_all(out.reshape(e_loc, n, cap, d).transpose(0, 1), ea)
    out_flat = out.reshape(e * cap, d)
    idx = torch.clamp(dest[0], 0, e * cap - 1)
    gathered = torch.where(keep[0][:, None], out_flat[idx], 0.0)
    gathered = (gathered * w_flat[0][:, None].to(out_flat.dtype)).reshape(t_l, k, d)
    # the reference's scatter-add over tok (each token's k rows added onto
    # zero in k order, rounding after each add), as k ordered adds:
    # index_add_ on the card adds with atomics in no fixed order
    y_l = torch.zeros((t_l, d), dtype=out_flat.dtype, device=x.device)
    for j in range(k):
        y_l = y_l + gathered[:, j]
    frac_tokens = F.one_hot(top_e[0], e).float().sum(dim=1).mean(dim=0)
    frac_probs = probs[0].mean(dim=0)
    aux = e * torch.sum(frac_tokens / k * frac_probs) * m.router_aux_weight
    aux = ctx.all_reduce(aux.reshape(1), dist.ReduceOp.SUM, ba) / nb
    aux = (ctx.all_reduce(aux, dist.ReduceOp.SUM, ea) / n).reshape(())
    y = y_l.reshape(b_l, sl, d)
    if mesh is not None:
        # the sequence gathered over the expert axis by DTensor, whose
        # backward takes each rank's slice of the (replicated) gradient
        y_pl = [Shard(1) if a == ea and seq_split else pl for a, pl in zip(names, rows_pl)]
        y = context.from_local(y.to(x.dtype), mesh, y_pl, (b, s, d))
        return (y.redistribute(mesh, rows_pl),
                context.from_local(aux, mesh, [Replicate()] * mesh.ndim, ()))
    if seq_split:
        y = ctx.all_gather(y, ea, dim=1)
    y = ctx.all_gather(y, ba, dim=0)
    return y.to(x.dtype), aux
