"""Mixture-of-Experts FFN with group-local capacity dispatch (port of the
single-device half of ``repro.models.moe``).

Routing runs independently per token group (``n_groups``, 1 on one
device).  DAP prunes the input once before the router (kernel #5 on CUDA
tensors); the router scores in float32, each token takes its ``top_k``
experts (ties to the lower expert index) with renormalized weights, and
slot ``s`` of expert ``e`` goes to the ``s``-th (token, k) pair routed to
``e`` in flat order — pairs past the capacity are dropped.  So a token's
output depends on the tokens it is batched with: compare MoE outputs only
at identical batch shapes.  The expert products are dense batched
einsums over ``[E, d, f]`` weights, outside any kernel, as in the
reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.dap import apply_dap
from repro_torch.kernels.epilogue import apply_act


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
    must divide B (it is lowered until it does)."""
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
