"""Mamba2 mixer (port of ``repro.models.ssm``): the SSD (state-space
duality) algorithm, arXiv:2405.21060.

Forward and prefill take the chunked SSD form: a quadratic,
attention-like term within each chunk and a linear state recurrence
across chunks.  Decode is the O(1) recurrent update of ``state [B, H, P,
N]`` (f32) and a small causal-conv ring ``conv [B, K-1, C]``, both
written in place, like the attention caches.

The in/out projections are DBB-aware linears (``common.linear``: DAP and
the W-DBB kernels on packed weights); the scan, the convolution and the
recurrence are plain PyTorch, as they are plain JAX in the reference.
Their roundings follow the reference's: the intra-chunk tensors are in
the model dtype and the einsums accumulate wider (here in float64, one
rounding, so that a row's result does not depend on the batch:
``common.einsum_f32``); ``scores`` and the conv taps round to the model
dtype where the reference's do.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.epilogue import apply_act
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
from repro_torch.sharding import context
from repro_torch.sharding.partition import P


def conv_dim(cfg) -> int:
    s = cfg.ssm
    return s.d_inner(cfg.d_model) + 2 * s.ngroups * s.d_state


def make_mamba2(gen: torch.Generator, cfg, *, dtype, device, pack=lambda p: p):
    """Seeded mixer parameters with the reference's shapes and scale rules:
    ``in_proj``/``out_proj`` ``N(0, 1/d_in)`` (each passed through
    ``pack``), ``conv_w`` ``N(0, 0.2^2)``, ``conv_b`` and ``dt_bias`` zero,
    ``A_log`` zero (A = -1), ``D`` one, the gated norm's scale one."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh, cd = s.d_inner(d), s.n_heads(d), conv_dim(cfg)
    d_in_proj = 2 * di + 2 * s.ngroups * s.d_state + nh
    params = {"in_proj": pack(make_linear(gen, d, d_in_proj, dtype=dtype, device=device))}
    conv_w = torch.randn((s.d_conv, cd), generator=gen, dtype=torch.float32, device=device)
    params["conv_w"] = (conv_w * 0.2).to(dtype)
    params["conv_b"] = torch.zeros((cd,), dtype=dtype, device=device)
    params["A_log"] = torch.zeros((nh,), dtype=torch.float32, device=device)
    params["D"] = torch.ones((nh,), dtype=torch.float32, device=device)
    params["dt_bias"] = torch.zeros((nh,), dtype=torch.float32, device=device)
    params["norm"] = make_norm(di, device=device)
    params["out_proj"] = pack(make_linear(gen, di, d, dtype=dtype, device=device))
    return params


def mamba2_specs() -> dict:
    """:func:`make_mamba2`'s spec intent."""
    return {"in_proj": linear_specs(), "conv_w": P(None, MODEL), "conv_b": P(MODEL),
            "A_log": P(None), "D": P(None), "dt_bias": P(None), "norm": norm_specs(),
            "out_proj": linear_specs(P(MODEL, DATA))}


def ssm_cache_specs() -> dict:
    """:func:`make_ssm_cache`'s spec intent (stacked ``[L, ...]``)."""
    return {"state": P(None, DATA, None, None, None), "conv": P(None, DATA, None, MODEL)}


def make_ssm_cache(batch: int, cfg, n_layers: int, dtype, device):
    """Zero recurrent state ``[L, B, H, P, N]`` (f32) and conv ring
    ``[L, B, K-1, C]`` (model dtype)."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    return {
        "state": torch.zeros((n_layers, batch, nh, s.headdim, s.d_state), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_layers, batch, s.d_conv - 1, conv_dim(cfg)), dtype=dtype,
                            device=device),
    }


def _split_zxbcdt(zxbcdt, cfg):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gs = s.ngroups * s.d_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gs], zxbcdt[..., 2 * di + 2 * gs:]


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv over the sequence, ``xbc [B, S, C]``, ``conv_w
    [K, C]``: the reference's sum of shifted taps, each product and each
    partial sum rounded to the model dtype in the same order."""
    k, s = conv_w.shape[0], xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * conv_w[i]
    return apply_act(out + conv_b, "silu")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _decode(p, zxbcdt_parts, cfg, cache_layer, out_dtype):
    """The O(1) recurrent step: updates ``cache_layer`` in place and
    returns the gated, normed ``y [B, 1, d_inner]``."""
    z, xbc, dt = zxbcdt_parts
    s_cfg = cfg.ssm
    b = xbc.shape[0]
    di = s_cfg.d_inner(cfg.d_model)
    nh, hd, ds, g = s_cfg.n_heads(cfg.d_model), s_cfg.headdim, s_cfg.d_state, s_cfg.ngroups
    A = -torch.exp(p["A_log"])
    conv_buf = torch.cat([cache_layer["conv"], xbc], dim=1)  # [B, K, C]
    kk = p["conv_w"].shape[0]
    taps = conv_buf[:, -kk:].float()
    w = p["conv_w"].float()
    acc = taps[:, 0] * w[0]
    for i in range(1, kk):  # the einsum's f32 sum over the K taps, in order
        acc = acc + taps[:, i] * w[i]
    xbc_t = apply_act(acc.to(xbc.dtype) + p["conv_b"], "silu")
    x_, B_, C_ = xbc_t[:, :di], xbc_t[:, di:di + g * ds], xbc_t[:, di + g * ds:]
    xh = x_.reshape(b, nh, hd).float()
    rep = nh // g
    Bh = B_.reshape(b, g, ds).float().repeat_interleave(rep, dim=1)  # [B, H, N]
    Ch = C_.reshape(b, g, ds).float().repeat_interleave(rep, dim=1)
    dt1 = dt[:, 0, :]  # [B, H]
    decay = torch.exp(dt1 * A[None, :])
    state = cache_layer["state"] * decay[..., None, None] + (
        (dt1[..., None] * xh)[..., None] * Bh[:, :, None, :]
    )
    y = einsum_f32("bhpn,bhn->bhp", state, Ch) + p["D"][None, :, None] * xh
    cache_layer["state"].copy_(state)
    cache_layer["conv"].copy_(conv_buf[:, 1:])
    return y.reshape(b, 1, di).to(out_dtype)


def _chunked(p, xbc, dt, cfg, s: int, cdt):
    """The chunked SSD scan over ``s`` tokens: ``y [B, S, d_inner]`` in
    ``cdt`` (before the gate and norm)."""
    s_cfg = cfg.ssm
    b = xbc.shape[0]
    di = s_cfg.d_inner(cfg.d_model)
    nh, hd, ds, g = s_cfg.n_heads(cfg.d_model), s_cfg.headdim, s_cfg.d_state, s_cfg.ngroups
    A = -torch.exp(p["A_log"])
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    q = min(s_cfg.chunk, s)
    pad = (q - s % q) % q  # causal: end padding never reaches a real output
    s_p = s + pad
    if pad:
        xbc = torch.nn.functional.pad(xbc, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    x_ = xbc[..., :di].reshape(b, s_p, nh, hd)
    B_ = xbc[..., di:di + g * ds].reshape(b, s_p, g, ds)
    C_ = xbc[..., di + g * ds:].reshape(b, s_p, g, ds)
    rep, nc = nh // g, s_p // q

    xf = x_.reshape(b, nc, q, nh, hd).to(cdt)
    Bf = B_.reshape(b, nc, q, g, ds).to(cdt)
    Cf = C_.reshape(b, nc, q, g, ds).to(cdt)
    dtf = dt.reshape(b, nc, q, nh)  # f32: the decay math stays f32
    cum = torch.cumsum(dtf * A, dim=2)  # [B, nc, Q, H] log-decay, <= 0

    # the intra-chunk quadratic term, every [B, nc, H, Q, Q] tensor in cdt
    Br = Bf.repeat_interleave(rep, dim=3)  # [B, nc, Q, H, N]
    Cr = Cf.repeat_interleave(rep, dim=3)
    scores = einsum_f32("bcthn,bcshn->bchts", Cr, Br).to(cdt)
    cum_h = cum.permute(0, 1, 3, 2)  # [B, nc, H, Q]
    decay_mat = torch.exp(
        torch.clamp(cum_h[..., :, None] - cum_h[..., None, :], -60.0, 0.0)
    ).to(cdt)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xbc.device))
    dt_h = dtf.permute(0, 1, 3, 2).to(cdt)
    scores = scores * decay_mat * tri * dt_h[..., None, :]
    y_intra = einsum_f32("bchts,bcshp->bcthp", scores, xf)

    # each chunk's state: sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
    decay_to_end = torch.exp(torch.clamp(cum[:, :, -1:, :] - cum, -60.0, 0.0))
    wgt = (decay_to_end * dtf).to(cdt)
    chunk_state = einsum_f32("bcshp,bcshn->bchpn", xf * wgt[..., None], Br)

    # the recurrence across chunks, emitting the state entering each chunk
    total = torch.exp(torch.clamp(cum[:, :, -1, :], -60.0, 0.0))  # [B, nc, H]
    h = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=xbc.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * total[:, c, :, None, None] + chunk_state[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B, nc, H, P, N]

    c_decayed = (Cr.float() * torch.exp(torch.clamp(cum, -60.0, 0.0))[..., None]).to(cdt)
    y_inter = einsum_f32("bcthn,bchpn->bcthp", c_decayed, h_in.to(cdt))
    y = (y_intra + y_inter).reshape(b, s_p, nh, hd)[:, :s]
    y = y + p["D"][None, None, :, None] * x_[:, :s].float()
    return y.reshape(b, s, di).to(cdt)


def mamba2_forward(p, u: torch.Tensor, cfg, *, layer_idx=None, cache_layer=None) -> torch.Tensor:
    """``u [B, S, d] -> y [B, S, d]``.  With ``cache_layer`` (``{"state"
    [B, H, P, N] f32, "conv" [B, K-1, C]}``, S == 1) one decode step,
    the cache written in place; without, the chunked scan."""
    sp, li = cfg.sparsity, layer_idx
    zxbcdt = linear(p["in_proj"], u, sparsity=sp, layer_idx=li)
    mixer = _mixer_region if isinstance(zxbcdt, DTensor) else _mixer
    y = mixer(p, zxbcdt, cfg, cache_layer, u.dtype)
    return linear(p["out_proj"], y, sparsity=sp, layer_idx=li)


def _mixer(p, zxbcdt, cfg, cache_layer, out_dtype):
    """Between the two projections: the conv, the scan (or the recurrent
    step over ``cache_layer``), the gate and the gated norm."""
    s = zxbcdt.shape[1]
    z, xbc, dt = _split_zxbcdt(zxbcdt, cfg)
    dt = _softplus(dt.float() + p["dt_bias"])  # [B, S, H]
    if cache_layer is not None:
        if s != 1:
            raise ValueError(f"the recurrent step takes one token, got S={s}")
        y = _decode(p, (z, xbc, dt), cfg, cache_layer, out_dtype)
    else:
        y = _chunked(p, xbc, dt, cfg, s, out_dtype)
    return rmsnorm(y * apply_act(z, "silu"), p["norm"], cfg.norm_eps)


_MIXER_LEAVES = ("conv_w", "conv_b", "A_log", "D", "dt_bias")


def _mixer_region(p, zxbcdt, cfg, cache_layer, out_dtype):
    """:func:`_mixer` on ``DTensor`` operands, as a region on local
    shards: the batch keeps its shards and every head is whole on each
    rank (the heads rarely divide the model axis: 24 for mamba2-130m), so
    the in-projection's output is gathered over the other mesh dims.  The
    recurrent planes are read at those placements and written back to
    their own."""
    mesh = zxbcdt.device_mesh
    rows = [Shard(0) if pl == Shard(0) else Replicate() for pl in zxbcdt.placements]
    whole = [Replicate()] * mesh.ndim
    split = context.split_dims(rows)
    p_loc = {k: context.local_shard(p[k], mesh, whole, split) for k in _MIXER_LEAVES}
    p_loc["norm"] = {"scale": context.local_shard(p["norm"]["scale"], mesh, whole, split)}
    c_loc = None
    if cache_layer is not None:
        c_loc = {n: context.local_shard(cache_layer[n], mesh, rows) for n in ("state", "conv")}
    y = _mixer(p_loc, context.local_shard(zxbcdt, mesh, rows), cfg, c_loc, out_dtype)
    if cache_layer is not None:
        for n, plane in cache_layer.items():
            if list(plane.placements) != rows:  # written to a gathered copy: write it back
                back = context.from_local(c_loc[n], mesh, rows, plane.shape)
                plane.to_local().copy_(back.redistribute(mesh, plane.placements).to_local())
    return context.from_local(y, mesh, rows, zxbcdt.shape[:2] + y.shape[2:])
