"""Plain PyTorch versions of the ported kernels (port of ``repro.kernels.ref``).

Each CUDA kernel in this package has its plain version here.  The kernel
wrappers take it for CPU tensors (``kernels/ops.py``), the CPU tests hold
it against the JAX oracles, and ``chip_smoke.py`` holds each kernel
against it on the card.  Decoding is the reference's in-layout rank
decode: ``dense[b] = bit_b ? vals[min(rank(b), nnz-1)] : 0`` with
``rank(b) = popcount(mask & (2^b - 1))``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import dbb, quant
from repro_torch.kernels import epilogue


def decode_w(w_vals: torch.Tensor, w_mask: torch.Tensor, cfg: dbb.DBBConfig) -> torch.Tensor:
    """Wire weights ``w_vals [K//BZ, NNZ, N]``, ``w_mask [K//BZ, N]`` ->
    dense ``[K, N]``."""
    kb, nnz, n = w_vals.shape
    mask = w_mask.to(torch.int32)
    pos = torch.arange(cfg.bz, dtype=torch.int32, device=w_vals.device)
    bits = (mask[:, None, :] >> pos[None, :, None]) & 1  # [KB, BZ, N]
    rank = torch.cumsum(bits, dim=1) - bits
    idx = torch.clamp_max(rank, nnz - 1).long()
    gathered = torch.gather(w_vals, 1, idx)
    dense = torch.where(bits == 1, gathered, torch.zeros_like(gathered))
    return dense.reshape(kb * cfg.bz, n)


def decode_a(x_vals: torch.Tensor, x_mask: torch.Tensor, cfg: dbb.DBBConfig) -> torch.Tensor:
    """Wire activations ``[..., K//BZ, NNZ]`` -> dense ``[..., K]``."""
    nnz = x_vals.shape[-1]
    mask = x_mask.to(torch.int32)
    pos = torch.arange(cfg.bz, dtype=torch.int32, device=x_vals.device)
    bits = (mask[..., None] >> pos) & 1  # [..., KB, BZ]
    rank = torch.cumsum(bits, dim=-1) - bits
    idx = torch.clamp_max(rank, nnz - 1).long()
    gathered = torch.gather(x_vals, -1, idx)
    dense = torch.where(bits == 1, gathered, torch.zeros_like(gathered))
    return dense.reshape(*dense.shape[:-2], dense.shape[-2] * cfg.bz)


def float_acc(x: torch.Tensor, w_dense: torch.Tensor) -> torch.Tensor:
    """The f32 accumulator ``x @ w_dense`` of float operands (f32 or bf16),
    multiplied in float64 and rounded once to f32: every bf16 or f32
    product is exact in float64 and the sum nearly so, so a row's result
    does not depend on how many rows are multiplied with it."""
    return (x.double() @ w_dense.double()).float()


def dbb_matmul_ref(x, w_vals, w_mask, cfg, out_dtype=None,
                   bias: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """Plain version of kernel #1: ``act(x @ decode_w(w) + bias)`` with an
    f32 accumulator, the epilogue on it, then the cast to ``out_dtype``
    (default ``x``'s dtype)."""
    w_dense = decode_w(w_vals, w_mask, cfg).to(x.dtype)
    y = epilogue.apply_epilogue(float_acc(x, w_dense), bias, act)
    return y.to(out_dtype or x.dtype)


def dbb_matmul_aw_ref(x_vals, x_mask, w_vals, w_mask, cfg_a, cfg_w, out_dtype=None,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None) -> torch.Tensor:
    """Plain version of kernel #4: kernel #1 on ``decode_a(x)``."""
    x_dense = decode_a(x_vals, x_mask, cfg_a)
    return dbb_matmul_ref(x_dense, w_vals, w_mask, cfg_w, out_dtype=out_dtype,
                          bias=bias, act=act)


def combined_scale(x_scale: torch.Tensor, w_scale: torch.Tensor, n: int) -> torch.Tensor:
    """``x_scale * w_scale`` as ``[1, N]`` (scalar ``x_scale``) or ``[M, N]``
    (per-row ``x_scale [M]``) — formed before the accumulator multiply."""
    ws = w_scale.float().reshape(1, n)
    xs = x_scale.float()
    if xs.ndim == 0:
        return (xs * ws).reshape(1, n)
    return xs.reshape(-1, 1) * ws


def int8_acc(x_q: torch.Tensor, w_dense: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``x_q @ w_dense`` of int8 operands.  The CPU multiplies
    in int32.  CUDA has no integer ``matmul``, so there the product runs
    in float64, which is exact while ``K * 127**2 < 2**53``."""
    if x_q.device.type == "cpu":
        return x_q.to(torch.int32) @ w_dense.to(torch.int32)
    k = x_q.shape[-1]
    if k * 127 * 127 >= 2 ** 53:
        raise ValueError(f"K={k} too deep for an exact float64 int8 product")
    return (x_q.double() @ w_dense.double()).to(torch.int32)


def dbb_matmul_int8_ref(x_q, x_scale, w_vals, w_mask, w_scale, cfg,
                        out_dtype=torch.float32, bias: Optional[torch.Tensor] = None,
                        act: Optional[str] = None) -> torch.Tensor:
    """Plain version of kernel #2: ``act(combined_scale * (x_q @ decode_w)
    + bias)`` with an exact int32 accumulator."""
    w_dense = decode_w(w_vals, w_mask, cfg)
    acc = int8_acc(x_q, w_dense)
    scale = combined_scale(x_scale, w_scale, w_dense.shape[-1])
    y = epilogue.apply_dequant_epilogue(acc, scale, bias, act)
    return y.to(out_dtype)


def dbb_matmul_aw_int8_ref(x_vals, x_mask, x_scale, w_vals, w_mask, w_scale,
                           cfg_a, cfg_w, out_dtype=torch.float32,
                           bias: Optional[torch.Tensor] = None,
                           act: Optional[str] = None) -> torch.Tensor:
    """Plain version of kernel #3: kernel #2 on ``decode_a(x)``."""
    x_dense = decode_a(x_vals, x_mask, cfg_a)
    return dbb_matmul_int8_ref(
        x_dense, x_scale, w_vals, w_mask, w_scale, cfg_w,
        out_dtype=out_dtype, bias=bias, act=act,
    )


def pack_weight_for_kernel(w: torch.Tensor, cfg: dbb.DBBConfig):
    """Dense ``w [K, N]`` -> native wire ``(w_vals [K//BZ, NNZ, N], w_mask
    [K//BZ, N] uint8)`` in ``w``'s dtype (prunes if needed)."""
    vals, mask = dbb.pack_bitmask(w.t(), cfg)  # [N, KB, NNZ], [N, KB]
    return torch.movedim(vals, 0, -1).contiguous(), torch.movedim(mask, 0, -1).contiguous()


def pack_act_for_kernel(x: torch.Tensor, cfg: dbb.DBBConfig):
    """Dense ``x [..., K]`` -> ``(x_vals [..., K//BZ, NNZ], x_mask [..., K//BZ])``."""
    return dbb.pack_bitmask(x, cfg)


def pack_weight_int8(w: torch.Tensor, cfg: dbb.DBBConfig):
    """Dense ``w [K, N]`` -> ``(w_vals [K//BZ, NNZ, N] int8, w_mask
    [K//BZ, N] uint8, w_scale [N] f32)`` with per-output-channel scales."""
    q, mask, scale = dbb.pack_bitmask_int8(w.t(), cfg, scale_axis=(1, 2))
    return (
        torch.movedim(q, 0, -1).contiguous(),
        torch.movedim(mask, 0, -1).contiguous(),
        scale,
    )


def quantize_act_int8(x: torch.Tensor, per_row: bool = False):
    """Dense activations -> ``(int8 [..., K], f32 scale)`` with a dynamic
    per-tensor scalar or one scale per leading row."""
    if per_row:
        return quant.quantize(x, axis=-1)
    return quant.quantize(x)


def dap_prune_ref(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ):
    """Plain version of kernel #5 (DAP): ``(pruned [..., K], bitmask
    [..., K//bz] uint8)``.  ``pruned`` is :func:`dbb.prune` (a selected
    ``-0.0`` stays ``-0.0``; a block holding a NaN keeps nothing), and bit
    ``b`` of the mask marks a non-zero kept at block position ``b``."""
    cfg = dbb.DBBConfig(nnz, bz)
    pruned = dbb.prune(x, cfg)
    kept = dbb._to_blocks(pruned != 0, bz)
    weights = (2 ** torch.arange(bz, device=x.device)).to(torch.int32)
    bitmask = (kept.to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)
    return pruned, bitmask


def dap_prune_int8_ref(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ):
    """Plain version of #5's int8 dense form: ``(q [..., K] int8, scale
    [...] f32)``, :func:`dap_prune_ref`'s pruned tensor quantized with one
    scale a row."""
    return quant.quantize(dap_prune_ref(x, nnz, bz)[0], axis=-1)


def dap_pack_ref(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ):
    """Plain version of #5's packed form: ``(vals [..., K//bz, nnz],
    bitmask [..., K//bz] uint8)``, :func:`dbb.pack_bitmask`."""
    return dbb.pack_bitmask(x, dbb.DBBConfig(nnz, bz))


def dap_pack_int8_ref(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ,
                      per_row: bool = True):
    """Plain version of #5's int8 packed form: ``(q [..., K//bz, nnz] int8,
    bitmask, scale)``, :func:`dbb.pack_bitmask_int8` with one scale a row
    (``[...]``) or, with ``per_row=False``, one scalar."""
    scale_axis = (-2, -1) if per_row else None
    return dbb.pack_bitmask_int8(x, dbb.DBBConfig(nnz, bz), scale_axis=scale_axis)


def paged_attn_ref(
    q: torch.Tensor,  # [B, S, H, Dk]
    k_pages: torch.Tensor,  # [N, PS, KV*Dk] (latent: [N, PS, Dk], KV == 1)
    v_pages: Optional[torch.Tensor],  # [N, PS, KV*Dv]; unread when latent
    pos_tbl: torch.Tensor,  # [N, PS] int32
    page_tables: torch.Tensor,  # [B, P] int32
    q_pos: torch.Tensor,  # [B, S] int32
    *,
    kv_heads: int,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    latent_dv: Optional[int] = None,
    out_dtype=None,
) -> torch.Tensor:
    """Plain version of kernel #6: one page per step of a loop over
    ``page_tables`` with the fused kernel's online softmax — int8 pages
    dequantize in the load (``f32(q) * scale``, then rounded to the
    compute dtype), logits and the ``(acc, m, l)`` statistics are f32,
    masking derives from the slot positions only, and probabilities are
    cast to the value dtype before ``P @ V``.  Logits scale by
    ``softmax_scale`` (default ``1/sqrt(Dk)``).

    GQA mode reads v from ``v_pages``.  MLA's latent mode
    (``latent_dv``, ``kv_heads=1``) takes v as the first ``latent_dv``
    features of the dequantized k page; ``v_pages`` and ``v_scale`` are
    not read."""
    b, s, h, dk = q.shape
    g = h // kv_heads
    sg = s * g
    n_pages, ps = pos_tbl.shape
    p_cnt = page_tables.shape[1]
    latent = latent_dv is not None
    if latent and (kv_heads != 1 or not 0 < latent_dv <= dk):
        raise ValueError(f"latent mode needs kv_heads=1 and 0 < latent_dv <= {dk}")
    dv = latent_dv if latent else v_pages.shape[-1] // kv_heads
    out_dtype = out_dtype or q.dtype
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dk)
    neg_inf = -1e30
    cdtype = q.dtype
    tables = page_tables.long()

    q_r = q.reshape(b, s, kv_heads, g, dk).transpose(1, 2).reshape(b, kv_heads, sg, dk)
    k_r = k_pages.reshape(n_pages, ps, kv_heads, dk)
    v_r = None if latent else v_pages.reshape(n_pages, ps, kv_heads, dv)
    acc = torch.zeros((b, kv_heads, sg, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, kv_heads, sg, 1), neg_inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv_heads, sg, 1), dtype=torch.float32, device=q.device)
    for p in range(p_cnt):
        pid = tables[:, p]
        k_p = k_r[pid]  # [B, PS, KV, Dk]
        if k_scale is not None:
            k_p = (k_p.float() * k_scale[pid][:, :, None, None]).to(cdtype)
        logits = torch.einsum(
            "bkxd,bpkd->bkxp", q_r.float(), k_p.float()
        ) * scale  # [B, KV, SG, PS]
        kpos = pos_tbl[pid]  # [B, PS]
        valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= q_pos[:, :, None])
        if window is not None:
            valid &= kpos[:, None, :] > (q_pos[:, :, None] - window)
        bias = torch.where(valid, 0.0, neg_inf).float()  # [B, S, PS]
        logits = logits.reshape(b, kv_heads, s, g, ps) + bias[:, None, :, None, :]
        logits = logits.reshape(b, kv_heads, sg, ps)
        m_cur = logits.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        alpha = torch.exp(m - m_new)
        probs = torch.exp(logits - m_new)
        if latent:
            v_p = k_p[..., :dv]  # MLA: v is the latent prefix of k
        else:
            v_p = v_r[pid]
            if v_scale is not None:
                v_p = (v_p.float() * v_scale[pid][:, :, None, None]).to(cdtype)
        pv = torch.einsum("bkxp,bpkv->bkxv", probs.to(v_p.dtype).float(), v_p.float())
        acc = acc * alpha + pv
        m = m_new
        l = alpha * l + probs.sum(dim=-1, keepdim=True)
    out = acc / torch.clamp_min(l, 1e-30)
    out = out.reshape(b, kv_heads, s, g, dv).transpose(1, 2)
    return out.reshape(b, s, h, dv).to(out_dtype)
