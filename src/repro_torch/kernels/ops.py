"""Kernel dispatch (port of ``repro.kernels.ops``).

Where the reference takes ``impl=``, the port dispatches on where the
data lies: a CUDA tensor launches the hand-written kernel (or the
wrapper raises), a CPU tensor takes the plain version in
``kernels/ref.py``.  There is no fallback from one to the other.  Each
kernel's :class:`~repro_torch.kernels.native.Counter` records its kernel
launches and its plain-version calls (:func:`counters`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import dbb, quant
from repro_torch.kernels import dap_prune as dap_mod
from repro_torch.kernels import dbb_matmul as dbb_mm
from repro_torch.kernels import native, paged_attn, ref
from repro_torch.sharding import context


def counters() -> Dict[str, native.Counter]:
    """The launch counters of every ported kernel, by kernel name."""
    return {
        "dbb_matmul": dbb_mm.NATIVE,
        "dbb_matmul_int8": dbb_mm.INT8,
        "dbb_matmul_aw_int8": dbb_mm.AW_INT8,
        "dbb_matmul_aw": dbb_mm.AW_NATIVE,
        "paged_attn": paged_attn.PAGED_ATTN,
        "paged_attn_latent": paged_attn.PAGED_ATTN_LATENT,
        "dap_prune": dap_mod.DAP_PRUNE,
        "dap_prune_int8": dap_mod.DAP_PRUNE_INT8,
        "dap_pack": dap_mod.DAP_PACK,
        "dap_pack_int8": dap_mod.DAP_PACK_INT8,
    }


def reset_counters() -> None:
    for c in counters().values():
        c.launches = 0
        c.plain = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: the port runs on cuda or cpu")


def dbb_matmul(
    x: torch.Tensor,
    w_vals: torch.Tensor,
    w_mask: torch.Tensor,
    cfg: dbb.DBBConfig,
    *,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """Native-wire W-DBB matmul (kernel #1): ``act(x [M, K] @ decode_w(w)
    + bias) -> [M, N]`` with an f32 accumulator."""
    if _on_cuda(x):
        return dbb_mm.dbb_matmul_cuda(
            x.contiguous(), w_vals, w_mask, cfg, out_dtype=out_dtype, bias=bias, act=act,
        )
    dbb_mm.NATIVE.plain += 1
    return ref.dbb_matmul_ref(x, w_vals, w_mask, cfg, out_dtype=out_dtype, bias=bias, act=act)


def dbb_matmul_aw(
    x_vals: torch.Tensor,
    x_mask: torch.Tensor,
    w_vals: torch.Tensor,
    w_mask: torch.Tensor,
    cfg_a: dbb.DBBConfig,
    cfg_w: dbb.DBBConfig,
    *,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    out_dtype=None,
) -> torch.Tensor:
    """Native-wire joint A/W-DBB matmul (kernel #4): both operands packed
    in the model dtype."""
    if _on_cuda(x_vals):
        return dbb_mm.dbb_matmul_aw_cuda(
            x_vals.contiguous(), x_mask.contiguous(), w_vals, w_mask, cfg_a, cfg_w,
            out_dtype=out_dtype, bias=bias, act=act,
        )
    dbb_mm.AW_NATIVE.plain += 1
    return ref.dbb_matmul_aw_ref(
        x_vals, x_mask, w_vals, w_mask, cfg_a, cfg_w, out_dtype=out_dtype, bias=bias, act=act,
    )


def dbb_matmul_int8(
    x: torch.Tensor,
    w_vals: torch.Tensor,
    w_mask: torch.Tensor,
    w_scale: torch.Tensor,
    cfg: dbb.DBBConfig,
    *,
    x_scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    out_dtype=None,
    act_scale: str = "per_tensor",
) -> torch.Tensor:
    """Quantized W-DBB matmul (kernel #2).  A float ``x`` is quantized here
    with a dynamic per-tensor or per-row (``act_scale="per_row"``) scale;
    an int8 ``x`` needs ``x_scale``."""
    if x.dtype != torch.int8:
        out_dtype = out_dtype or x.dtype
        x, x_scale = ref.quantize_act_int8(x, per_row=act_scale == "per_row")
    elif x_scale is None:
        raise ValueError("int8 x requires x_scale")
    out_dtype = out_dtype or torch.float32
    if _on_cuda(x):
        return dbb_mm.dbb_matmul_int8_cuda(
            x.contiguous(), x_scale, w_vals, w_mask, w_scale, cfg,
            out_dtype=out_dtype, bias=bias, act=act,
        )
    dbb_mm.INT8.plain += 1
    return ref.dbb_matmul_int8_ref(
        x, x_scale, w_vals, w_mask, w_scale, cfg,
        out_dtype=out_dtype, bias=bias, act=act,
    )


def dbb_matmul_aw_int8(
    x_vals: torch.Tensor,
    x_mask: torch.Tensor,
    x_scale: torch.Tensor,
    w_vals: torch.Tensor,
    w_mask: torch.Tensor,
    w_scale: torch.Tensor,
    cfg_a: dbb.DBBConfig,
    cfg_w: dbb.DBBConfig,
    *,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Quantized joint A/W-DBB matmul (kernel #3): both operands packed int8."""
    if _on_cuda(x_vals):
        return dbb_mm.dbb_matmul_aw_int8_cuda(
            x_vals.contiguous(), x_mask.contiguous(), x_scale, w_vals, w_mask,
            w_scale, cfg_a, cfg_w, out_dtype=out_dtype, bias=bias, act=act,
        )
    dbb_mm.AW_INT8.plain += 1
    return ref.dbb_matmul_aw_int8_ref(
        x_vals, x_mask, x_scale, w_vals, w_mask, w_scale, cfg_a, cfg_w,
        out_dtype=out_dtype, bias=bias, act=act,
    )


def paged_attention(q, k_pages, v_pages, pos_tbl, page_tables, q_pos, *,
                    kv_heads: int, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    latent_dv: Optional[int] = None,
                    out_dtype=None) -> torch.Tensor:
    """Fused paged attention (kernel #6) -> ``[B, S, H, Dv]``: GQA mode, or
    MLA's latent mode with ``latent_dv`` (``kv_heads=1``, v the first
    ``latent_dv`` features of each k row, ``v_pages`` unread).

    The fault injector's hook sits here, before either version runs: a
    scoped injector (``serve/faults.py``) may raise its one
    ``FusedKernelFault``, which the engine answers with its one-way
    fallback to the gather path; a no-op otherwise.  (A local import:
    ``serve`` depends on ``kernels``, not the reverse.)"""
    from repro_torch.serve.faults import check_fused

    check_fused()
    kw = dict(kv_heads=kv_heads, window=window, softmax_scale=softmax_scale,
              k_scale=k_scale, v_scale=v_scale, latent_dv=latent_dv, out_dtype=out_dtype)
    if _on_cuda(q):
        return paged_attn.paged_attn_cuda(
            q.contiguous(), k_pages, v_pages, pos_tbl, page_tables, q_pos, **kw
        )
    counter = paged_attn.PAGED_ATTN if latent_dv is None else paged_attn.PAGED_ATTN_LATENT
    counter.plain += 1
    return ref.paged_attn_ref(q, k_pages, v_pages, pos_tbl, page_tables, q_pos, **kw)


def dap_prune(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ):
    """DAP (kernel #5): ``(pruned [..., K], mask [..., K//bz] uint8)``.
    Accepts any ``[..., K]``; the kernel sees it as 2-D.  A ``DTensor``
    is pruned shard by shard (``context.run_local``)."""
    if isinstance(x, DTensor):
        return context.run_local(lambda t: dap_prune(t, nnz, bz), (x,),
                                 context.row_placements(x, bz))
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _on_cuda(x2):
        pruned, mask = dap_mod.dap_prune_cuda(x2.contiguous(), nnz, bz)
    else:
        dap_mod.DAP_PRUNE.plain += 1
        pruned, mask = ref.dap_prune_ref(x2, nnz, bz)
    return pruned.reshape(shape), mask.reshape(*shape[:-1], shape[-1] // bz)


def dap_prune_int8(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ):
    """DAP, then int8 with one scale a row (#5's int8 dense form): ``(q
    [..., K] int8, scale [...] f32)``, the reference's ``quant.quantize(
    dap_prune(x)[0], axis=-1)``.  The int8 wire's dense-input linears hand
    it to :func:`dbb_matmul_int8` (kernel #2)."""
    shape = x.shape
    if _on_cuda(x):
        q, scale = dap_mod.dap_prune_int8_cuda(x.reshape(-1, shape[-1]).contiguous(), nnz, bz)
        return q.reshape(shape), scale.reshape(shape[:-1])
    dap_mod.DAP_PRUNE_INT8.plain += 1
    return ref.dap_prune_int8_ref(x, nnz, bz)


def dap_pack_int8(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ,
                  act_scale: str = "per_tensor"):
    """Fused DAP-prune + pack + quantize: dense ``[..., K]`` -> int8 wire
    ``(vals [..., K//bz, nnz], mask [..., K//bz], scale)``; the scale is one
    scalar or, with ``act_scale="per_row"``, one per token.  On CUDA the
    per-row scale is #5's int8 packed form, one launch; a per-tensor scale
    (on no served path) takes #5's packed form and then the plain
    per-tensor quantization, the reference's order."""
    per_row = act_scale == "per_row"
    if not _on_cuda(x):
        dap_mod.DAP_PACK_INT8.plain += 1
        return ref.dap_pack_int8_ref(x, nnz, bz, per_row=per_row)
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    if per_row:
        q, mask, scale = dap_mod.dap_pack_int8_cuda(x2, nnz, bz)
        scale = scale.reshape(lead)
    else:
        vals, mask = dap_mod.dap_pack_cuda(x2, nnz, bz)
        q, scale = quant.quantize(vals)
    return q.reshape(*lead, k // bz, nnz), mask.reshape(*lead, k // bz), scale


def dap_pack(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ):
    """Fused DAP-prune + pack: dense ``[..., K]`` -> native wire ``(vals
    [..., K//bz, nnz], mask [..., K//bz] uint8)`` in ``x``'s dtype; the
    pruned dense tensor is never materialized (#5's packed form on CUDA).
    A ``DTensor`` is packed shard by shard."""
    if isinstance(x, DTensor):
        return context.run_local(lambda t: dap_pack(t, nnz, bz), (x,),
                                 context.row_placements(x, bz))
    if not _on_cuda(x):
        dap_mod.DAP_PACK.plain += 1
        return ref.dap_pack_ref(x, nnz, bz)
    lead, k = x.shape[:-1], x.shape[-1]
    vals, mask = dap_mod.dap_pack_cuda(x.reshape(-1, k).contiguous(), nnz, bz)
    return vals.reshape(*lead, k // bz, nnz), mask.reshape(*lead, k // bz)


def expand_act(vals: torch.Tensor, mask: torch.Tensor, cfg: dbb.DBBConfig) -> torch.Tensor:
    """Wire-format activations -> dense ``[..., K]`` (for dense weights)."""
    return ref.decode_a(vals, mask, cfg)


# the packers, so users need only ``repro_torch.kernels.ops``
pack_weight = ref.pack_weight_for_kernel
pack_act = ref.pack_act_for_kernel
pack_weight_int8 = ref.pack_weight_int8
quantize_act = ref.quantize_act_int8
