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

from repro_torch.core import dbb
from repro_torch.kernels import dap_prune as dap_mod
from repro_torch.kernels import dbb_matmul as dbb_mm
from repro_torch.kernels import native, paged_attn, ref


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
    ``latent_dv`` features of each k row, ``v_pages`` unread)."""
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
    Accepts any ``[..., K]``; the kernel sees it as 2-D."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _on_cuda(x2):
        pruned, mask = dap_mod.dap_prune_cuda(x2.contiguous(), nnz, bz)
    else:
        dap_mod.DAP_PRUNE.plain += 1
        pruned, mask = ref.dap_prune_ref(x2, nnz, bz)
    return pruned.reshape(shape), mask.reshape(*shape[:-1], shape[-1] // bz)


def dap_pack_int8(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ,
                  act_scale: str = "per_tensor"):
    """Fused DAP-prune + pack + quantize: dense ``[..., K]`` -> int8 wire
    ``(vals [..., K//bz, nnz], mask [..., K//bz], scale)``; the scale is one
    scalar or, with ``act_scale="per_row"``, one per token."""
    scale_axis = (-2, -1) if act_scale == "per_row" else None
    return dbb.pack_bitmask_int8(x, dbb.DBBConfig(nnz, bz), scale_axis=scale_axis)


def dap_pack(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ):
    """Fused DAP-prune + pack: dense ``[..., K]`` -> native wire ``(vals
    [..., K//bz, nnz], mask [..., K//bz] uint8)`` in ``x``'s dtype; the
    pruned dense tensor is never materialized."""
    return dbb.pack_bitmask(x, dbb.DBBConfig(nnz, bz))


def expand_act(vals: torch.Tensor, mask: torch.Tensor, cfg: dbb.DBBConfig) -> torch.Tensor:
    """Wire-format activations -> dense ``[..., K]`` (for dense weights)."""
    return ref.decode_a(vals, mask, cfg)


pack_weight = ref.pack_weight_for_kernel
pack_weight_int8 = ref.pack_weight_int8
