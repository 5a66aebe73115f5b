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
from repro_torch.kernels import dbb_matmul, native, paged_attn, ref


def counters() -> Dict[str, native.Counter]:
    """The launch counters of every ported kernel, by kernel name."""
    return {
        "dbb_matmul_int8": dbb_matmul.INT8,
        "dbb_matmul_aw_int8": dbb_matmul.AW_INT8,
        "paged_attn": paged_attn.PAGED_ATTN,
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
        return dbb_matmul.dbb_matmul_int8_cuda(
            x.contiguous(), x_scale, w_vals, w_mask, w_scale, cfg,
            out_dtype=out_dtype, bias=bias, act=act,
        )
    dbb_matmul.INT8.plain += 1
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
        return dbb_matmul.dbb_matmul_aw_int8_cuda(
            x_vals.contiguous(), x_mask.contiguous(), x_scale, w_vals, w_mask,
            w_scale, cfg_a, cfg_w, out_dtype=out_dtype, bias=bias, act=act,
        )
    dbb_matmul.AW_INT8.plain += 1
    return ref.dbb_matmul_aw_int8_ref(
        x_vals, x_mask, x_scale, w_vals, w_mask, w_scale, cfg_a, cfg_w,
        out_dtype=out_dtype, bias=bias, act=act,
    )


def paged_attention(q, k_pages, v_pages, pos_tbl, page_tables, q_pos, *,
                    kv_heads: int, window: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    out_dtype=None) -> torch.Tensor:
    """Fused paged attention (kernel #6, GQA mode) -> ``[B, S, H, Dv]``."""
    kw = dict(kv_heads=kv_heads, window=window, k_scale=k_scale,
              v_scale=v_scale, out_dtype=out_dtype)
    if _on_cuda(q):
        return paged_attn.paged_attn_cuda(
            q.contiguous(), k_pages, v_pages, pos_tbl, page_tables, q_pos, **kw
        )
    paged_attn.PAGED_ATTN.plain += 1
    return ref.paged_attn_ref(q, k_pages, v_pages, pos_tbl, page_tables, q_pos, **kw)


def dap_pack_int8(x: torch.Tensor, nnz: int, bz: int = dbb.DEFAULT_BZ,
                  act_scale: str = "per_tensor"):
    """Fused DAP-prune + pack + quantize: dense ``[..., K]`` -> int8 wire
    ``(vals [..., K//bz, nnz], mask [..., K//bz], scale)``; the scale is one
    scalar or, with ``act_scale="per_row"``, one per token."""
    scale_axis = (-2, -1) if act_scale == "per_row" else None
    return dbb.pack_bitmask_int8(x, dbb.DBBConfig(nnz, bz), scale_axis=scale_axis)


def expand_act(vals: torch.Tensor, mask: torch.Tensor, cfg: dbb.DBBConfig) -> torch.Tensor:
    """Wire-format activations -> dense ``[..., K]`` (for dense weights)."""
    return ref.decode_a(vals, mask, cfg)


pack_weight_int8 = ref.pack_weight_int8
