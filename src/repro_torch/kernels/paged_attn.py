"""Fused paged attention on Hopper (``csrc/paged_attn.cu``).

Kernel #6 replaces the reference's ``paged_attn_fused``: it walks each
request's page table in-kernel with an online softmax and dequantizes
int8 pages in the load, so the ``[B, P*PS, D]`` window is never
materialized.  Two modes, counted apart: GQA (``PAGED_ATTN``) and MLA's
latent mode (``PAGED_ATTN_LATENT``: ``kv_heads=1``, the page holds the
``(c_kv ‖ k_rope)`` latent and v is its first ``latent_dv`` features, so
the v pages are never read).  The plain version is
``kernels/ref.py::paged_attn_ref``.

Every bf16 call runs on the tensor cores (``mma.sync`` bf16 for Q K^T and
P V, a two-stage ``cp.async`` page ring): GQA calls in
``paged_attn_tc_kernel``, counted in ``PAGED_ATTN`` and ``PAGED_ATTN_TC``;
latent calls in ``paged_attn_latent_tc_kernel`` (query rows tiled across
token boundaries, one k tile for both products), counted in
``PAGED_ATTN_LATENT`` and ``PAGED_ATTN_LATENT_TC``.  Both take any page
size (a page of more than 64 slots is walked as 64-slot sub-pages) and
``Dv % 8 == 0``; GQA also ``Dk % 16 == 0``, ``Dv <= 128`` and at most 64
query heads per KV head, latent ``Dk % 8 == 0`` (zero-padded to 16 in
shared memory) and ``Dv <= 256``.  They raise on other bf16 shapes:
nothing falls back.  f32 calls run the scalar kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import native

PAGED_ATTN = native.Counter()  # kernel #6, GQA mode
PAGED_ATTN_LATENT = native.Counter()  # kernel #6, MLA latent mode
PAGED_ATTN_TC = native.Counter()  # the tensor-core kernel's share of PAGED_ATTN
PAGED_ATTN_LATENT_TC = native.Counter()  # the latent tensor-core kernel's share

# pages one block walks (at most 32), in both modes; the rest of a
# request's table goes to more blocks whose partial softmax statistics a
# second kernel merges.  A fixed width, so a row's bits never depend on
# the batch, its length or the co-batch.
PAGES_PER_SPLIT = 4
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_COMPUTE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _entries():
    global _fns
    if _fns is None:
        lib = native.load("paged_attn")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.paged_attn
        fn.argtypes = [P] * 10 + [I] * 11 + [ctypes.c_float, I, I, P]
        fn.restype = I
        smem = lib.paged_attn_smem_bytes
        smem.argtypes = [I] * 6
        smem.restype = ctypes.c_size_t
        tc_smem = lib.paged_attn_tc_smem_bytes
        tc_smem.argtypes = [I] * 8
        tc_smem.restype = ctypes.c_size_t
        _fns = (fn, smem, tc_smem)
    return _fns


def tc_shape_error(g: int, dk: int, dv: int, ps: int, latent: bool = False) -> Optional[str]:
    """Why the tensor-core kernel does not take a bf16 call of these shapes
    (GQA: ``g`` query heads per KV head; ``latent``: MLA's latent mode, any
    ``g``), or None when it does."""
    if dk % (8 if latent else 16):
        return f"head dim Dk={dk} is not a multiple of {8 if latent else 16}"
    max_dv = 256 if latent else 128
    if dv % 8 or dv > max_dv:
        return f"value dim Dv={dv} is not a multiple of 8 up to {max_dv}"
    if ps < 1:
        return f"page size PS={ps} is not at least 1"
    if not latent and g > 64:
        return f"{g} query heads per KV head exceed 64"
    return None


def paged_attn_cuda(
    q: torch.Tensor,  # [B, S, H, Dk] compute dtype (f32 or bf16)
    k_pages: torch.Tensor,  # [N, PS, KV*Dk] int8 (with k_scale) or q's dtype
    v_pages: Optional[torch.Tensor],  # [N, PS, KV*Dv]; unread in latent mode
    pos_tbl: torch.Tensor,  # [N, PS] int32
    page_tables: torch.Tensor,  # [B, P] int32
    q_pos: torch.Tensor,  # [B, S] int32
    *,
    kv_heads: int,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,  # default 1/sqrt(Dk)
    k_scale: Optional[torch.Tensor] = None,  # [N, PS] f32
    v_scale: Optional[torch.Tensor] = None,
    latent_dv: Optional[int] = None,
    out_dtype=None,
) -> torch.Tensor:
    """Kernel #6: ``[B, S, H, Dv]`` attention over the paged cache; with
    ``latent_dv`` the MLA latent mode."""
    b, s, h, dk = q.shape
    if q.dtype not in _COMPUTE:
        raise ValueError(f"q: compute dtype must be float32 or bfloat16, got {q.dtype}")
    if out_dtype not in (None, q.dtype):
        raise ValueError(f"out_dtype must be q's dtype {q.dtype}, got {out_dtype}")
    if h % kv_heads != 0:
        raise ValueError(f"{h} heads do not group over {kv_heads} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    n_pages, ps = pos_tbl.shape
    p_cnt = page_tables.shape[1]
    if k_pages.shape[:2] != (n_pages, ps) or k_pages.shape[2] != kv_heads * dk:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} does not match q {tuple(q.shape)}")
    kv_int8 = k_scale is not None
    latent = latent_dv is not None
    if latent:
        if kv_heads != 1 or not 0 < latent_dv <= dk:
            raise ValueError(
                f"latent mode needs kv_heads=1 and 0 < latent_dv <= Dk={dk}, got "
                f"kv_heads={kv_heads}, latent_dv={latent_dv}"
            )
        if v_scale is not None:
            raise ValueError("latent mode reads v from the k pages: no v_scale")
        dv = latent_dv
    else:
        if v_pages is None or v_pages.shape[:2] != (n_pages, ps) or v_pages.shape[2] % kv_heads:
            raise ValueError("v_pages does not match the page pool")
        if (v_scale is not None) != kv_int8:
            raise ValueError("int8 KV needs both k_scale and v_scale")
        dv = v_pages.shape[2] // kv_heads
    page_dtype = torch.int8 if kv_int8 else q.dtype
    args = [
        native.cuda_arg(q, "q", q.dtype),
        native.cuda_arg(k_pages, "k_pages", page_dtype),
        None if latent else native.cuda_arg(v_pages, "v_pages", page_dtype),
        None if not kv_int8 else native.cuda_arg(k_scale, "k_scale", torch.float32, (n_pages, ps)),
        None if v_scale is None else native.cuda_arg(v_scale, "v_scale", torch.float32, (n_pages, ps)),
        native.cuda_arg(pos_tbl, "pos_tbl", torch.int32),
        native.cuda_arg(page_tables, "page_tables", torch.int32),
        native.cuda_arg(q_pos, "q_pos", torch.int32, (b, s)),
    ]
    g = h // kv_heads
    tc = q.dtype == torch.bfloat16
    if tc:
        why = tc_shape_error(g, dk, dv, ps, latent)
        # cp.async sources: q and the pages by 16 bytes, the scale planes by
        # 16 bytes when a page's scales are (PS % 4 == 0), else by 4
        scale_align = 16 if ps % 4 == 0 else 4
        if why is None and (any(a % 16 for a in args[:3] if a is not None)
                            or any(a % scale_align for a in args[3:5] if a is not None)):
            why = "q, a page pool or a scale plane is not aligned for cp.async"
        if why is not None:
            mode = "latent" if latent else "GQA"
            raise ValueError(f"bf16 {mode} paged attention (tensor-core kernel): {why}")
    fn, smem, tc_smem = _entries()
    pps = PAGES_PER_SPLIT
    if tc:
        need = tc_smem(s, g, dk, dv, ps, pps, int(kv_int8), int(latent))
    else:
        need = smem(s, g, dk, dv, ps, int(latent))
    if need > SMEM_LIMIT:
        raise ValueError(
            f"paged attention needs {need} B of shared memory for S={s}, G={g}, "
            f"Dk={dk}, Dv={dv}, PS={ps}; one block has {SMEM_LIMIT}"
        )
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    n_split = -(-p_cnt // pps)
    ws = None
    if n_split > 1 or not tc:  # one tensor-core split writes the output itself
        ws = torch.empty((b * kv_heads * n_split * s * g * (dv + 2),), dtype=torch.float32,
                         device=q.device)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dk)
    err = fn(
        *args, None if ws is None else ws.data_ptr(), out.data_ptr(), b, s, h, kv_heads, dk,
        dv, ps, p_cnt, pps, -1 if window is None else int(window), int(latent), float(scale),
        int(kv_int8), _COMPUTE[q.dtype], native.stream_ptr(q.device),
    )
    native.check(err, "paged_attn")
    (PAGED_ATTN_LATENT if latent else PAGED_ATTN).launches += 1
    if tc:
        (PAGED_ATTN_LATENT_TC if latent else PAGED_ATTN_TC).launches += 1
    return out
