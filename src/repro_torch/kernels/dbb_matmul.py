"""The DBB matmul kernels on Hopper (``csrc/dbb_matmul_int8.cu``,
``csrc/dbb_matmul_native.cu``).

Int8 wire: kernel #2 (``dbb_matmul_int8_cuda``) replaces the reference's
``dbb_matmul_int8_pallas``: dense int8 activations times packed int8
weights.  Kernel #3 (``dbb_matmul_aw_int8_cuda``) replaces
``dbb_matmul_aw_int8_pallas``: both operands packed.  Both accumulate in
int32 and drain through the dequant epilogue
``act(float(acc) * (x_scale * w_scale) + bias)`` — bit-identical to the
plain versions in ``kernels/ref.py``.  A call of a shape the int8 tc body
takes (:func:`int8_body_error`) runs it — a ``cp.async`` ring of raw
packed tiles, each 8-block decoded straight into ``mma.sync`` fragments by
two byte permutes whose selectors come from a mask-indexed table
(:func:`int8_decode_table`, uploaded once per device), split-K summed in a
thread-block cluster, one launch a call, planned by ``autotune.get_plan``
(:func:`int8_plan` unless a sweep cached another plan for the shape) —
counted in ``INT8_TC`` / ``AW_INT8_TC`` as well as ``INT8`` / ``AW_INT8``;
any other call runs the generic body (an int32 split-K workspace, a
memset and a second launch), at any N: a guarded column tail where N % 4
!= 0.

Native wire (values in the model dtype, bf16 or f32): kernel #1
(``dbb_matmul_cuda``) replaces ``dbb_matmul_pallas`` and kernel #4
(``dbb_matmul_aw_cuda``) replaces ``dbb_matmul_aw_pallas``: an f32
accumulator drained through ``act(acc + bias)``.  Their launch plan
(``autotune.get_plan``: :func:`native_plan`, the tile width, K splits and
cluster, unless a sweep cached another) depends on (K, N) only, so a
row's output is bitwise the same whatever M is.  A bf16 call
of a shape the tc body takes (:func:`tc_body_error`) runs it — a
``cp.async`` ring of raw packed tiles, decoded in shared memory by a
mask-indexed byte-permute table into dense tiles for ``mma.sync``,
split-K summed in a thread-block cluster — counted in ``NATIVE_TC`` /
``AW_NATIVE_TC`` as well as ``NATIVE`` / ``AW_NATIVE``; any other call
runs the generic body (a split-K workspace and a second launch).

Each wrapper takes an explicit tc-body ``plan``, which wins over the
cache as the reference's explicit tiles do.  The wrappers take CUDA
tensors only; ``kernels/ops.py`` dispatches CPU tensors to the plain
versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import dbb
from repro_torch.kernels import autotune, native

INT8 = native.Counter()  # kernel #2: dense int8 x, packed int8 w
AW_INT8 = native.Counter()  # kernel #3: packed int8 x and w
INT8_TC = native.Counter()  # kernel #2's launches of the int8 tc body
AW_INT8_TC = native.Counter()  # kernel #3's launches of the int8 tc body
NATIVE = native.Counter()  # kernel #1: dense x, packed w, model dtype
AW_NATIVE = native.Counter()  # kernel #4: packed x and w, model dtype
NATIVE_TC = native.Counter()  # kernel #1's launches of the tc body
AW_NATIVE_TC = native.Counter()  # kernel #4's launches of the tc body

_ACT = {None: 0, "relu": 1, "silu": 2, "gelu": 3}
_OUT = {torch.float32: 0, torch.bfloat16: 1}
# blocks that fill the H100's 132 SMs twice: a generic launch with fewer
# output tiles splits its K loop across blocks (int32 atomics, exact)
TARGET_BLOCKS = 264
_fns = None
_native_fns = None
_tables = {}  # device -> the int8 decode tables on it


def _entries():
    global _fns
    if _fns is None:
        lib = native.load("dbb_matmul_int8")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.dbb_matmul_int8
        fn.argtypes = [P, P, P, I] + [P] * 7 + [I] * 12 + [P, P]
        fn.restype = I
        tiles = lib.dbb_matmul_int8_tiles
        tiles.argtypes = [I, I]
        tiles.restype = I
        _fns = (fn, tiles)
    return _fns


def _split_k(tiles: int, kb: int) -> int:
    """K splits of a generic-body launch of ``tiles`` output tiles over
    ``kb`` 8-blocks (at least 16 8-blocks, one shared-memory step, per
    split)."""
    if tiles >= TARGET_BLOCKS // 2:
        return 1
    return max(1, min(-(-TARGET_BLOCKS // tiles), kb // 16))


MAX_SPLIT = 8  # K splits of one output tile: the blocks of a portable cluster
INT8_STEP_BLOCKS = 16  # 8-blocks of one k-step of the int8 tc body (128 k)
# blocks a launch of the int8 tc body aims for, of the H100's 132 SMs:
# measured best of 132, 168, 200, 232 and 264 (PERF.md)
INT8_PLAN_BLOCKS = 232


def int8_plan(m: int, k: int, n: int):
    """``(bm, kb_per_split, n_split)`` of an int8 tc-body launch of M =
    ``m`` rows over K = ``k`` and N = ``n``: the output tile's rows (16 where
    M <= 16, else 64; its columns are 128) and as many K splits of whole
    ``INT8_STEP_BLOCKS`` k-steps (at most ``MAX_SPLIT``: the ``n_split``
    blocks of a tile are one thread-block cluster) as ``INT8_PLAN_BLOCKS``
    blocks hold.  It may depend on M: integer sums do not depend on the
    split, so a row's bits never do."""
    kb = k // 8
    steps = -(-kb // INT8_STEP_BLOCKS)
    bm = 16 if m <= 16 else 64
    tiles = -(-m // bm) * -(-n // 128)
    want = max(1, min(MAX_SPLIT, steps, INT8_PLAN_BLOCKS // tiles))
    per = -(-steps // want)
    return bm, per * INT8_STEP_BLOCKS, -(-steps // per)


def int8_body_error(kb: int, n: int, nnz: int = 4, ptrs=()) -> Optional[str]:
    """Why the int8 tc body does not take a call (``kb`` 8-blocks, ``n``
    columns, ``nnz`` values an 8-block of either packed operand at most,
    the device pointers of x, x_mask, w_vals and w_mask), or None when it
    does."""
    if kb % INT8_STEP_BLOCKS:
        return f"K={8 * kb} is not a multiple of {8 * INT8_STEP_BLOCKS}"
    if n % 16:
        return f"N={n} is not a multiple of 16"
    if nnz > 4:
        return f"NNZ={nnz} exceeds 4 values an 8-block"
    if any(p % 16 for p in ptrs):
        return "an operand is not 16-byte aligned for cp.async"
    return None


def int8_decode_table() -> torch.Tensor:
    """The int8 tc body's decode tables, ``[4, 256]`` int32: row ``nnz -
    1``, entry ``mask``.  Nibble ``p`` (0-7) of an entry is the byte that
    position ``p`` of the 8-block takes from its value word ``v0 | v1 << 8
    | v2 << 16 | v3 << 24``: the value of rank ``popcount(mask & (2^p -
    1))``, clamped to ``nnz - 1`` like the oracle's gather, where bit ``p``
    is set, else 4 (a byte of a zero word).  The low half is a byte_perm
    selector for the dense word of positions 0-3, the high half for 4-7."""
    table = torch.zeros((4, 256), dtype=torch.int64)
    for nnz in range(1, 5):
        for mask in range(256):
            entry, rank = 0, 0
            for p in range(8):
                if mask >> p & 1:
                    entry |= min(rank, nnz - 1) << (4 * p)
                    rank += 1
                else:
                    entry |= 4 << (4 * p)
            table[nnz - 1, mask] = entry
    return table.to(torch.int32)


def _decode_table(dev: torch.device) -> torch.Tensor:
    table = _tables.get(dev)
    if table is None:
        table = _tables[dev] = int8_decode_table().to(dev)
    return table


def _launch(counter, tc_counter, x, x_mask, m, nnz_a, x_scale, w_vals, w_mask, w_scale,
            cfg_w, out_dtype, bias, act, acc_out, plan):
    if cfg_w.bz != 8:
        raise ValueError(f"the CUDA kernel decodes 8-blocks, got bz={cfg_w.bz}")
    if act not in _ACT:
        raise ValueError(f"unknown activation {act!r}; one of {tuple(_ACT)}")
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    kb, nnz_w, n = w_vals.shape
    if nnz_w != cfg_w.nnz or not 1 <= nnz_w <= 8:
        raise ValueError(f"w_vals holds {nnz_w} slots, cfg says {cfg_w.nnz}")
    dev = w_vals.device
    p_wv = native.cuda_arg(w_vals, "w_vals", torch.int8)
    p_wm = native.cuda_arg(w_mask, "w_mask", torch.uint8, (kb, n))
    p_ws = native.cuda_arg(w_scale, "w_scale", torch.float32, (n,))
    if x_scale.ndim == 0:
        per_row = 0
        p_xs = native.cuda_arg(x_scale, "x_scale", torch.float32)
    else:
        per_row = 1
        p_xs = native.cuda_arg(x_scale, "x_scale", torch.float32, (m,))
    p_b = None
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
        p_b = native.cuda_arg(bias, "bias", torch.float32, (n,))
    p_acc = None
    if acc_out is not None:
        p_acc = native.cuda_arg(acc_out, "acc_out", torch.int32, (m, n))
    p_x = x.data_ptr()
    p_xm = None if x_mask is None else x_mask.data_ptr()
    ptrs = (p_x, p_wv, p_wm) + (() if p_xm is None else (p_xm,))
    body_err = int8_body_error(kb, n, max(nnz_a, nnz_w), ptrs)
    tc = body_err is None
    kind = "w_int8" if x_mask is None else "aw_int8"
    _check_plan(plan, kind, body_err, 8 * kb, n)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn, tiles = _entries()
    if tc:
        bm, kb_per_split, split_k = plan or autotune.get_plan(kind, m, 8 * kb, n, nnz_w, 8,
                                                              PLAN_RULES)
        acc_ws, lut = None, _decode_table(dev).data_ptr()
    else:
        bm = kb_per_split = 0
        split_k = _split_k(tiles(m, n), kb)
        acc_ws = torch.empty((m, n), dtype=torch.int32, device=dev) if split_k > 1 else None
        lut = None
    err = fn(
        p_x, p_xm, p_xs, per_row, p_wv, p_wm, p_ws, p_b, out.data_ptr(),
        p_acc, None if acc_ws is None else acc_ws.data_ptr(), m, n, kb, nnz_a, nnz_w,
        split_k, int(x_mask is not None), _OUT[out_dtype], _ACT[act], int(tc), bm,
        kb_per_split, lut, native.stream_ptr(dev),
    )
    native.check(err, "dbb_matmul_int8")
    counter.launches += 1
    if tc:
        tc_counter.launches += 1
    return out


def dbb_matmul_int8_cuda(
    x_q: torch.Tensor,  # [M, K] int8
    x_scale: torch.Tensor,  # f32 scalar or [M]
    w_vals: torch.Tensor,  # [K//8, NNZ, N] int8
    w_mask: torch.Tensor,  # [K//8, N] uint8
    w_scale: torch.Tensor,  # [N] f32
    cfg: dbb.DBBConfig,
    *,
    out_dtype=torch.float32,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    acc_out: Optional[torch.Tensor] = None,  # [M, N] int32: raw accumulators
    plan=None,  # the tc body's (bm, kb_per_split, n_split); None: autotune.get_plan
) -> torch.Tensor:
    """Kernel #2: ``act(x_scale*w_scale * (x_q @ decode_w(w)) + bias)``."""
    if x_q.ndim != 2 or x_q.shape[1] != w_vals.shape[0] * cfg.bz:
        raise ValueError(f"x_q {tuple(x_q.shape)} does not match w_vals {tuple(w_vals.shape)}")
    native.cuda_arg(x_q, "x_q", torch.int8)
    return _launch(INT8, INT8_TC, x_q, None, x_q.shape[0], 1, x_scale, w_vals, w_mask,
                   w_scale, cfg, out_dtype, bias, act, acc_out, plan)


def dbb_matmul_aw_int8_cuda(
    x_vals: torch.Tensor,  # [M, K//8, NNZa] int8
    x_mask: torch.Tensor,  # [M, K//8] uint8
    x_scale: torch.Tensor,  # f32 scalar or [M]
    w_vals: torch.Tensor,
    w_mask: torch.Tensor,
    w_scale: torch.Tensor,
    cfg_a: dbb.DBBConfig,
    cfg_w: dbb.DBBConfig,
    *,
    out_dtype=torch.float32,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    acc_out: Optional[torch.Tensor] = None,
    plan=None,
) -> torch.Tensor:
    """Kernel #3: kernel #2 with ``decode_a(x)`` on the left."""
    m, kb, nnz_a = x_vals.shape
    if kb != w_vals.shape[0] or nnz_a != cfg_a.nnz or cfg_a.bz != cfg_w.bz:
        raise ValueError(
            f"x_vals {tuple(x_vals.shape)} ({cfg_a}) does not match "
            f"w_vals {tuple(w_vals.shape)} ({cfg_w})"
        )
    native.cuda_arg(x_vals, "x_vals", torch.int8)
    native.cuda_arg(x_mask, "x_mask", torch.uint8, (m, kb))
    return _launch(AW_INT8, AW_INT8_TC, x_vals, x_mask, m, nnz_a, x_scale, w_vals, w_mask,
                   w_scale, cfg_w, out_dtype, bias, act, acc_out, plan)


# ------------------------------------------------------------ native wire

_FLOAT = {torch.float32: 0, torch.bfloat16: 1}


def _native_entries():
    global _native_fns
    if _native_fns is None:
        lib = native.load("dbb_matmul_native")
        fn = lib.dbb_matmul_native
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _native_fns = fn
    return _native_fns


STEP_BLOCKS = 8  # 8-blocks of one k-step of the tc body (64 k): splits are whole steps
PLAN_BLOCKS = 264  # blocks a launch aims for: two per SM of the H100 (three fit)


def native_plan(k: int, n: int):
    """``(bn, kb_per_split, n_split)`` of a native-wire launch over K = ``k``
    (8-blocks of 8) and N = ``n``: the output tile's width (128 where the
    wider tiles alone with up to 8 splits fill the card, else 64) and as
    many K splits (at most ``MAX_SPLIT``, the cluster size) of whole
    ``STEP_BLOCKS`` k-steps as fill ``PLAN_BLOCKS`` blocks with one row
    tile.  A function of (K, N) only — never of M — so every row sums in
    the same order."""
    kb = k // 8
    steps = -(-kb // STEP_BLOCKS)
    bn = 128 if -(-n // 128) * min(MAX_SPLIT, steps) >= PLAN_BLOCKS else 64
    want = min(MAX_SPLIT, steps, -(-PLAN_BLOCKS // -(-n // bn)))
    per = -(-steps // want)
    return bn, per * STEP_BLOCKS, -(-steps // per)


def tc_body_error(dtype, kb: int, n: int, nnz: int = 4, ptrs=(), mask_ptrs=()) -> Optional[str]:
    """Why the tc body does not take a native-wire call (``dtype`` of its
    values, ``kb`` 8-blocks, ``n`` columns, ``nnz`` values an 8-block of
    either packed operand at most, the 16-byte operands' and the 8-byte
    masks' device pointers), or None when it does."""
    if dtype != torch.bfloat16:
        return f"values are {dtype}, not bfloat16"
    if n % 8:
        return f"N={n} is not a multiple of 8"
    if kb % STEP_BLOCKS:
        return f"K={8 * kb} is not a multiple of {8 * STEP_BLOCKS}"
    if nnz > 4:
        return f"NNZ={nnz} exceeds 4 values an 8-block"
    if any(p % 16 for p in ptrs) or any(p % 8 for p in mask_ptrs):
        return "an operand is not aligned for cp.async"
    return None


# ------------------------------------------------------------ launch plans
#
# The tc bodies' plans, resolved per launch by ``autotune.get_plan`` under
# these rules: a swept winner from its cache, else today's rule.


def heuristic_plan(kind: str, m: int, k: int, n: int):
    """Today's fixed rule: ``int8_plan(m, k, n)`` for the int8 kinds,
    ``native_plan(k, n)`` for the native ones."""
    if kind in autotune.INT8_KINDS:
        return int8_plan(m, k, n)
    if kind in autotune.NATIVE_KINDS:
        return native_plan(k, n)
    raise ValueError(f"unknown matmul kind {kind!r}; one of {autotune.KINDS}")


def _tiles_and_step(kind: str):
    if kind in autotune.INT8_KINDS:
        return (16, 64), INT8_STEP_BLOCKS
    if kind in autotune.NATIVE_KINDS:
        return (64, 128), STEP_BLOCKS
    raise ValueError(f"unknown matmul kind {kind!r}; one of {autotune.KINDS}")


def plan_error(kind: str, plan, k: int, n: int) -> Optional[str]:
    """Why ``plan`` is not a legal tc-body plan of ``kind`` over K = ``k``
    and N = ``n``, or None when it is: the tile size (``bm`` 16 or 64 rows
    for int8, ``bn`` 64 or 128 columns native), splits of whole k-steps, at
    most ``MAX_SPLIT`` of them (a cluster), covering K with none empty."""
    tiles, step = _tiles_and_step(kind)
    if (not isinstance(plan, (tuple, list)) or len(plan) != 3
            or any(type(v) is not int for v in plan)):
        return f"{plan!r} is not three integers"
    tile, per, split = plan
    if tile not in tiles:
        return f"{'bm' if tiles[0] == 16 else 'bn'}={tile} is not {tiles[0]} or {tiles[1]}"
    kb = k // 8
    if per < step or per % step:
        return f"a split of {per} 8-blocks is not whole k-steps of {step}"
    if not 1 <= split <= MAX_SPLIT:
        return f"{split} splits: 1 to {MAX_SPLIT} (a cluster)"
    if per * split < kb:
        return f"{split} splits of {per} 8-blocks do not cover K={k}"
    if per * (split - 1) >= kb:
        return f"{split} splits of {per} 8-blocks leave one empty at K={k}"
    return None


def candidate_plans(kind: str, m: int, k: int, n: int):
    """Every legal plan of a sweep: the heuristic's first, then both tile
    sizes with each split count from 1 to ``MAX_SPLIT`` as whole k-steps
    (distinct plans only)."""
    tiles, step = _tiles_and_step(kind)
    steps = -(-(k // 8) // step)
    out = [heuristic_plan(kind, m, k, n)]
    for tile in tiles:
        for want in range(1, min(MAX_SPLIT, steps) + 1):
            per = -(-steps // want)
            plan = (tile, per * step, -(-steps // per))
            if plan not in out:
                out.append(plan)
    return [p for p in out if plan_error(kind, p, k, n) is None]


PLAN_RULES = autotune.PlanRules(heuristic_plan, plan_error, candidate_plans)


def _check_plan(plan, kind, body_err, k, n):
    """An explicit ``plan`` is the tc body's and must be legal for it
    (:func:`plan_error`); the generic bodies take none."""
    if plan is None:
        return
    if body_err is not None:
        raise ValueError(f"plan {plan!r} given, but the call runs the generic body: {body_err}")
    err = plan_error(kind, plan, k, n)
    if err is not None:
        raise ValueError(f"illegal {kind} plan {plan!r}: {err}")


def _launch_native(counter, tc_counter, x, x_mask, m, nnz_a, w_vals, w_mask, cfg_w, out_dtype,
                   bias, act, plan):
    if cfg_w.bz != 8:
        raise ValueError(f"the CUDA kernel decodes 8-blocks, got bz={cfg_w.bz}")
    if act not in _ACT:
        raise ValueError(f"unknown activation {act!r}; one of {tuple(_ACT)}")
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if w_vals.dtype not in _FLOAT:
        raise ValueError(f"w_vals: native wire values must be float32 or bfloat16, got {w_vals.dtype}")
    if x.dtype != w_vals.dtype:
        raise ValueError(f"x ({x.dtype}) and w_vals ({w_vals.dtype}) must share a dtype")
    kb, nnz_w, n = w_vals.shape
    if nnz_w != cfg_w.nnz or not 1 <= nnz_w <= 8:
        raise ValueError(f"w_vals holds {nnz_w} slots, cfg says {cfg_w.nnz}")
    dev = w_vals.device
    p_wv = native.cuda_arg(w_vals, "w_vals", w_vals.dtype)
    p_wm = native.cuda_arg(w_mask, "w_mask", torch.uint8, (kb, n))
    if p_wv % 16 or p_wm % 4:
        raise ValueError("w_vals must be 16-byte and w_mask 4-byte aligned")
    p_b = None
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
        p_b = native.cuda_arg(bias, "bias", torch.float32, (n,))
    p_x = x.data_ptr()
    p_xm = None if x_mask is None else x_mask.data_ptr()
    body_err = tc_body_error(w_vals.dtype, kb, n, max(nnz_a, nnz_w), (p_x, p_wv),
                             (p_wm,) if p_xm is None else (p_wm, p_xm))
    tc = body_err is None
    kind = "w" if x_mask is None else "aw"
    _check_plan(plan, kind, body_err, 8 * kb, n)
    if tc:
        bn, kb_per_split, n_split = plan or autotune.get_plan(kind, m, 8 * kb, n, nnz_w, 8,
                                                              PLAN_RULES)
    else:
        bn, kb_per_split, n_split = native_plan(8 * kb, n)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    part = (torch.empty((n_split, m, n), dtype=torch.float32, device=dev)
            if n_split > 1 and not tc else None)
    err = _native_entries()(
        p_x, p_xm, p_wv, p_wm, p_b, out.data_ptr(), None if part is None else part.data_ptr(),
        m, n, kb, nnz_a, nnz_w, kb_per_split, n_split, int(x_mask is not None),
        _FLOAT[w_vals.dtype], _OUT[out_dtype], _ACT[act], int(tc), bn, native.stream_ptr(dev),
    )
    native.check(err, "dbb_matmul_native")
    counter.launches += 1
    if tc:
        tc_counter.launches += 1
    return out


def dbb_matmul_cuda(
    x: torch.Tensor,  # [M, K] bf16 or f32
    w_vals: torch.Tensor,  # [K//8, NNZ, N], x's dtype
    w_mask: torch.Tensor,  # [K//8, N] uint8
    cfg: dbb.DBBConfig,
    *,
    out_dtype=None,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    plan=None,  # the tc body's (bn, kb_per_split, n_split); None: autotune.get_plan
) -> torch.Tensor:
    """Kernel #1: ``act(x @ decode_w(w) + bias)``, f32 accumulator."""
    if x.ndim != 2 or x.shape[1] != w_vals.shape[0] * cfg.bz:
        raise ValueError(f"x {tuple(x.shape)} does not match w_vals {tuple(w_vals.shape)}")
    if native.cuda_arg(x, "x", x.dtype) % 16:
        x = x.clone()  # the kernel reads 8 values at a time
    return _launch_native(NATIVE, NATIVE_TC, x, None, x.shape[0], 1, w_vals, w_mask, cfg,
                          out_dtype or x.dtype, bias, act, plan)


def dbb_matmul_aw_cuda(
    x_vals: torch.Tensor,  # [M, K//8, NNZa], the model dtype
    x_mask: torch.Tensor,  # [M, K//8] uint8
    w_vals: torch.Tensor,
    w_mask: torch.Tensor,
    cfg_a: dbb.DBBConfig,
    cfg_w: dbb.DBBConfig,
    *,
    out_dtype=None,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    plan=None,
) -> torch.Tensor:
    """Kernel #4: kernel #1 with ``decode_a(x)`` on the left."""
    m, kb, nnz_a = x_vals.shape
    if (kb != w_vals.shape[0] or nnz_a != cfg_a.nnz or cfg_a.bz != cfg_w.bz
            or not 1 <= nnz_a <= 8):
        raise ValueError(
            f"x_vals {tuple(x_vals.shape)} ({cfg_a}) does not match "
            f"w_vals {tuple(w_vals.shape)} ({cfg_w})"
        )
    native.cuda_arg(x_vals, "x_vals", x_vals.dtype)
    native.cuda_arg(x_mask, "x_mask", torch.uint8, (m, kb))
    return _launch_native(AW_NATIVE, AW_NATIVE_TC, x_vals, x_mask, m, nnz_a, w_vals, w_mask,
                          cfg_w, out_dtype or x_vals.dtype, bias, act, plan)
