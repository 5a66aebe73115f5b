"""Dynamic activation pruning on Hopper (``csrc/dap_prune.cu``).

Kernel #5 replaces the reference's ``dap_prune_pallas`` and, with it,
the plain producers of the packed wire formats (``ops.dap_pack``,
``ops.dap_pack_int8``): per block of 8 features keep the ``nnz`` largest
magnitudes (ties to the lower position, a block holding a NaN keeps
nothing), then write one of four forms, each in one launch and bit for
bit its plain version in ``kernels/ref.py``:

* ``dap_prune_cuda``: the pruned dense tensor and its uint8 bitmask
  (``dap_prune_ref``);
* ``dap_pack_cuda``: the native wire, rank-ordered values and bitmask
  (``dap_pack_ref``);
* ``dap_prune_int8_cuda``: the pruned tensor quantized to int8 with one
  scale a row (``dap_prune_int8_ref``);
* ``dap_pack_int8_cuda``: the int8 wire with one scale a row
  (``dap_pack_int8_ref``).

The wrappers take CUDA tensors only; ``kernels/ops.py`` dispatches CPU
tensors to the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native

DAP_PRUNE = native.Counter()  # kernel #5, dense form
DAP_PACK = native.Counter()  # kernel #5, native packed form
DAP_PRUNE_INT8 = native.Counter()  # kernel #5, int8 dense form
DAP_PACK_INT8 = native.Counter()  # kernel #5, int8 packed form

_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
# csrc/dap_prune.cu: the most threads a row block takes; a thread takes
# more than one 8-block only past them
ROW_MAX_THREADS = 512
MAX_CLUSTER = 8  # blocks a row at most (the portable cluster size)
SMS = 132  # the H100's SMs, which the plan spreads a call's rows over
_fns = {}


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(native.load("dap_prune"), name)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "dap_prune":
            fn.argtypes = [P, P, P, L, I, I, I, P]
        else:
            fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, I, P]
        fn.restype = I
        _fns[name] = fn
    return fn


def row_plan(m: int, k: int):
    """``(cluster, threads, per, per_block)`` of a per-row launch over
    ``m`` rows of ``k`` features: ``cluster`` blocks a row (one
    thread-block cluster), each taking ``per_block`` of the row's ``k //
    8`` 8-blocks with ``threads`` threads of up to ``per`` (1, 2, 4 or 8)
    8-blocks each.  The rule: at least the blocks that hold the row (a
    block takes at most ``ROW_MAX_THREADS`` x 8 8-blocks), then as many as
    the SMs hold for ``m`` rows, a power of 2 up to 8, none with fewer
    than 32 8-blocks (one a thread of a warp).  A row's bits do not
    depend on the plan (its amax is an integer max), so it may depend on
    M."""
    nb = k // 8
    cluster = 1
    while cluster < MAX_CLUSTER and -(-nb // cluster) > ROW_MAX_THREADS * 8:
        cluster *= 2
    while cluster < MAX_CLUSTER and 2 * cluster * m <= SMS and nb >= 64 * cluster:
        cluster *= 2
    per_block = -(-nb // cluster)
    per = 1
    while per < 8 and -(-per_block // per) > ROW_MAX_THREADS:
        per *= 2
    threads = 32 * -(-per_block // (32 * per))
    if threads > ROW_MAX_THREADS:
        raise ValueError(
            f"K={k}: {per_block} 8-blocks a block exceed {ROW_MAX_THREADS} threads x 8 "
            f"in a cluster of {MAX_CLUSTER}"
        )
    return cluster, threads, per, per_block


def _check(x: torch.Tensor, nnz: int, bz: int) -> torch.Tensor:
    if bz != 8:
        raise ValueError(f"the CUDA kernel prunes 8-blocks, got bz={bz}")
    if not 1 <= nnz <= bz:
        raise ValueError(f"nnz must be in [1, {bz}], got {nnz}")
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"x: expected bfloat16 or float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] % bz:
        raise ValueError(f"x: expected [M, K] with K % {bz} == 0, got {tuple(x.shape)}")
    native.cuda_arg(x, "x", x.dtype)
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel loads 16-byte vectors: a fresh, aligned copy
    return x


def _block_form(x: torch.Tensor, nnz: int, bz: int, pack: bool, counter: native.Counter):
    x = _check(x, nnz, bz)
    m, k = x.shape
    if pack:
        out = torch.empty((m, k // bz, nnz), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty_like(x)
    mask = torch.empty((m, k // bz), dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out, mask
    err = _entry("dap_prune")(x.data_ptr(), out.data_ptr(), mask.data_ptr(), m * k // bz,
                              nnz, _ELEM_BYTES[x.dtype], int(pack), native.stream_ptr(x.device))
    native.check(err, "dap_prune")
    counter.launches += 1
    return out, mask


def _row_form(x: torch.Tensor, nnz: int, bz: int, pack: bool, counter: native.Counter):
    x = _check(x, nnz, bz)
    m, k = x.shape
    nb = k // bz
    q = torch.empty((m, nb, nnz) if pack else (m, k), dtype=torch.int8, device=x.device)
    mask = torch.empty((m, nb), dtype=torch.uint8, device=x.device) if pack else None
    scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return q, mask, scale
    cluster, threads, per, per_block = row_plan(m, k)
    err = _entry("dap_prune_rows")(
        x.data_ptr(), q.data_ptr(), mask.data_ptr() if pack else None, scale.data_ptr(), m, nb,
        nnz, _ELEM_BYTES[x.dtype], int(pack), cluster, threads, per, per_block,
        native.stream_ptr(x.device),
    )
    native.check(err, "dap_prune_rows")
    counter.launches += 1
    return q, mask, scale


def dap_prune_cuda(x: torch.Tensor, nnz: int, bz: int = 8):
    """Kernel #5, dense form, on ``x [M, K]`` (bf16 or f32, ``K % 8 ==
    0``) -> ``(pruned [M, K] in x's dtype, mask [M, K//8] uint8)``."""
    return _block_form(x, nnz, bz, False, DAP_PRUNE)


def dap_pack_cuda(x: torch.Tensor, nnz: int, bz: int = 8):
    """Kernel #5, packed form -> ``(vals [M, K//8, nnz] in x's dtype, mask
    [M, K//8] uint8)``: the native wire, no zero of either sign kept."""
    return _block_form(x, nnz, bz, True, DAP_PACK)


def dap_prune_int8_cuda(x: torch.Tensor, nnz: int, bz: int = 8):
    """Kernel #5, int8 dense form -> ``(q [M, K] int8, scale [M] f32)``:
    the pruned tensor quantized with one scale a row."""
    q, _, scale = _row_form(x, nnz, bz, False, DAP_PRUNE_INT8)
    return q, scale


def dap_pack_int8_cuda(x: torch.Tensor, nnz: int, bz: int = 8):
    """Kernel #5, int8 packed form -> ``(q [M, K//8, nnz] int8, mask [M,
    K//8] uint8, scale [M] f32)``: the int8 wire with one scale a row."""
    return _row_form(x, nnz, bz, True, DAP_PACK_INT8)
