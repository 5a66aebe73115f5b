"""Dynamic activation pruning on Hopper (``csrc/dap_prune.cu``).

Kernel #5 (``dap_prune_cuda``) replaces the reference's
``dap_prune_pallas``: per block of 8 features, keep the ``nnz`` largest
magnitudes (ties to the lower position, a block holding a NaN keeps
nothing) and return the pruned dense tensor with its uint8 bitmask, bit
for bit the plain version ``kernels/ref.py::dap_prune_ref``.  It takes
CUDA tensors only; ``kernels/ops.py`` dispatches CPU tensors to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native

DAP_PRUNE = native.Counter()  # kernel #5

_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = native.load("dap_prune").dap_prune
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, ctypes.c_longlong, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


def dap_prune_cuda(x: torch.Tensor, nnz: int, bz: int = 8):
    """Kernel #5 on ``x [M, K]`` (bf16 or f32, ``K % 8 == 0``) ->
    ``(pruned [M, K] in x's dtype, mask [M, K//8] uint8)``."""
    if bz != 8:
        raise ValueError(f"the CUDA kernel prunes 8-blocks, got bz={bz}")
    if not 1 <= nnz <= bz:
        raise ValueError(f"nnz must be in [1, {bz}], got {nnz}")
    if x.dtype not in _ELEM_BYTES:
        raise ValueError(f"x: expected bfloat16 or float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] % bz:
        raise ValueError(f"x: expected [M, K] with K % {bz} == 0, got {tuple(x.shape)}")
    if x.is_contiguous() and x.data_ptr() % 16:
        x = x.clone()  # the kernel loads 16-byte vectors: a fresh, aligned copy
    m, k = x.shape
    p_x = native.cuda_arg(x, "x", x.dtype)
    out = torch.empty_like(x)
    mask = torch.empty((m, k // bz), dtype=torch.uint8, device=x.device)
    err = _entry()(p_x, out.data_ptr(), mask.data_ptr(), m * k // bz, nnz,
                   _ELEM_BYTES[x.dtype], native.stream_ptr(x.device))
    native.check(err, "dap_prune")
    DAP_PRUNE.launches += 1
    return out, mask
