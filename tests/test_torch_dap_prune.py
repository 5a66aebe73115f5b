"""Port parity, DAP (kernel #5): ``ops.dap_prune`` on CPU tensors (the
plain version ``kernels/ref.py::dap_prune_ref``) against the reference's
oracle ``repro.kernels.ref.dap_prune_ref`` and its Pallas kernel in
interpret mode, on the same numpy inputs in float32 and bfloat16.

Tolerances: none.  DAP is selection, so the oracle's pruned tensor and
mask are matched bit for bit (a selected ``-0.0`` stays ``-0.0``, a block
holding a NaN keeps nothing).  The Pallas kernel writes ``+0.0`` where
the oracle keeps a selected ``-0.0``, so it is matched by value.  The
CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import dbb as tdbb
from repro_torch.core.dap import DAPSpec, apply_dap
from repro_torch.kernels import dap_prune, ops

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, m=6, k=64, special=True):
    """Normal draws, with the hard cases in the first rows: a block with a
    NaN, blocks of ties (small integers, zeros of both signs), +-inf, and
    a block with fewer non-zeros than any NNZ keeps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    if special:
        x[0, 3] = np.nan
        x[0, 8:16] = np.nan
        x[1] = rng.integers(-2, 3, size=k)  # ties everywhere
        x[2, :8] = [0.0, -0.0, 0.0, 1.5, -0.0, 0.0, 0.0, -0.0]
        x[2, 8:16] = -0.0
        x[3, :8] = [np.inf, -np.inf, 1.0, -np.inf, 2.0, np.inf, 0.5, -1.0]
        x[4, 16:24] = [3.0, -3.0, 3.0, -3.0, 1.0, 3.0, 0.0, -3.0]
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return t.contiguous().view(view).numpy()


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    xj = jnp.asarray(x, jdt)
    return xj, tensor_from_numpy(np.asarray(xj))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz", [1, 2, 3, 4, 5])
def test_dap_prune_plain_bit_exact_vs_oracle(dtype, nnz):
    xj, xt = _both(_inputs(nnz), dtype)
    ops.reset_counters()
    got_p, got_m = ops.dap_prune(xt, nnz, 8)
    c = ops.counters()["dap_prune"]
    assert (c.launches, c.plain) == (0, 1)
    want_p, want_m = jref.dap_prune_ref(xj, nnz, 8)
    want_p = tensor_from_numpy(np.asarray(want_p))
    assert got_p.dtype == xt.dtype and got_m.dtype == torch.uint8
    np.testing.assert_array_equal(_bits(got_p), _bits(want_p))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # the hard cases did what the oracle's semantics say
    assert not got_p[0, :16].any() and got_m[0, :2].tolist() == [0, 0]  # NaN blocks
    assert torch.isinf(got_p[3, :8]).sum() == min(nnz, 4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nnz", [1, 3, 5])
def test_dap_prune_plain_vs_pallas_interpret(dtype, nnz):
    """The reference's Pallas kernel (interpret mode, two grid tiles per
    axis) writes +0.0 for a selected -0.0: equal by value, masks equal."""
    xj, xt = _both(_inputs(10 + nnz, m=16, k=128), dtype)
    want_p, want_m = jops.dap_prune(xj, nnz, 8, impl="interpret", tm=8, tk=64)
    got_p, got_m = ops.dap_prune(xt, nnz, 8)
    np.testing.assert_array_equal(got_p.float().numpy(), np.asarray(want_p.astype(jnp.float32)))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_dap_prune_any_leading_shape():
    """``[..., K]`` is pruned as 2-D rows, shapes restored."""
    x = _inputs(20, m=12, k=32, special=False)
    xt = torch.from_numpy(x).reshape(2, 3, 2, 32)
    got_p, got_m = ops.dap_prune(xt, 4, 8)
    assert tuple(got_p.shape) == (2, 3, 2, 32) and tuple(got_m.shape) == (2, 3, 2, 4)
    want_p, want_m = jref.dap_prune_ref(jnp.asarray(x), 4, 8)
    np.testing.assert_array_equal(got_p.reshape(12, 32).numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_m.reshape(12, 4).numpy(), np.asarray(want_m))


def test_apply_dap_goes_through_dap_prune():
    """``apply_dap`` is ``ops.dap_prune``'s pruned tensor: on a CPU tensor
    one plain call is counted and no launch; dense specs pass through."""
    xt = torch.from_numpy(_inputs(30))
    ops.reset_counters()
    got = apply_dap(xt, DAPSpec(4, 8))
    assert (dap_prune.DAP_PRUNE.launches, dap_prune.DAP_PRUNE.plain) == (0, 1)
    np.testing.assert_array_equal(_bits(got), _bits(tdbb.prune(xt, tdbb.DBBConfig(4, 8))))
    assert apply_dap(xt, DAPSpec(8, 8)) is xt and apply_dap(xt, None) is xt
    assert dap_prune.DAP_PRUNE.plain == 1


def test_dap_prune_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        dap_prune.dap_prune_cuda(torch.zeros(4, 16), 4)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        dap_prune.dap_prune_cuda(torch.zeros(4, 16, dtype=torch.float16), 4)
    with pytest.raises(ValueError, match="K % 8"):
        dap_prune.dap_prune_cuda(torch.zeros(4, 12), 4)
    assert dap_prune.DAP_PRUNE.launches == 0
