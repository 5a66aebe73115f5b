"""The port's gelu (``epilogue.apply_act(y, "gelu")``) against the
reference's ``jax.nn.gelu(approximate=True)``, bit for bit.

The reference's gelu is ``x * (0.5 * (1 + tanh(c * (x + 0.044715 *
x**3))))``, each operation rounded to the input's dtype, its constants
rounded to it first.  The port repeats it op by op; ``F.gelu(approximate=
"tanh")`` rounds once, and in bf16 it differs from the reference on
17% of these values (on 44% of unit-normal ones), which the cases below
also show, so that they can see the fault they guard.

The reference runs op by op (each operation XLA's own computation at its
default flags), its program as written.  In bf16 its jitted program
gives the same bits.  In f32 it does not: XLA's CPU compiler fuses the
chain and contracts ``x + k * x**3`` into a fused multiply-add (one f32
ulp apart on about 1% of these values), and compiled without LLVM's
optimizations its ``tanh`` is another approximation.  In f32 the port's
``tanh`` is XLA's optimized one (``epilogue._tanh_f32``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import epilogue

torch.set_num_threads(1)

# 2^18 values: normal draws at eight magnitudes, from where tanh is its
# argument (|x| < 4e-4) to where it is +-1, and the edges themselves
SCALES = (1e-5, 1e-3, 0.05, 1.0, 3.0, 8.0, 30.0, 300.0)
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16, np.int16),
          "float32": (torch.float32, jnp.float32, np.float32, np.int32)}


def _values():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=1 << 15) * s for s in SCALES]).astype(np.float32)
    x[:8] = [0.0, -0.0, 4e-4, -4e-4, 7.99881172180175781, -8.0, 1e30, -1e30]
    return x


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gelu_equals_reference_bit_for_bit(dtype):
    tdt, jdt, ndt, bits = DTYPES[dtype]
    x = _values().astype(ndt)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jdt), approximate=True)).view(bits)
    xt = torch.from_numpy(x.view(bits).copy()).view(tdt)
    got = epilogue.apply_act(xt, "gelu")
    assert got.dtype == tdt and got.shape == xt.shape
    as_bits = got.view(torch.from_numpy(want[:1]).dtype).numpy()
    np.testing.assert_array_equal(as_bits, want)
    n_once = int((F.gelu(xt, approximate="tanh") != got).sum())
    assert n_once > (len(x) // 10 if dtype == "bfloat16" else 100), n_once
    if dtype == "bfloat16":
        jitted = jax.jit(lambda v: jax.nn.gelu(v, approximate=True))(jnp.asarray(x, jdt))
        np.testing.assert_array_equal(as_bits, np.asarray(jitted).view(bits))
